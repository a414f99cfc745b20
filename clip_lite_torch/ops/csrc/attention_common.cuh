// Shared pieces of the attention kernels K1 (attention_fwd.cu) and K2
// (attention_bwd.cu): type conversions, warp reductions, the dropout keep
// decision, and the softmax of a query tile held as mma accumulators (the
// tensor-core routes).
//
// Dropout: the TPU kernels draw their keep bits from the core's own PRNG,
// seeded per batch block, so forward and backward must pick the same
// block (clip_lite_tpu/ops/attention.py:49-54).  Here the bits come from
// Philox4x32-10 (Salmon et al., SC'11), a counter-based generator: the
// keep decision for element (b, h, i, j) is a pure function of
// (seed, b, h, i, j), whatever block or thread computes it.  K1, K2 and
// the mask entry point all call keep_at() below, so they agree element
// for element.  The threshold follows the JAX kernel: keep iff
// bits >= min(rate * 2^32, 2^32 - 1).  numpy's twin of philox_bits is
// clip_lite_torch/ops/attention.py::philox_keep_mask.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T and back: "astype(compute dtype)".
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Philox4x32-10 on counter (j, i, h, b) and key (seed low, seed high);
// the first output word.
__host__ __device__ inline uint32_t philox_bits(uint64_t seed, uint32_t b,
                                                uint32_t h, uint32_t i,
                                                uint32_t j) {
  uint32_t c0 = j, c1 = i, c2 = h, c3 = b;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
    c0 = n0;
    c2 = n2;
  }
  return c0;
}

// Attention-probability dropout.  ``active`` is 0 in eval mode or at rate
// 0.  ``keep`` is an optional external (B, NH, S, S) int8 mask (the
// parity tests' pattern, clip_lite_tpu/ops/attention.py:255-261); when it
// is null the mask is Philox's.
struct Dropout {
  const int8_t* keep;
  unsigned long long seed;
  uint32_t threshold;
  float inv_keep;
  int active;
};

__device__ __forceinline__ bool keep_at(const Dropout& d, int b, int h, int i,
                                        int j, int NH, int S) {
  if (d.keep) return d.keep[(((size_t)b * NH + h) * S + i) * S + j] != 0;
  return philox_bits(d.seed, b, h, i, j) >= d.threshold;
}

// The tensor-core routes take bf16 at S <= kTcMaxSeq: a block stages its
// (b, h) slices whole, S padded to a multiple of 16, one warp per 16 rows.
constexpr int kTcMaxSeq = 64;

// The key-tiled routes (K1's in both types, K2's): a block of four warps
// owns one (b, h) and 64 rows, a warp 16 of them, and streams the other
// side of the product through shared memory in tiles, so nothing in a
// block grows with S but the count of tiles.  One cap for all of them:
// 1024, the longest length the card tests hold them at, past BERT's 512
// positions, MPNet's 514 and CLIP's ViT-L/14-336 vision tower's 577.
constexpr int kTiledMaxSeq = 1024;
constexpr int kTiledWarps = 4;
constexpr int kTiledThreads = 32 * kTiledWarps;
constexpr int kTiledRows = 16 * kTiledWarps;  // rows a block

// The softmax of each row of a warp's accumulator tiles of scores in
// place (keys out of the softmax hold -inf): the row max and sum over the
// four lanes that hold a row.  kFastMath: __expf and one reciprocal a row
// in place of expf and a division per element, each within a few ulp
// (fp32's bars are 1e-5) and far cheaper at CLIP's text shape (PERF.md
// section 6, the 3xTF32 route's ablation).
template <int kNT, bool kFastMath = false>
__device__ __forceinline__ void tile_softmax_rows(float (&s)[kNT][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = s[n][e] - mx[e >> 1];
      const float x = kFastMath ? __expf(d) : expf(d);  // exp(-inf) = 0
      s[n][e] = x;
      l[e >> 1] += x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (kFastMath) {
    const float r[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= r[e >> 1];
    }
  } else {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] /= l[e >> 1];
    }
  }
}

// Scores of a warp's 16-row query tile, rows i0 + g and i0 + g + 8, as kNT
// mma accumulator tiles of 8 keys (mma.cuh's C layout) -> probabilities in
// place, fp32: s * scale + bias (the full bias's rows from bias_bh, the
// (S, S) block of this (b, h); else the key bias from key_bias), keys
// j >= S out of the softmax, the row max and sum over the four lanes that
// hold a row.  Padded rows (i >= S) see bias 0 and stay finite.
template <int kNT, bool kFull>
__device__ __forceinline__ void tile_softmax(float (&s)[kNT][4], const float* bias_bh,
                                             const float* key_bias, int i0, int S,
                                             float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1);
      const int j = n * 8 + 2 * t + (e & 1);
      float v = -INFINITY;
      if (j < S) {
        const float bij =
            kFull ? (i < S ? bias_bh[(size_t)i * S + j] : 0.f) : key_bias[j];
        v = s[n][e] * scale + bij;
      }
      s[n][e] = v;
    }
  }
  tile_softmax_rows<kNT>(s);
}

// Dropout on a warp's probabilities held as kNT accumulator tiles (rows
// i0 + g, i0 + g + 8; keys j0 + 8n ..): kept ones scaled by inv_keep, the
// rest 0; padded rows and keys (i or j >= S) untouched.
template <int kNT>
__device__ __forceinline__ void tile_dropout(float (&s)[kNT][4], const Dropout& drop,
                                             int b, int h, int i0, int S, int NH,
                                             int lane, int j0 = 0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1);
      const int j = j0 + n * 8 + 2 * t + (e & 1);
      if (i < S && j < S) {
        s[n][e] = keep_at(drop, b, h, i, j, NH, S) ? s[n][e] * drop.inv_keep : 0.f;
      }
    }
  }
}

}  // namespace attn
