// Fused multi-head self-attention forward for short sequences (K1), Hopper.
//
// Replaces clip_lite_tpu/ops/attention.py::_attention_fwd_kernel, the
// Pallas kernel that BERT and MPNet run in every layer.  It computes the
// same function, not the same blocks:
//
//   per (batch item b, head h):
//     s    = q_h k_h^T / sqrt(HD) + bias          (fp32)
//            bias = bias[b, :] (key bias, BERT) or bias[b, h, :, :] (full
//            per-head bias, MPNet's relative position bias + padding)
//     p    = softmax(s) in fp32
//     p    = keep ? p / (1 - rate) : 0            (dropout, training only)
//     p    = p rounded to the compute type
//     ctx  = p v_h, accumulated in fp32, rounded to the output type
//   written straight into out[b, :, h*HD:(h+1)*HD] of a (B, S, H) tensor,
//   reading q/k/v from the packed (B, S, 3H) projection, so no
//   (B, NH, S, HD) tensor ever exists in device memory.  The keep mask is
//   Philox's, keyed by (seed, b, h, i, j) (attention_common.cuh), so K2
//   regenerates it without storing it.
//
// What bounds it on an H100: bytes.  At the flagship shape (B=128, S=30,
// NH=12, HD=64, bf16) one launch must read 17.7 MB of qkv and write
// 5.9 MB of context, about 7 us at 3.35 TB/s, against 0.35 GFLOP of
// products (well under a microsecond on the tensor cores); dropout adds
// 1.4 M Philox draws of arithmetic and no bytes.  A full bias adds 5.5 MB
// of fp32 reads (8.7 us in all).  So the design reads
// every input byte once and writes every output byte once: one thread
// block per (b, h) stages its q, k and v rows (S x HD each) in shared
// memory, and nothing but the context leaves the block.
//
// Two routes compute that function (attention_route() in
// clip_lite_torch/ops/attention.py picks one by dtype and S):
//   - the CUDA-core route, attention_fwd(): fp32 products, float32 at any
//     S and bf16 at S > 64.  It stays off the tensor cores for float32,
//     which they would read as TF32.
//   - the tensor-core route, attention_fwd_tc(): bf16 at S <= 64, the
//     products on mma.sync (below, after the CUDA-core kernel).
//
// CUDA-core route.  Layout of the work inside a block: each warp owns query rows
// i = warp, warp + kWarps, ...; for its row it keeps q in registers, lane
// j scores key j (k is stored with a row stride of HD + 1 floats so that
// the 32 lanes reading one column of k hit 32 different banks), the
// softmax max and sum are warp shuffles, and for the context each lane
// owns HD / 32 output columns.  Padded key columns (j >= S) never enter
// the softmax and no padded query row is written.
//
// The full bias (template flag kFull) is read straight from device memory
// by the warp that owns row i: lane j reads bias[b, h, i, j], so a warp's
// read is coalesced.  Staging the (S, S) tile would cost 256 KB of shared
// memory at S = 256, more than a block may have; every element is read
// once anyway.
//
// C interface (loaded with ctypes): attention_fwd(...) and
// attention_dropout_mask(...) return the cudaError_t of the launch; 0 is
// success.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// Shared memory: q (S*HD), k (S*(HD+1)), v (S*HD), bias (S), and one row of
// probabilities per warp (kWarps*S), all fp32.
__host__ __device__ inline size_t smem_bytes(int S, int HD) {
  return sizeof(float) *
         ((size_t)S * HD * 2 + (size_t)S * (HD + 1) + S + (size_t)kWarps * S);
}

template <typename T, int HD, bool kFull>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     T* __restrict__ out, int S, int NH, float scale,
                     Dropout drop) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of the warp size");
  constexpr int kStride = HD + 1;
  constexpr int kCols = HD / 32;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + S * HD;
  float* v_s = k_s + S * kStride;
  float* bias_s = v_s + S * HD;
  float* p_all = bias_s + S;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = NH * HD;
  const T* src = qkv + (size_t)b * S * 3 * H + (size_t)h * HD;
  for (int idx = threadIdx.x; idx < S * HD; idx += kThreads) {
    const int s = idx / HD;
    const int d = idx - s * HD;
    const T* row = src + (size_t)s * 3 * H + d;
    q_s[idx] = to_float(row[0]);
    k_s[s * kStride + d] = to_float(row[H]);
    v_s[idx] = to_float(row[2 * H]);
  }
  if (!kFull) {
    for (int s = threadIdx.x; s < S; s += kThreads) bias_s[s] = bias[(size_t)b * S + s];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = p_all + warp * S;
  T* dst = out + (size_t)b * S * H + (size_t)h * HD;

  for (int i = warp; i < S; i += kWarps) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = q_s[i * HD + d];
    // This row's bias: the full bias's row i of head h, or the key bias.
    const float* bias_row =
        kFull ? bias + (((size_t)b * NH + h) * S + i) * S : bias_s;

    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* k = k_s + j * kStride;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(q[d], k[d], acc);
      const float sc = acc * scale + bias_row[j];
      p[j] = sc;
      m = fmaxf(m, sc);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) {
      float pj = p[j] / sum;
      if (drop.active) pj = keep_at(drop, b, h, i, j, NH, S) ? pj * drop.inv_keep : 0.f;
      // probs.astype(compute dtype) before the context product.
      p[j] = round_to<T>(pj);
    }
    __syncwarp();

    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
      const float* v = v_s + j * HD + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(pj, v[c * 32], acc[c]);
    }
    T* o = dst + (size_t)i * H + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c * 32] = from_float<T>(acc[c]);
    __syncwarp();
  }
}

// ---- tensor-core route: bf16, S <= kTcMaxSeq (64) -----------------------
//
// Why: the CUDA-core kernel makes one shared-memory load per fp32 FMA
// (about 10 M warp-wide loads a launch at the flagship shape, some 45 us
// of its 62), while every product here is a bf16 x bf16 product summed in
// fp32 -- exactly what mma.sync ... .f32.bf16.bf16.f32 computes, and what
// the JAX kernel asks of its dot_general (bf16 operands,
// preferred_element_type float32).  The probabilities are rounded to bf16
// before p.v in both.
//
// One block per (b, h), one warp per 16 query rows (S padded to kSp, a
// multiple of 16; at S = 30 two warps).  q, k and v of the head are staged
// once with 16-byte cp.async (each row slice is one 128-byte line), rows
// S..kSp-1 zeroed, row stride 144 bytes so ldmatrix is free of bank
// conflicts.  Each warp computes S = Q K^T for its 16 rows on mma.sync
// (A = q by ldmatrix, B = k rows by ldmatrix), applies scale and bias in
// fp32 on the accumulators, and takes the softmax with shuffles among the
// four lanes that hold a row (tile_softmax); keys j >= S never enter it.
// Dropout calls keep_at() for each element.  P is rounded to bf16 and
// repacked in registers from the accumulator layout into the A operand of
// ctx = P V (mma.cuh's accum_to_a), V read by ldmatrix.trans.  The context
// goes through the warp's own q rows in shared memory and leaves with
// 16-byte stores; padded rows are not written.  wgmma would pad the query
// tile to 64 rows (2-3x at S = 20, 30) and the products are far under the
// byte bound at either rate.
using bf16 = __nv_bfloat16;

// Shared memory: q, k, v (kSp x kRow bf16 each) and the key bias (kSp).
template <int kSp>
constexpr size_t tc_smem_bytes() {
  return 3 * kSp * mma::kRow * sizeof(bf16) + kSp * sizeof(float);
}

template <int kSp, bool kFull>
__global__ void __launch_bounds__(kSp * 2)
attention_fwd_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        bf16* __restrict__ out, int S, int NH, float scale,
                        Dropout drop) {
  using namespace mma;
  constexpr int kNT = kSp / 8;       // 8-key accumulator tiles
  constexpr int kTcThreads = kSp * 2;  // one warp per 16 query rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kSp * kRow;
  bf16* v_s = k_s + kSp * kRow;
  float* key_bias = reinterpret_cast<float*>(v_s + kSp * kRow);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = NH * 64;
  const size_t row3 = (size_t)3 * H;
  const bf16* src = qkv + (size_t)b * S * row3 + (size_t)h * 64;
  const int tid = threadIdx.x;
  stage_rows(q_s, src, row3, S, kSp, tid, kTcThreads);
  stage_rows(k_s, src + H, row3, S, kSp, tid, kTcThreads);
  stage_rows(v_s, src + 2 * H, row3, S, kSp, tid, kTcThreads);
  if (!kFull) {
    for (int j = tid; j < kSp; j += kTcThreads) {
      key_bias[j] = j < S ? bias[(size_t)b * S + j] : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = (tid >> 5) * 16;
  float s[kNT][4] = {};
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows(q_s, kRow, i0, kc * 16, lane));
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, bt_rows(k_s, kRow, np * 16, kc * 16, lane));
      mma_bf16(s[2 * np], a, bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
    }
  }
  const float* bias_bh = kFull ? bias + ((size_t)b * NH + h) * S * S : nullptr;
  tile_softmax<kNT, kFull>(s, bias_bh, key_bias, i0, S, scale, lane);
  if (drop.active) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1);
        const int j = n * 8 + 2 * t + (e & 1);
        if (i < S && j < S) {
          s[n][e] = keep_at(drop, b, h, i, j, NH, S) ? s[n][e] * drop.inv_keep : 0.f;
        }
      }
    }
  }

  float o[8][4] = {};
#pragma unroll
  for (int kc = 0; kc < kSp / 16; ++kc) {
    uint32_t a[4];
    accum_to_a(a, s, kc);  // probs.astype(bf16), in registers
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, b_rows(v_s, kRow, kc * 16, np * 16, lane));
      mma_bf16(o[2 * np], a, bv[0], bv[1]);
      mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
    }
  }
  // The warp's own q rows take its context; then the block writes it out.
  __syncwarp();
  accum_to_tile(q_s, i0, o, lane);
  __syncthreads();
  store_rows(out + (size_t)b * S * H + (size_t)h * 64, H, q_s, S, tid, kTcThreads);
}

__global__ void dropout_mask_kernel(int8_t* __restrict__ keep, int B, int NH,
                                    int S, Dropout drop) {
  const size_t n = (size_t)B * NH * S * S;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx % S);
    const int i = (int)(idx / S % S);
    const int h = (int)(idx / ((size_t)S * S) % NH);
    const int b = (int)(idx / ((size_t)S * S * NH));
    keep[idx] = keep_at(drop, b, h, i, j, NH, S) ? 1 : 0;
  }
}

template <typename T, int HD, bool kFull>
int launch(const void* qkv, const void* bias, void* out, int B, int S, int NH,
           const Dropout& drop, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T, HD, kFull>;
  const size_t smem = smem_bytes(S, HD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  kernel<<<dim3(NH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<T*>(out), S, NH, scale, drop);
  return (int)cudaGetLastError();
}

template <int kSp, bool kFull>
int launch_tc(const void* qkv, const void* bias, void* out, int B, int S, int NH,
              const Dropout& drop, cudaStream_t stream) {
  // At most 27.9 KB of shared memory (kSp = 64): no opt-in needed.
  attention_fwd_tc_kernel<kSp, kFull><<<dim3(NH, B), kSp * 2, tc_smem_bytes<kSp>(),
                                        stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), S, NH, 1.0f / sqrtf(64.0f), drop);
  return (int)cudaGetLastError();
}

template <bool kFull>
int launch_tc_seq(const void* qkv, const void* bias, void* out, int B, int S, int NH,
                  const Dropout& drop, cudaStream_t stream) {
  switch ((S + 15) / 16) {
    case 1: return launch_tc<16, kFull>(qkv, bias, out, B, S, NH, drop, stream);
    case 2: return launch_tc<32, kFull>(qkv, bias, out, B, S, NH, drop, stream);
    case 3: return launch_tc<48, kFull>(qkv, bias, out, B, S, NH, drop, stream);
    default: return launch_tc<64, kFull>(qkv, bias, out, B, S, NH, drop, stream);
  }
}

bool misaligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (qkv and out); bias is always float32.
// qkv (B, S, 3*NH*HD), bias and out (B, S, NH*HD) are contiguous; bias is
// (B, S) when full_bias is 0, (B, NH, S, S) when it is not.
// dropout != 0 applies attention dropout: keep (B, NH, S, S) int8 when not
// null, else Philox(seed) against threshold; kept values scale by inv_keep.
int attention_fwd(const void* qkv, const void* bias, const void* keep,
                  void* out, int B, int S, int NH, int HD, int dtype,
                  int full_bias, int dropout, unsigned int threshold,
                  float inv_keep, unsigned long long seed, void* stream) {
  if (HD != 64 || B < 1 || B > 65535 || S < 1 || NH < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return full_bias ? launch<float, 64, true>(qkv, bias, out, B, S, NH, drop, st)
                     : launch<float, 64, false>(qkv, bias, out, B, S, NH, drop, st);
  }
  if (dtype == 1) {
    return full_bias
               ? launch<__nv_bfloat16, 64, true>(qkv, bias, out, B, S, NH, drop, st)
               : launch<__nv_bfloat16, 64, false>(qkv, bias, out, B, S, NH, drop, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: attention_fwd's arguments and function, for
// bf16 (dtype 1) at 1 <= S <= 64 only; any other dtype or S is refused
// with cudaErrorInvalidValue, and qkv or out not 16-byte aligned with
// cudaErrorMisalignedAddress.
int attention_fwd_tc(const void* qkv, const void* bias, const void* keep,
                     void* out, int B, int S, int NH, int HD, int dtype,
                     int full_bias, int dropout, unsigned int threshold,
                     float inv_keep, unsigned long long seed, void* stream) {
  if (HD != 64 || dtype != 1 || B < 1 || B > 65535 || S < 1 || S > kTcMaxSeq ||
      NH < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned16(qkv) || misaligned16(out)) return (int)cudaErrorMisalignedAddress;
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full_bias ? launch_tc_seq<true>(qkv, bias, out, B, S, NH, drop, st)
                   : launch_tc_seq<false>(qkv, bias, out, B, S, NH, drop, st);
}

// Writes the Philox keep mask that K1 and K2 use for (seed, threshold)
// into keep (B, NH, S, S) int8, 1 = kept.
int attention_dropout_mask(void* keep, int B, int NH, int S,
                           unsigned int threshold, unsigned long long seed,
                           void* stream) {
  if (B < 1 || NH < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop{nullptr, seed, threshold, 1.0f, 1};
  const size_t n = (size_t)B * NH * S * S;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 65536
                               ? (n + threads - 1) / threads
                               : 65536);
  dropout_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(keep), B, NH, S, drop);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
