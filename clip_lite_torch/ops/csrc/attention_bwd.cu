// Fused multi-head self-attention backward for short sequences (K2), Hopper.
//
// Replaces clip_lite_tpu/ops/attention.py::_attention_bwd_kernel (the
// recompute backward behind _fused_bwd), for a (B, S) key bias and for a
// full (B, NH, S, S) per-head bias.  Nothing of the forward is saved but
// its inputs: per (batch item b, head h) the kernel recomputes the
// probabilities and the dropout mask (the same Philox bits K1 drew,
// attention_common.cuh), then
//
//     p_d  = keep ? p / (1 - rate) : 0,  rounded to the compute type
//     dv   = p_d^T g                        (fp32 accumulation)
//     dp   = keep ? (g v^T) / (1 - rate) : 0    (fp32)
//     ds   = p * (dp - sum_j dp * p)            (fp32)
//     ds'  = ds / sqrt(HD), rounded to the compute type
//     dq   = ds' k,  dk = ds'^T q               (fp32 accumulation)
//
// each rounded once to the compute type and written into its third of the
// packed (B, S, 3H) dqkv.  g arrives in the compute type, as the JAX
// kernel casts it.  With a full bias (template flag kFull; MPNet's
// relative position bias + padding) the kernel also writes
//
//     dbias[b, h, i, j] = ds_ij                 (fp32, before 1/sqrt(HD))
//
// as the JAX kernel does (attention.py:167-173): the bias is added to the
// scaled scores, so its gradient is ds unscaled and unrounded.
//
// What bounds it on an H100: bytes.  At the flagship shape (B=128, S=30,
// NH=12, HD=64, bf16) one launch must read 17.7 MB of qkv and 5.9 MB of
// g and write 17.7 MB of dqkv: about 41.3 MB, 12.3 us at 3.35 TB/s,
// against five products of about 0.9 GFLOP (under a microsecond on the
// tensor cores).  A full bias adds 5.5 MB of reads and 5.5 MB of dbias
// writes (52.4 MB, 15.6 us).
//
// Design: one block per (b, h), as K1, in two passes, so that no
// accumulator is shared between warps and nothing needs atomics.
//   Pass 1, by query rows: k and v staged in shared memory; warp w owns
//     rows i = w, w + kWarps, ...; lane j recomputes s_ij and dp_ij, the
//     warp reduces the softmax statistics (max m_i, sum l_i) and
//     D_i = sum_j dp_ij p_ij, and writes dq_i.  m_i, l_i, D_i stay in
//     shared memory.
//   Pass 2, by key columns: q and g staged in the same shared memory;
//     warp w owns columns j; lane i recomputes p_ij from (m_i, l_i) with
//     the same arithmetic as pass 1, and ds_ij from D_i, and the warp
//     writes dk_j and dv_j.
// Each pass stages two S x HD fp32 matrices (row stride HD + 1 against
// bank conflicts): 133 KB at S = 256, inside the 227 KB a block may have,
// where staging q, k, v and g at once would need 266 KB.  qkv and g are
// read twice from device memory (the second read mostly from L2); a
// tensor-core version with one read is later work.  A key column j >= S
// never enters the softmax: rows and columns run to S exactly.
//
// The full bias is read from device memory where it is needed, not staged
// (the (S, S) tile would take 256 KB at S = 256): in pass 1 lane j of the
// warp on row i reads bias[b, h, i, j] (coalesced), and the same warp
// writes dbias[b, h, i, j] once, so no element is written twice and
// nothing needs atomics; in pass 2 lane i of the warp on column j reads
// bias[b, h, i, j] (a strided read, mostly from L2 after pass 1).  Both
// passes compute the score with the same fp32 expression
// (acc * scale + bias), so p is the same in both and dk, dv agree with dq.
//
// C interface (loaded with ctypes): attention_bwd(...) returns the
// cudaError_t of the launch; 0 is success.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// Shared memory, fp32: two staged matrices (2 * S * (HD+1)), bias and the
// three row statistics (4 * S), and per warp two HD rows and two S rows.
__host__ __device__ inline size_t smem_bytes(int S, int HD) {
  return sizeof(float) * ((size_t)2 * S * (HD + 1) + (size_t)4 * S +
                          (size_t)kWarps * (2 * HD + 2 * S));
}

template <typename T, int HD, bool kFull>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dqkv,
                     float* __restrict__ dbias, int S, int NH, float scale,
                     Dropout drop) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of the warp size");
  constexpr int kStride = HD + 1;
  constexpr int kCols = HD / 32;
  extern __shared__ float smem[];
  float* a_s = smem;                  // pass 1: k; pass 2: q  (S x kStride)
  float* b_s = a_s + S * kStride;     // pass 1: v; pass 2: g  (S x kStride)
  float* bias_s = b_s + S * kStride;  // (S)
  float* row_max = bias_s + S;        // m_i
  float* row_sum = row_max + S;       // l_i
  float* row_dot = row_sum + S;       // D_i
  float* warp_all = row_dot + S;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = NH * HD;
  const size_t row3 = (size_t)3 * H;
  const T* src = qkv + (size_t)b * S * row3 + (size_t)h * HD;  // q_h of row 0
  const T* g_src = g + (size_t)b * S * H + (size_t)h * HD;
  T* dst = dqkv + (size_t)b * S * row3 + (size_t)h * HD;
  // The full bias and its gradient of this (b, h): (S, S), row-major.
  const size_t bh = ((size_t)b * NH + h) * S * S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* x_row = warp_all + warp * (2 * HD + 2 * S);  // (HD)
  float* y_row = x_row + HD;                          // (HD)
  float* p_row = y_row + HD;                          // (S)
  float* t_row = p_row + S;                           // (S)

  for (int idx = threadIdx.x; idx < S * HD; idx += kThreads) {
    const int s = idx / HD;
    const int d = idx - s * HD;
    const T* row = src + (size_t)s * row3 + d;
    a_s[s * kStride + d] = to_float(row[H]);
    b_s[s * kStride + d] = to_float(row[2 * H]);
  }
  if (!kFull) {
    for (int s = threadIdx.x; s < S; s += kThreads) bias_s[s] = bias[(size_t)b * S + s];
  }
  __syncthreads();

  // ---- pass 1: query rows -> dq, and the row statistics ----------------
  for (int i = warp; i < S; i += kWarps) {
    for (int d = lane; d < HD; d += 32) {
      x_row[d] = to_float(src[(size_t)i * row3 + d]);        // q_i
      y_row[d] = to_float(g_src[(size_t)i * H + d]);         // g_i
    }
    __syncwarp();
    const float* bias_row = kFull ? bias + bh + (size_t)i * S : bias_s;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* k = a_s + j * kStride;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(x_row[d], k[d], acc);
      const float sc = acc * scale + bias_row[j];
      p_row[j] = sc;
      m = fmaxf(m, sc);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p_row[j] - m);
      p_row[j] = e;
      l += e;
    }
    l = warp_sum(l);
    float dot = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = p_row[j] / l;
      const float* v = b_s + j * kStride;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(y_row[d], v[d], acc);
      float dp = acc;
      if (drop.active) dp = keep_at(drop, b, h, i, j, NH, S) ? acc * drop.inv_keep : 0.f;
      p_row[j] = p;
      t_row[j] = dp;
      dot += dp * p;
    }
    dot = warp_sum(dot);
    for (int j = lane; j < S; j += 32) {
      const float ds = p_row[j] * (t_row[j] - dot);
      if (kFull) dbias[bh + (size_t)i * S + j] = ds;
      t_row[j] = round_to<T>(ds * scale);
    }
    __syncwarp();
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float ds = t_row[j];
      const float* k = a_s + j * kStride + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(ds, k[c * 32], acc[c]);
    }
    T* dq = dst + (size_t)i * row3 + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[c * 32] = from_float<T>(acc[c]);
    if (lane == 0) {
      row_max[i] = m;
      row_sum[i] = l;
      row_dot[i] = dot;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- pass 2: key columns -> dk, dv ------------------------------------
  for (int idx = threadIdx.x; idx < S * HD; idx += kThreads) {
    const int s = idx / HD;
    const int d = idx - s * HD;
    a_s[s * kStride + d] = to_float(src[(size_t)s * row3 + d]);
    b_s[s * kStride + d] = to_float(g_src[(size_t)s * H + d]);
  }
  __syncthreads();

  for (int j = warp; j < S; j += kWarps) {
    for (int d = lane; d < HD; d += 32) {
      x_row[d] = to_float(src[(size_t)j * row3 + H + d]);      // k_j
      y_row[d] = to_float(src[(size_t)j * row3 + 2 * H + d]);  // v_j
    }
    __syncwarp();
    for (int i = lane; i < S; i += 32) {
      const float* q = a_s + i * kStride;
      const float* gi = b_s + i * kStride;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(q[d], x_row[d], acc);
      const float bij = kFull ? bias[bh + (size_t)i * S + j] : bias_s[j];
      const float sc = acc * scale + bij;  // pass 1's expression
      const float p = expf(sc - row_max[i]) / row_sum[i];
      float acc2 = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc2 = fmaf(gi[d], y_row[d], acc2);
      float pd = p, dp = acc2;
      if (drop.active) {
        const bool keep = keep_at(drop, b, h, i, j, NH, S);
        pd = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? acc2 * drop.inv_keep : 0.f;
      }
      p_row[i] = round_to<T>(pd);
      t_row[i] = round_to<T>(p * (dp - row_dot[i]) * scale);
    }
    __syncwarp();
    float dk[kCols], dv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[c] = dv[c] = 0.f;
    for (int i = 0; i < S; ++i) {
      const float ds = t_row[i];
      const float pd = p_row[i];
      const float* q = a_s + i * kStride + lane;
      const float* gi = b_s + i * kStride + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dk[c] = fmaf(ds, q[c * 32], dk[c]);
        dv[c] = fmaf(pd, gi[c * 32], dv[c]);
      }
    }
    T* out = dst + (size_t)j * row3 + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      out[H + c * 32] = from_float<T>(dk[c]);
      out[2 * H + c * 32] = from_float<T>(dv[c]);
    }
    __syncwarp();
  }
}

template <typename T, int HD, bool kFull>
int launch(const void* qkv, const void* bias, const void* g, void* dqkv,
           void* dbias, int B, int S, int NH, const Dropout& drop,
           cudaStream_t stream) {
  auto kernel = attention_bwd_kernel<T, HD, kFull>;
  const size_t smem = smem_bytes(S, HD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  kernel<<<dim3(NH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dqkv),
      static_cast<float*>(dbias), S, NH, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (qkv, g and dqkv); bias is float32.
// qkv (B, S, 3*NH*HD), bias, g (B, S, NH*HD) and dqkv (B, S, 3*NH*HD) are
// contiguous.  full_bias 0: bias is the (B, S) key bias and dbias is
// ignored (null).  full_bias != 0: bias is (B, NH, S, S) and dbias, the
// same shape in float32, receives its gradient; a null dbias is an error.
// The dropout arguments are K1's.
int attention_bwd(const void* qkv, const void* bias, const void* g,
                  const void* keep, void* dqkv, void* dbias, int B, int S,
                  int NH, int HD, int dtype, int full_bias, int dropout,
                  unsigned int threshold, float inv_keep,
                  unsigned long long seed, void* stream) {
  if (HD != 64 || B < 1 || B > 65535 || S < 1 || NH < 1 ||
      (full_bias && dbias == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return full_bias
               ? launch<float, 64, true>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, st)
               : launch<float, 64, false>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, st);
  }
  if (dtype == 1) {
    return full_bias ? launch<__nv_bfloat16, 64, true>(qkv, bias, g, dqkv, dbias, B,
                                                       S, NH, drop, st)
                     : launch<__nv_bfloat16, 64, false>(qkv, bias, g, dqkv, dbias, B,
                                                        S, NH, drop, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
