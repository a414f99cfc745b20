// Fused multi-head self-attention forward for short sequences (K1), Hopper.
//
// Replaces clip_lite_tpu/ops/attention.py::_attention_fwd_kernel, the
// Pallas kernel that BERT runs in every layer.  It computes the same
// function, not the same blocks:
//
//   per (batch item b, head h):
//     s    = q_h k_h^T / sqrt(HD) + bias[b, :]    (fp32, key bias)
//     p    = softmax(s) in fp32, then rounded to the compute type
//     ctx  = p v_h, accumulated in fp32, rounded to the output type
//   written straight into out[b, :, h*HD:(h+1)*HD] of a (B, S, H) tensor,
//   reading q/k/v from the packed (B, S, 3H) projection, so no
//   (B, NH, S, HD) tensor ever exists in device memory.
//
// What bounds it on an H100: bytes.  At the flagship shape (B=128, S=30,
// NH=12, HD=64, bf16) one launch must read 17.7 MB of qkv and write
// 5.9 MB of context, about 7 us at 3.35 TB/s, against 0.35 GFLOP of
// products (well under a microsecond on the tensor cores).  So the design
// reads every input byte once and writes every output byte once: one
// thread block per (b, h) stages its q, k and v rows (S x HD each) in
// shared memory, and nothing but the context leaves the block.  The
// products run on the CUDA cores in fp32; at S <= 256 they are small and
// a tensor-core (wgmma / mma.sync) version is later work.
//
// Layout of the work inside a block: each warp owns query rows
// i = warp, warp + kWarps, ...; for its row it keeps q in registers, lane
// j scores key j (k is stored with a row stride of HD + 1 floats so that
// the 32 lanes reading one column of k hit 32 different banks), the
// softmax max and sum are warp shuffles, and for the context each lane
// owns HD / 32 output columns.  Padded key columns (j >= S) never enter
// the softmax and no padded query row is written.
//
// C interface (loaded with ctypes): attention_fwd(...) returns the
// cudaError_t of the launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: q (S*HD), k (S*(HD+1)), v (S*HD), bias (S), and one row of
// probabilities per warp (kWarps*S), all fp32.
__host__ __device__ inline size_t smem_bytes(int S, int HD) {
  return sizeof(float) *
         ((size_t)S * HD * 2 + (size_t)S * (HD + 1) + S + (size_t)kWarps * S);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     T* __restrict__ out, int S, int NH, float scale) {
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
  for (int s = threadIdx.x; s < S; s += kThreads) bias_s[s] = bias[(size_t)b * S + s];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = p_all + warp * S;
  T* dst = out + (size_t)b * S * H + (size_t)h * HD;

  for (int i = warp; i < S; i += kWarps) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = q_s[i * HD + d];

    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* k = k_s + j * kStride;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(q[d], k[d], acc);
      const float sc = acc * scale + bias_s[j];
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
      // probs.astype(compute dtype) before the context product.
      p[j] = to_float(from_float<T>(p[j] / sum));
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

template <typename T, int HD>
int launch(const void* qkv, const void* bias, void* out, int B, int S, int NH,
           cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T, HD>;
  const size_t smem = smem_bytes(S, HD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  kernel<<<dim3(NH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<T*>(out), S, NH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (qkv and out); bias is always float32.
// qkv (B, S, 3*NH*HD), bias (B, S) and out (B, S, NH*HD) are contiguous.
int attention_fwd(const void* qkv, const void* bias, void* out, int B, int S,
                  int NH, int HD, int dtype, void* stream) {
  if (HD != 64 || B < 1 || B > 65535 || S < 1 || NH < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, 64>(qkv, bias, out, B, S, NH, st);
  if (dtype == 1) return launch<__nv_bfloat16, 64>(qkv, bias, out, B, S, NH, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
