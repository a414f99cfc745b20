// ImageNet normalize of an NHWC image batch (K3), Hopper.
//
// Replaces clip_lite_tpu/ops/pallas_kernels.py::_normalize_kernel, the
// Pallas kernel behind normalize_u8.  It computes the same function, not
// the same blocks:
//
//   out[i] = (float(x[i]) - m[c]) * s[c],   c = i mod 3
//
// over a contiguous (B, H, W, 3) uint8 or float32 tensor, written as a
// contiguous (B, H, W, 3) float32 or bfloat16 tensor (rounded to nearest
// even).  m[c] = 255 * mean_c and s[c] = 1 / (255 * std_c) arrive as fp32
// arguments, the TPU kernel's Python-double constants rounded once.  The
// TPU kernel views the batch as (B*H, W*3) and takes the channel as lane
// mod 3; rows hold W*3 values, so that is the flat index mod 3 here.  The
// subtract and the multiply are separate roundings (__fsub_rn, __fmul_rn),
// so no FMA contraction can make the kernel differ from its plain twin.
//
// What bounds it on an H100: bytes.  At the flagship image batch
// (128, 224, 224, 3), 19.3 M elements, one launch must read the input once
// and write the output once: uint8 -> fp32 96.3 MB (28.8 us at
// 3.35 TB/s), uint8 -> bf16 57.8 MB (17.3 us), fp32 -> fp32 154.1 MB
// (46.0 us), fp32 -> bf16 115.6 MB (34.5 us); two flops an element are
// nothing beside that.  So the design is one grid-stride pass in which a
// thread takes four pixels (12 values, the channel pattern fixed at
// compile time) with 4-, 8- or 16-byte loads and stores: 3 x u32 or
// 3 x float4 in, 3 x float4 or 3 x 8 bytes of bf16 out.  The TPU kernel's
// (256, W*3) VMEM blocks have no counterpart.  A pointer that is not
// aligned for those widths (a view into a larger tensor) takes the scalar
// loop, as does the ragged tail of fewer than four pixels.
//
// The output is the contiguous NHWC tensor whose NCHW permute the ResNet
// stem reads as channels_last, so no layout copy follows.
//
// C interface (loaded with ctypes): normalize_u8(...) returns the
// cudaError_t of the launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 12;  // four pixels: channels 0, 1, 2 four times
constexpr long long kMaxBlocks = 4096;

struct Affine {
  float m[3];
  float s[3];
};

__device__ __forceinline__ float to_float(uint8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ void load_group(const uint8_t* p, float v[kGroup]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint32_t x = w[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * k + j] = (float)((x >> (8 * j)) & 0xFFu);
  }
}

__device__ __forceinline__ void load_group(const float* p, float v[kGroup]) {
  const float4* w = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 x = w[k];
    v[4 * k + 0] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
}

__device__ __forceinline__ void store_group(float* p, const float v[kGroup]) {
  float4* w = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
}

__device__ __forceinline__ void store_group(__nv_bfloat16* p,
                                            const float v[kGroup]) {
  uint2* w = reinterpret_cast<uint2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // .x holds the lower address's value.
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[4 * k], v[4 * k + 1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[4 * k + 2], v[4 * k + 3]);
    uint2 u;
    memcpy(&u.x, &lo, sizeof(u.x));
    memcpy(&u.y, &hi, sizeof(u.y));
    w[k] = u;
  }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const In* __restrict__ x, Out* __restrict__ out,
                 long long n, Affine a, int vectorized) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vectorized) {
    const long long groups = n / kGroup;
    for (long long g = tid; g < groups; g += stride) {
      float v[kGroup];
      load_group(x + g * kGroup, v);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        v[k] = __fmul_rn(__fsub_rn(v[k], a.m[k % 3]), a.s[k % 3]);
      }
      store_group(out + g * kGroup, v);
    }
    done = groups * kGroup;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const int c = (int)(i % 3);
    const float m = c == 0 ? a.m[0] : (c == 1 ? a.m[1] : a.m[2]);
    const float s = c == 0 ? a.s[0] : (c == 1 ? a.s[1] : a.s[2]);
    store_one(out + i, __fmul_rn(__fsub_rn(to_float(x[i]), m), s));
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename In, typename Out>
int launch(const void* x, void* out, long long n, const Affine& a,
           cudaStream_t stream) {
  // A group's loads are 3 x 4 bytes (uint8) or 3 x 16 (fp32), its stores
  // 3 x 16 bytes (fp32) or 3 x 8 (bf16); group g starts at 12 g values.
  const bool vectorized = aligned(x, sizeof(In) == 1 ? 4 : 16) &&
                          aligned(out, sizeof(Out) == 2 ? 8 : 16);
  const long long units = vectorized ? (n + kGroup - 1) / kGroup : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  normalize_kernel<In, Out><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), n, a,
      vectorized ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in_dtype: 0 = uint8, 1 = float32; out_dtype: 0 = float32, 1 = bfloat16.
// x and out are contiguous (B, H, W, 3) of n = B*H*W*3 elements.
int normalize_u8(const void* x, void* out, long long n, int in_dtype,
                 int out_dtype, float m0, float m1, float m2, float s0,
                 float s1, float s2, void* stream) {
  if (n < 1 || n % 3 != 0) return (int)cudaErrorInvalidValue;
  const Affine a{{m0, m1, m2}, {s0, s1, s2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<uint8_t, float>(x, out, n, a, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<uint8_t, __nv_bfloat16>(x, out, n, a, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<float, float>(x, out, n, a, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, out, n, a, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
