// crop_resize_flip_u8: crop, bilinear resize and horizontal flip of decoded
// images into (B, S, S, 3) uint8 tiles, every image of a batch in one
// launch.
//
// Not a TPU kernel: the counterpart of the host C++ `sample_crop` of the
// JAX package's native core (native/clrec_core.cpp:163-198), which runs
// after libjpeg's decode on the host.  Here the decoded images lie in one
// device arena (nvJPEG's output, decode_crop.cu) and each image's
// parameters (arena offset, height, width, flip, block, normalized crop
// box) come from a small array; a failed decode (height 0) gives a zero
// tile.
//
// nvJPEG decodes at full resolution only.  Where the JAX core decodes at a
// DCT-domain scale of 1/2, 1/4 or 1/8, the image is sampled here as the
// full one averaged over blocks of that denominator, each block's integer
// sum rounded (native.py's box_average): the scale in the pixel domain.
// Against the JAX core's DCT scale this leaves about half a level on a
// textured 640 x 640 photo where sampling the full image would leave six
// (tests/test_torch_native.py).
//
// The arithmetic is `sample_crop` as the JAX core's library runs it (its
// build contracts five products into fused multiply-adds, which its
// disassembly shows): fp32, every operation an explicit round-to-nearest
// intrinsic so that nvcc contracts nothing else, so the tiles equal the JAX
// core's bit for bit on the same decoded pixels.
//
// Bound: bytes.  A thread makes one output pixel (3 bytes) from four source
// pixels; the output is written once (19.3 MB at B = 128, S = 224) and the
// crop regions are read about once (neighbouring threads share source
// rows through L1/L2).  A first version, correct and simple: one thread a
// pixel, byte stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// One image's parameters; 40 bytes, the layout of native.py's _PARAMS.
struct CropParams {
  long long offset;  // byte offset of the image in the arena
  int height, width; // 0 x 0: a failed decode
  int flip;
  int denom;         // 1, 2, 4 or 8: sample the image averaged over blocks
  float box[4];      // normalized (y0, x0, y1, x1); y0 < 0: the whole image
};

constexpr int kCropThreads = 256;

// The source position of output index o along one axis: clamped to
// [0, extent - 1], its floor, the next index (clamped) and the weight.
struct Tap {
  int i0, i1;
  float w;
};

__device__ __forceinline__ Tap crop_tap(int o, float start, float step,
                                        int extent) {
  float f = __fsub_rn(__fmaf_rn(__fadd_rn((float)o, 0.5f), step, start), 0.5f);
  if (f < 0.f) f = 0.f;
  if (f > (float)(extent - 1)) f = (float)(extent - 1);
  Tap t;
  t.i0 = (int)f;
  t.i1 = t.i0 + 1 < extent ? t.i0 + 1 : t.i0;
  t.w = __fsub_rn(f, (float)t.i0);
  return t;
}

// Channel c of pixel (y, x) of the image averaged over d x d blocks (d = 1:
// the image itself); `row` is the full image's row in bytes.
__device__ __forceinline__ float texel(const uint8_t* src, size_t row, int y,
                                       int x, int c, int d, int height,
                                       int width) {
  if (d == 1) return (float)src[y * row + x * 3 + c];
  const int ye = min((y + 1) * d, height), xe = min((x + 1) * d, width);
  int sum = 0;
  for (int yy = y * d; yy < ye; ++yy)
    for (int xx = x * d; xx < xe; ++xx) sum += src[yy * row + xx * 3 + c];
  const int count = (ye - y * d) * (xe - x * d);
  return (float)((sum + count / 2) / count);
}

__global__ void __launch_bounds__(kCropThreads)
crop_resize_flip_kernel(const uint8_t* __restrict__ arena,
                        const CropParams* __restrict__ params, int size,
                        uint8_t* __restrict__ out) {
  const int img = blockIdx.y;
  const int pix = blockIdx.x * kCropThreads + threadIdx.x;
  if (pix >= size * size) return;
  const CropParams p = params[img];
  uint8_t* dst = out + ((size_t)img * size * size + pix) * 3;
  if (p.height <= 0 || p.width <= 0) {
    dst[0] = dst[1] = dst[2] = 0;
    return;
  }
  const int d = p.denom > 1 ? p.denom : 1;
  const int hs = (p.height + d - 1) / d, ws = (p.width + d - 1) / d;
  const float h = (float)hs, w = (float)ws, s = (float)size;
  float y0 = 0.f, x0 = 0.f, sy, sx;
  if (p.box[0] < 0.f) {
    sy = __fdiv_rn(h, s);
    sx = __fdiv_rn(w, s);
  } else {
    y0 = __fmul_rn(p.box[0], h);
    x0 = __fmul_rn(p.box[1], w);
    sy = __fdiv_rn(__fmaf_rn(p.box[2], h, -y0), s);
    sx = __fdiv_rn(__fmaf_rn(p.box[3], w, -x0), s);
  }
  const int oy = pix / size, ox = pix - oy * size;
  const Tap ty = crop_tap(oy, y0, sy, hs);
  const Tap tx = crop_tap(p.flip ? size - 1 - ox : ox, x0, sx, ws);
  const size_t row = (size_t)p.width * 3;
  const uint8_t* src = arena + p.offset;
  const float wx1 = __fsub_rn(1.f, tx.w), wy1 = __fsub_rn(1.f, ty.w);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = texel(src, row, ty.i0, tx.i0, c, d, p.height, p.width);
    const float v01 = texel(src, row, ty.i0, tx.i1, c, d, p.height, p.width);
    const float v10 = texel(src, row, ty.i1, tx.i0, c, d, p.height, p.width);
    const float v11 = texel(src, row, ty.i1, tx.i1, c, d, p.height, p.width);
    const float top = __fmaf_rn(v00, wx1, __fmul_rn(v01, tx.w));
    const float bot = __fmaf_rn(v10, wx1, __fmul_rn(v11, tx.w));
    const float v = __fmaf_rn(top, wy1, __fmul_rn(ty.w, bot));
    dst[c] = (uint8_t)(int)__fadd_rn(v, 0.5f);
  }
}

// Tiles of `n` images from `arena` into `out` (n, size, size, 3) uint8, on
// `stream`.  `params` is a device array of n CropParams.  Returns the
// launch's CUDA error (0: launched).
extern "C" int crop_resize_flip_u8(const void* arena, const void* params,
                                   int n, int size, void* out,
                                   void* stream) {
  if (n <= 0 || size <= 0 || n > 65535) return cudaErrorInvalidValue;
  const dim3 grid((size * size + kCropThreads - 1) / kCropThreads, n);
  crop_resize_flip_kernel<<<grid, kCropThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)arena, (const CropParams*)params, size, (uint8_t*)out);
  return (int)cudaGetLastError();
}
