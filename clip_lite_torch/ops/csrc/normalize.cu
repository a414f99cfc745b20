// ImageNet normalize of an NHWC image batch (K3), Hopper: the standalone
// pass and the fused augment-and-normalize pass of the uint8 path.
//
// Replaces clip_lite_tpu/ops/pallas_kernels.py::_normalize_kernel, the
// Pallas kernel behind normalize_u8, and on the uint8 training path also
// the flip and colour jitter that XLA fuses into the JAX step around it
// (clip_lite_tpu/ops/image_ops.py:44-145).  It computes the same
// functions, not the same blocks.
//
// 1. normalize_u8: out[i] = (float(x[i]) - m[c]) * s[c], c = i mod 3,
//    over a contiguous (B, H, W, 3) uint8 or float32 tensor, written as a
//    contiguous float32 or bfloat16 (round to nearest even) tensor.
//    m[c] = 255 * mean_c and s[c] = 1 / (255 * std_c) arrive as fp32
//    arguments, the TPU kernel's Python-double constants rounded once.
//    The subtract and the multiply are separate roundings (__fsub_rn,
//    __fmul_rn), so no FMA contraction can make the kernel differ from
//    its plain twin.
//
//    What bounds it on an H100: bytes.  At (128, 224, 224, 3), 19.3 M
//    values, one launch reads the input once and writes the output once:
//    uint8 -> fp32 96.3 MB (28.8 us at 3.35 TB/s), uint8 -> bf16 57.8 MB,
//    fp32 -> fp32 154.1 MB, fp32 -> bf16 115.6 MB.  So every warp load
//    and store touches consecutive addresses: lane l of a chunk takes the
//    4 consecutive values of unit u (a u32 or a float4 in, a float4 or 8
//    bytes of bf16 out), and one warp instruction writes 512 (or 256)
//    contiguous bytes, whole 32-byte sectors.  Value 4u + j has channel
//    (u + j) mod 3, since 4u mod 3 = u mod 3.  Each thread keeps kUnroll
//    units in flight.  A pointer that is not aligned for those widths (a
//    view into a larger tensor) takes the scalar loop, as does the tail of
//    fewer than four values.
//
// 2. augment_normalize_u8: per image b, the flip (read pixel W-1-w of the
//    row where flip[b]), then where apply[b] the colour jitter in [0, 255]
//    (brightness x*fb; contrast (x - mu)*fc + mu, mu the mean of x*fb over
//    the image; saturation against the 0.299/0.587/0.114 gray; the clamp;
//    hue by the exact HSV round trip), then the normalize, from contiguous
//    (B, H, W, 3) uint8 into contiguous fp32.  Every operation mirrors the
//    plain composition (ops/image_ops.py) one rounding at a time, with the
//    division by 255 and by 6 as eager PyTorch computes it on the card
//    (a product with the fp32 reciprocal), so that only mu's order of
//    summation differs; given the twin's mu it agrees bit for bit.
//
//    The contrast mean is a reduction over the whole image.  One thread
//    block cluster of kCluster blocks takes one image, each block a band
//    of rows.  A block copies its band of the source into shared memory
//    with 16-byte loads, summing the bytes as they pass (exact, in
//    integers); the partial sums are exchanged through distributed shared
//    memory between two cluster.sync()s; then the block computes its
//    pixels from the copy (the flip stays inside a row).  One launch: the
//    batch is read from device memory once and the output written once,
//    96.3 MB at 224 px (28.8 us), beside the fp32 instructions of a
//    jittered pixel (the HSV round trip with its three divisions), which
//    chip_smoke.py counts from this file's SASS (augment_pixel_probe).  A
//    band too wide for shared memory is read twice from device memory
//    instead.  Each warp computes spans of kSpan pixels into its own
//    shared memory and stores them with consecutive float4s, whole sectors
//    again, with no block barrier.
//
// The outputs are contiguous NHWC tensors whose NCHW permute the ResNet
// stem reads as channels_last, so no layout copy follows.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch; 0 is success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                   // units in flight per thread
constexpr int kChunk = kThreads * kUnroll;   // units per block
constexpr long long kMaxBlocks = 4096;       // the scalar loop's grid
constexpr int kCluster = 8;                  // blocks per image (portable)
constexpr int kPixPerThread = 4;             // pixels a lane takes a span
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 32 * kPixPerThread;    // pixels a warp stages at once

// The twin's Python-float constants as torch rounds them to fp32.
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kInv6 = (float)(1.0 / 6.0);
constexpr float kEps = (float)1e-12;
constexpr float kGrayR = (float)0.299;
constexpr float kGrayG = (float)0.587;
constexpr float kGrayB = (float)0.114;

struct Affine {
  float m[3];
  float s[3];
};

__device__ __forceinline__ float pick(const float (&v)[3], int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ float to_float(uint8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(float x) { return x; }

// Unit u's 4 input values as loaded (a u32 of bytes or a float4), kept
// in that form until they are computed on, to hold few registers.
__device__ __forceinline__ uint32_t load_unit(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float4 load_unit(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(uint32_t x, float v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (float)((x >> (8 * j)) & 0xFFu);
}
__device__ __forceinline__ void unpack(const float4& x, float v[4]) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  // The lower address's value in the low half.
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 u;
  u.x = bf16_pair(v[0], v[1]);
  u.y = bf16_pair(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float normalize_one(float x, float m, float s) {
  return __fmul_rn(__fsub_rn(x, m), s);
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const In* __restrict__ x, Out* __restrict__ out,
                 long long n, Affine a, int vectorized) {
  if (vectorized) {
    const long long units = n / 4;
    const long long first = (long long)blockIdx.x * kChunk + threadIdx.x;
    decltype(load_unit(x)) raw[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = first + (long long)k * kThreads;
      if (u < units) raw[k] = load_unit(x + 4 * u);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = first + (long long)k * kThreads;
      if (u < units) {
        float v[4];
        unpack(raw[k], v);
        // Channels of values 0..3: r, r + 1, r + 2, r (mod 3).
        const int r = (int)(u % 3);
        const int r1 = r == 2 ? 0 : r + 1;
        const int r2 = r == 0 ? 2 : r - 1;
        const float m0 = pick(a.m, r), m1 = pick(a.m, r1), m2 = pick(a.m, r2);
        const float s0 = pick(a.s, r), s1 = pick(a.s, r1), s2 = pick(a.s, r2);
        v[0] = normalize_one(v[0], m0, s0);
        v[1] = normalize_one(v[1], m1, s1);
        v[2] = normalize_one(v[2], m2, s2);
        v[3] = normalize_one(v[3], m0, s0);
        store4(out + 4 * u, v);
      }
    }
    const long long i = 4 * units + threadIdx.x;
    if (blockIdx.x == 0 && i < n) {
      const int c = (int)(i % 3);
      store_one(out + i, normalize_one(to_float(x[i]), pick(a.m, c),
                                       pick(a.s, c)));
    }
    return;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = (int)(i % 3);
    store_one(out + i, normalize_one(to_float(x[i]), pick(a.m, c),
                                     pick(a.s, c)));
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename In, typename Out>
int launch(const void* x, void* out, long long n, const Affine& a,
           cudaStream_t stream) {
  // Unit u's load is 4 bytes (uint8) or 16 (fp32) at 4u values, its
  // store 16 bytes (fp32) or 8 (bf16).
  const bool vectorized = aligned(x, sizeof(In) == 1 ? 4 : 16) &&
                          aligned(out, sizeof(Out) == 2 ? 8 : 16);
  long long blocks;
  if (vectorized) {
    blocks = (n / 4 + kChunk - 1) / kChunk;
    if (blocks < 1) blocks = 1;  // fewer than four values: the tail alone
  } else {
    blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  }
  normalize_kernel<In, Out><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), n, a,
      vectorized ? 1 : 0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The fused augment-and-normalize pass.

// One image's jitter factors, read from the (B,) draw tensors.
struct Jitter {
  float fb, fc, mean, fs, one_minus_fs, shift;
};

// The (B,) draw tensors on the card; mean may be null (the kernel sums).
struct Draws {
  const uint8_t* flip;
  const uint8_t* apply;
  const float* brightness;
  const float* contrast;
  const float* saturation;
  const float* hue;
  const float* mean;
};

struct FusedShared {
  float stage[kWarps][3 * kSpan];
  unsigned long long warp_sums[kWarps];
  unsigned long long block_sum;
  float mean;
};
// The staged rows start after FusedShared, 16-byte aligned; a block may
// hold 227 KB of dynamic shared memory.
constexpr int kSliceOffset = (sizeof(FusedShared) + 15) / 16 * 16;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float clamp255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

// torch.remainder(x, 1.0): fmod, then + 1 where the remainder is negative.
// fmod(x, 1) is x - trunc(x), exactly (the fraction is representable),
// with x's sign on a zero; the general fmodf loop is not needed.
__device__ __forceinline__ float remainder1(float x) {
  const float m = copysignf(__fsub_rn(x, truncf(x)), x);
  return m < 0.0f ? __fadd_rn(m, 1.0f) : m;
}

// random_color_jitter on one pixel x (brightness, contrast, saturation,
// clamp, then random_hue's HSV round trip), in [0, 255] in and out.
__device__ __forceinline__ void jitter_pixel(float x[3], const Jitter& j) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float y = __fmul_rn(x[c], j.fb);
    x[c] = __fadd_rn(__fmul_rn(__fsub_rn(y, j.mean), j.fc), j.mean);
  }
  const float gray = __fadd_rn(
      __fadd_rn(__fmul_rn(x[0], kGrayR), __fmul_rn(x[1], kGrayG)),
      __fmul_rn(x[2], kGrayB));
  const float gray_term = __fmul_rn(gray, j.one_minus_fs);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x[c] = clamp255(__fadd_rn(__fmul_rn(x[c], j.fs), gray_term));
  }
  // _rgb_to_hsv on x / 255.
  const float r = __fmul_rn(x[0], kInv255);
  const float g = __fmul_rn(x[1], kInv255);
  const float b = __fmul_rn(x[2], kInv255);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float chroma = __fsub_rn(maxc, minc);
  const float s = maxc > 0.0f ? __fdiv_rn(chroma, fmaxf(maxc, kEps)) : 0.0f;
  const float safe_c = fmaxf(chroma, kEps);
  // h = bc - gc where maxc == r, else (2 + rc) - bc where maxc == g, else
  // (4 + gc) - rc, with xc = (maxc - x) / safe_c: two divisions of the
  // three (0 + bc is bc exactly).
  const bool at_r = maxc == r, at_g = !at_r && maxc == g;
  const float base = at_r ? 0.0f : (at_g ? 2.0f : 4.0f);
  const float first = at_r ? b : (at_g ? r : g);
  const float second = at_r ? g : (at_g ? b : r);
  float h = __fsub_rn(
      __fadd_rn(base, __fdiv_rn(__fsub_rn(maxc, first), safe_c)),
      __fdiv_rn(__fsub_rn(maxc, second), safe_c));
  h = chroma > 0.0f ? remainder1(__fmul_rn(h, kInv6)) : 0.0f;
  // The shift, then _hsv_to_rgb.
  h = remainder1(__fadd_rn(h, j.shift));
  const float h6 = __fmul_rn(h, 6.0f);
  const float fi = floorf(h6);
  const float f = __fsub_rn(h6, fi);
  const float p = __fmul_rn(v, __fsub_rn(1.0f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(f, s)));
  const float t = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(__fsub_rn(1.0f, f), s)));
  // h lies in [0, 1], so fi in 0..6, and torch.remainder(fi, 6) maps only
  // 6 to 0.
  int i = (int)fi;
  if (i >= 6) i -= 6;
  // sel(a0..a5): a_i for i in 0..4, else a5.
  const float rr = i == 0 ? v : i == 1 ? q : i == 2 ? p : i == 3 ? p : i == 4 ? t : v;
  const float gg = i == 0 ? t : i == 1 ? v : i == 2 ? v : i == 3 ? q : i == 4 ? p : p;
  const float bb = i == 0 ? p : i == 1 ? p : i == 2 ? t : i == 3 ? v : i == 4 ? v : q;
  x[0] = clamp255(__fmul_rn(rr, 255.0f));
  x[1] = clamp255(__fmul_rn(gg, 255.0f));
  x[2] = clamp255(__fmul_rn(bb, 255.0f));
}

__device__ __forceinline__ uint32_t byte_sum(uint32_t w) {
  return (w & 0xFFu) + ((w >> 8) & 0xFFu) + ((w >> 16) & 0xFFu) + (w >> 24);
}

// This thread's share of the sum of the len bytes at p, each also copied
// to q where q is not null (q at p's address mod 16): 16-byte loads and
// stores over the aligned middle, single bytes at the two ends.
__device__ __forceinline__ uint32_t copy_and_sum(const uint8_t* p,
                                                 uint8_t* q, int len) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(p) % 16);
  const int head = min(len, mis ? 16 - mis : 0);
  const int vecs = (len - head) / 16;
  uint32_t sum = 0;
  for (int k = threadIdx.x; k < head; k += kThreads) {
    sum += p[k];
    if (q) q[k] = p[k];
  }
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int k = threadIdx.x; k < vecs; k += kThreads) {
    const uint4 w = v[k];
    sum += byte_sum(w.x) + byte_sum(w.y) + byte_sum(w.z) + byte_sum(w.w);
    if (q) reinterpret_cast<uint4*>(q + head)[k] = w;
  }
  for (int k = head + 16 * vecs + threadIdx.x; k < len; k += kThreads) {
    sum += p[k];
    if (q) q[k] = p[k];
  }
  return sum;
}

// A warp's staged span of n floats to g: consecutive float4s over the
// 16-byte aligned middle, single floats at the two ends.
__device__ __forceinline__ void store_span(const float* stage, float* g,
                                           int n, int lane) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(g) / 4) % 4);
  const int head = min(n, mis ? 4 - mis : 0);
  const int vecs = (n - head) / 4;
  if (lane < head) g[lane] = stage[lane];
  float4* gv = reinterpret_cast<float4*>(g + head);
  if (head == 0) {
    const float4* sv = reinterpret_cast<const float4*>(stage);
    for (int k = lane; k < vecs; k += 32) gv[k] = sv[k];
  } else {
    for (int k = lane; k < vecs; k += 32) {
      const float* s = stage + head + 4 * k;
      gv[k] = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  for (int k = head + 4 * vecs + lane; k < n; k += 32) g[k] = stage[k];
}

// The pixels [p0, p1) of one image (rows from r0 on, read at rows_in:
// the shared copy or device memory) into dst, by warps: each warp takes
// spans of kSpan pixels in turn, lane l the pixels l, l + 32, ... of a
// span (their source bytes first, then the arithmetic), stages them in
// its own shared memory and stores them with whole sectors.  No block
// barrier: a warp waits only for its own lanes.
__device__ __forceinline__ void augment_band(
    const uint8_t* rows_in, int r0, int p0, int p1, int width, bool flip,
    bool jitter, const Jitter& j, const Affine& a, float* stage,
    float* dst) {
  const int lane = threadIdx.x % 32;
  for (int q0 = p0 + (int)(threadIdx.x / 32) * kSpan; q0 < p1;
       q0 += kWarps * kSpan) {
    const int q1 = min(p1, q0 + kSpan);
    // The row and column are stepped, not divided, from pixel to pixel.
    int row = (q0 + lane) / width;
    int col = q0 + lane - row * width;
    uint8_t px[kPixPerThread][3];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      if (q0 + lane + 32 * k < q1) {
        const uint8_t* s =
            rows_in + 3 * ((row - r0) * width + (flip ? width - 1 - col : col));
        px[k][0] = s[0];
        px[k][1] = s[1];
        px[k][2] = s[2];
      }
      col += 32;
      while (col >= width) {
        col -= width;
        ++row;
      }
    }
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const int q = q0 + lane + 32 * k;
      if (q < q1) {
        float v[3] = {(float)px[k][0], (float)px[k][1], (float)px[k][2]};
        if (jitter) jitter_pixel(v, j);
        float* st = stage + 3 * (q - q0);
#pragma unroll
        for (int c = 0; c < 3; ++c) st[c] = normalize_one(v[c], a.m[c], a.s[c]);
      }
    }
    __syncwarp();
    store_span(stage, dst + 3 * (long long)q0, 3 * (q1 - q0), lane);
    __syncwarp();
  }
}

// Grid: kCluster blocks (one cluster) per image; block rank k of image b
// takes the rows [k * rows, (k + 1) * rows) of the image.  Its dynamic
// shared memory holds FusedShared and, where staged, a copy of those rows
// of the source (the flip stays inside a row), made while they are
// summed, so that the pixels are read from device memory once.
__global__ void __launch_bounds__(kThreads)
augment_normalize_kernel(const uint8_t* __restrict__ x,
                         float* __restrict__ out, int height, int width,
                         Draws d, Affine a, int flip_on, int jitter_on,
                         int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FusedShared& sh = *reinterpret_cast<FusedShared*>(smem_raw);
  const int img = blockIdx.x / kCluster;
  const int rank = blockIdx.x % kCluster;
  const int hw = height * width;
  const int rows = (height + kCluster - 1) / kCluster;
  const int r0 = min(height, rank * rows);
  const int p0 = r0 * width;
  const int p1 = min(height, r0 + rows) * width;
  // The block's rows of the source, in device memory and (where staged)
  // in shared memory at the same address mod 16.
  const uint8_t* rows_src = x + ((long long)img * hw + p0) * 3;
  uint8_t* copy = smem_raw + kSliceOffset +
                  reinterpret_cast<uintptr_t>(rows_src) % 16;
  float* dst = out + (long long)img * hw * 3;

  const bool flip = flip_on && d.flip[img];
  const bool jitter = jitter_on && d.apply[img];
  Jitter j{};
  if (jitter) {
    j.fb = d.brightness[img];
    j.fc = d.contrast[img];
    j.fs = d.saturation[img];
    j.one_minus_fs = __fsub_rn(1.0f, j.fs);
    j.shift = d.hue[img];
  }
  const bool sum = jitter && d.mean == nullptr;
  if (staged || sum) {
    unsigned long long s =
        copy_and_sum(rows_src, staged ? copy : nullptr, 3 * (p1 - p0));
    if (sum) {
      // mu = fb * (sum of the image's bytes) / (3 H W): the thread's
      // partial, the warp's, the block's, then the cluster's through
      // distributed shared memory.
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (threadIdx.x % 32 == 0) sh.warp_sums[threadIdx.x / 32] = s;
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned long long block = 0;
        for (int w = 0; w < kWarps; ++w) block += sh.warp_sums[w];
        sh.block_sum = block;
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every block's partial is written
      if (threadIdx.x == 0) {
        unsigned long long total = 0;
        for (int r = 0; r < kCluster; ++r) {
          total += *cluster.map_shared_rank(&sh.block_sum, r);
        }
        sh.mean = (float)((double)total * (double)j.fb / (3.0 * (double)hw));
      }
      cluster.sync();  // every partial is read; the copy and sh.mean are
                       // visible
    } else {
      __syncthreads();  // the copy is visible
    }
  }
  if (jitter) j.mean = d.mean != nullptr ? d.mean[img] : sh.mean;
  // Two inlined copies of the band loop, so that the staged one reads
  // with shared-memory loads.
  float* stage = sh.stage[threadIdx.x / 32];
  if (staged) {
    augment_band(copy, r0, p0, p1, width, flip, jitter, j, a, stage, dst);
  } else {
    augment_band(rows_src, r0, p0, p1, width, flip, jitter, j, a, stage,
                 dst);
  }
}

}  // namespace

extern "C" {

// Never launched: one jittered pixel from memory to memory, so that the
// SASS of this kernel counts the fused pass's instructions per pixel
// (chip_smoke.py reads it with cuobjdump).  factors: fb, fc, mu, fs,
// 1 - fs, the hue shift, then m[0..2], s[0..2].
__global__ void augment_pixel_probe(const uint8_t* __restrict__ px,
                                    const float* __restrict__ factors,
                                    float* __restrict__ out) {
  const Jitter j{factors[0], factors[1], factors[2],
                 factors[3], factors[4], factors[5]};
  float v[3] = {(float)px[0], (float)px[1], (float)px[2]};
  jitter_pixel(v, j);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[c] = normalize_one(v[c], factors[6 + c], factors[9 + c]);
  }
}

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

// x: contiguous (b, h, w, 3) uint8; out: contiguous (b, h, w, 3) fp32.
// flip and apply are (b,) bytes (0 or 1), the factors and mean (b,) fp32;
// flip is read only where flip_on, the rest only where jitter_on; mean
// may be null, and then each image's mean is summed in the kernel.
int augment_normalize_u8(const void* x, void* out, int b, int h, int w,
                         const void* flip, const void* apply,
                         const void* brightness, const void* contrast,
                         const void* saturation, const void* hue,
                         const void* mean, int flip_on, int jitter_on,
                         float m0, float m1, float m2, float s0, float s1,
                         float s2, void* stream) {
  if (b < 1 || h < 1 || w < 1 || (long long)h * w * 3 >= (1LL << 31) ||
      (long long)b * kCluster >= (1LL << 31) || (flip_on && !flip) ||
      (jitter_on && !(apply && brightness && contrast && saturation && hue)))
    return (int)cudaErrorInvalidValue;
  const Draws d{static_cast<const uint8_t*>(flip),
                static_cast<const uint8_t*>(apply),
                static_cast<const float*>(brightness),
                static_cast<const float*>(contrast),
                static_cast<const float*>(saturation),
                static_cast<const float*>(hue),
                static_cast<const float*>(mean)};
  const Affine a{{m0, m1, m2}, {s0, s1, s2}};
  // Stage each block's rows in shared memory where they fit (16 bytes of
  // slack for the alignment), else read them twice from device memory.
  const long long rows_bytes = 3LL * w * ((h + kCluster - 1) / kCluster);
  const int staged = kSliceOffset + rows_bytes + 16 <= kMaxSmem;
  const int smem = kSliceOffset + (staged ? (int)rows_bytes + 16 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        augment_normalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(b * kCluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, augment_normalize_kernel, static_cast<const uint8_t*>(x),
      static_cast<float*>(out), h, w, d, a, flip_on, jitter_on, staged);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
