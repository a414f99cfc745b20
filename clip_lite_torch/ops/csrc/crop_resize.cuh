// crop_resize_flip_u8: crop, bilinear resize and horizontal flip of decoded
// images into (B, S, S, 3) uint8 tiles, every image of a batch in one
// launch.
//
// Not a TPU kernel: the counterpart of the host C++ `sample_crop` of the
// JAX package's native core (native/clrec_core.cpp:163-198), which runs
// after libjpeg's decode on the host.  Here the decoded images lie in one
// device arena (nvJPEG's output, decode_crop.cu) and each image's
// parameters (arena offset, height, width, flip, block, normalized crop
// box) come from the caller's host arrays; a failed decode (height 0)
// gives a zero tile.
//
// nvJPEG decodes at full resolution only.  Where the JAX core decodes at a
// DCT-domain scale of 1/2, 1/4 or 1/8, the image is sampled here as the
// full one averaged over blocks of that denominator d, each block's integer
// sum rounded (native.py's box_average): the scale in the pixel domain.
// Against the JAX core's DCT scale this leaves about half a level on a
// textured 640 x 640 photo where sampling the full image would leave six
// (tests/test_torch_native.py).
//
// The arithmetic is `sample_crop` as the JAX core's library runs it (its
// build contracts five products into fused multiply-adds, which its
// disassembly shows): fp32, every operation an explicit round-to-nearest
// intrinsic so that nvcc contracts nothing else, so the tiles equal the JAX
// core's bit for bit on the same decoded pixels.  Two conversions are
// written as exact float operations that stay off the conversion unit
// (16 a clock on an SM against 128 fp32 lanes; 15 conversions a pixel
// would take it 26 us at B = 128): a level b as the float (2^23 | b) - 2^23,
// its bits built by one byte permute, and the output's truncation as a
// round-down add of 2^23, whose low byte is the level.
//
// Bound: bytes.  Each tile is written once and each crop region read about
// once: 91.6 MB at B = 128, S = 224 with train boxes on COCO-sized images,
// 27 us at 3.35 TB/s.  The design for Hopper:
// - A block per (image, band of kBandRows output rows), bands of one image
//   in consecutive blocks (a band's last source rows are the next band's
//   first, read again from L2).  Warp 0 does the image's setup (the three
//   IEEE divisions) and the band's row taps once, into shared memory.
// - A thread per output column: its column tap, the flip folded in, is
//   computed once and held in registers for the band's rows (kBandRows
//   vertically adjacent pixels a thread); a row tap is one broadcast read,
//   and a source row's two pixels (six levels) three 32-bit reads.
// - Source rows staged once: the band's source rows, only the crop's
//   column span, copied into shared memory with 16-byte cp.async (.cg:
//   through L2 only), a warp a row, a lane a chunk, in two commit groups:
//   the rows of the band's first half of output rows, sampled while the
//   rest lands, then the rest (2.5 us off 50 at B = 128).  Where d > 1 the
//   full-resolution rows of a few averaged rows at a time are staged the
//   same way and averaged once into rows of the averaged image
//   (box_average's integer rounding), which are then sampled as at d = 1.
// - Whole-sector stores: a band's output rows are contiguous in the tile;
//   they are built in shared memory and written as 16-byte stores.
// - Alignment: images lie at any byte of the arena (native.py's
//   arena_offsets packs them at cumulative H x W x 3 bytes; COCO's 500-wide
//   images have 1,500-byte rows).  A row's span is read as the aligned-down
//   16-byte chunks that hold it, and its shared-memory row keeps its own
//   shift; the chunks are guarded by the arena's bounds, which the entry
//   takes: a chunk that crosses either end is copied byte by byte.  The
//   output may start at any byte too (a slice of the cache's tiles): its
//   shared-memory copy keeps the output's shift, so that the aligned
//   chunks of both coincide, and the chunks at either end go byte by byte.
// - Budget: kSmemBytes of dynamic shared memory a block, four blocks an
//   SM.  A 640-pixel crop at d = 1 (2.9 source rows an output row) fits in
//   one pass: at most 23 rows of 1,936 bytes.  What does not fit (wider
//   crops, larger d) is cut into column tiles (the widest of S, S/2, ...
//   whose two source rows fit) and, within a band, into runs of rows that
//   fit; each pass stages, then samples.
// - Parameters: the entry takes the per-image arrays as host pointers,
//   checks them and packs them into the launch's own parameters, kBatch
//   images a launch (32,000 bytes): no copy before a launch, where a copy
//   from pinned memory held each launch 11 us on the card.  A larger batch
//   (the configs' 1,024) is cut into launches of kBatch images.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

// One image's parameters as the kernel reads them; 40 bytes.
struct CropParams {
  long long offset;  // byte offset of the image in the arena
  int height, width; // 0 x 0: a failed decode
  int flip;
  int denom;         // 1, 2, 4 or 8: sample the image averaged over blocks
  float box[4];      // normalized (y0, x0, y1, x1); y0 < 0: the whole image
};

// Dynamic shared memory a block; a macro so that a test can squeeze it
// and send small images through the column tiles and runs of rows.
#ifndef CROP_SMEM_BYTES
#define CROP_SMEM_BYTES (56 * 1024)
#endif

// Internal linkage (the unnamed namespace): a process that loads two builds
// of this file keeps each one's kernel and attributes apart.
namespace crop {
namespace {

// The entry's error for parameters that it refuses (decode_crop.cu names
// it; native.py raises ValueError).
constexpr int kBadParams = 20000;

constexpr int kMaxThreads = 256;
constexpr int kBandRows = 8;
constexpr int kSmemBytes = CROP_SMEM_BYTES;
// Images a launch carries: their parameters go by value, 32,000 bytes of
// the 32,764 that a launch may carry since CUDA 12.1.
constexpr int kBatch = 800;

// The source position of output index o along one axis: clamped to
// [0, extent - 1], its floor, the next index (clamped) and the weight.
struct Tap {
  int i0, i1;
  float w;
};

// A row tap of the running pass: the byte offsets of its two source rows
// in the staged buffer, and both weights.
struct __align__(16) RowTap {
  int off0, off1;
  float w, w1;
};

// The image's setup, once a block.
struct Setup {
  const uint8_t* src;  // the image's first byte
  int height, width;   // full resolution; 0: a failed decode
  int row_bytes;       // width x 3
  int d, ws;           // the block, and the averaged image's width
  int flip;
  float y0, x0, sy, sx;
};

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}
// Bytes of the aligned 16-byte chunks that hold `bytes` bytes starting at
// any address.
__host__ __device__ constexpr int chunked(int bytes) {
  return ((bytes + 30) >> 4) << 4;
}

constexpr int kSetupBytes = 64;
constexpr int kHeaderBytes =
    round16(kSetupBytes + kBandRows * (int)(sizeof(Tap) + sizeof(RowTap)));
static_assert(sizeof(Setup) <= kSetupBytes, "the setup's room");

// A band's output rows, with room for the output's shift.
__host__ __device__ constexpr int out_region(int size) {
  return round16(kBandRows * 3 * size + 15);
}
// The staged rows' room: the rest, but for 16 bytes that the sampling's
// 12-byte reads may run into past the last row.
__host__ __device__ constexpr int stage_bytes(int size) {
  return kSmemBytes - kHeaderBytes - out_region(size) - 16;
}

// Shared memory a pass takes to stage `rows` rows of the (averaged) image
// over `span` columns, and at d > 1 one averaged row's d full-resolution
// rows over `fspan` columns.
__host__ __device__ constexpr int pass_bytes(int rows, int span, int fspan,
                                             int d) {
  return d == 1 ? rows * chunked(3 * span)
                : rows * round16(3 * span) + d * chunked(3 * fspan);
}

// The most a pass can need, at a column tile of one: two rows of two
// columns, at d = 8.  Every size the entry takes leaves that much.
constexpr int kMinStage = pass_bytes(2, 2, 2 * 8, 8);

// The largest tile side the entry takes: 1024, or less where a squeezed
// budget leaves no kMinStage beside a band's output rows.
constexpr int max_size() {
  int size = 1024;
  while (size > 1 && stage_bytes(size) < kMinStage) --size;
  return size;
}
constexpr int kMaxSize = max_size();
static_assert(stage_bytes(kMaxSize) >= kMinStage, "the smallest pass fits");

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

// Byte k of x as a float, exactly: (2^23 | byte) - 2^23, the first term
// built by one byte permute.
template <int k>
__device__ __forceinline__ float level(uint32_t x) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + k)),
                   8388608.f);
}

// The levels of the pixel at `p` (any byte of shared memory) and of the
// next one: three 32-bit loads and two funnel shifts.
__device__ __forceinline__ void two_pixels(const uint8_t* p, float (&v)[6]) {
  const uint32_t* w = (const uint32_t*)((uintptr_t)p & ~(uintptr_t)3);
  const int shift = 8 * (int)((uintptr_t)p & 3);
  const uint32_t w1 = w[1];
  const uint32_t x = __funnelshift_r(w[0], w1, shift);
  const uint32_t y = __funnelshift_r(w1, w[2], shift);
  v[0] = level<0>(x);
  v[1] = level<1>(x);
  v[2] = level<2>(x);
  v[3] = level<3>(x);
  v[4] = level<0>(y);
  v[5] = level<1>(y);
}

// The level of x in [0, 2^23): (int)x, truncated, as the low byte of the
// round-down sum x + 2^23.
__device__ __forceinline__ uint8_t to_level(float x) {
  return (uint8_t)__float_as_uint(__fadd_rd(x, 8388608.f));
}

// 16 bytes from device memory to shared memory, asynchronously, through L2.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

// Close this thread's group of cp.async copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most the newest N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The aligned chunk at `g` into shared memory: with cp.async where it lies
// inside [lo, hi), else its bytes inside one by one.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* g,
                                           const uint8_t* lo,
                                           const uint8_t* hi) {
  if (g >= lo && g + 16 <= hi) {
    cp_async16(dst, g);
  } else {
    for (int b = 0; b < 16; ++b)
      if (g + b >= lo && g + b < hi) dst[b] = g[b];
  }
}

__device__ __forceinline__ const uint8_t* align16(const uint8_t* p) {
  return (const uint8_t*)((uintptr_t)p & ~(uintptr_t)15);
}

// Rows r0..r1-1 of a span, row r at `seg` + r x `row_bytes`, into shared
// memory rows of `pitch` bytes from `dst`, each from the aligned chunk
// that holds its first byte: a warp a row, a lane a chunk.  The copies are
// this thread's open group.
__device__ __forceinline__ void stage_rows(uint8_t* dst, int pitch,
                                           const uint8_t* seg, int row_bytes,
                                           int r0, int r1, const uint8_t* lo,
                                           const uint8_t* hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = r0 + warp; r < r1; r += nwarps) {
    const uint8_t* g = align16(seg + (long long)r * row_bytes);
    for (int k = lane; k < pitch >> 4; k += 32)
      copy_chunk(dst + r * pitch + 16 * k, g + 16 * k, lo, hi);
  }
}

// A launch's images' parameters, passed by value.
struct ParamBatch {
  CropParams img[kBatch];
};
static_assert(sizeof(ParamBatch) + 64 <= 32764, "a launch's parameters");

__global__ void __launch_bounds__(kMaxThreads, 4)
crop_resize_flip_kernel(const uint8_t* __restrict__ arena,
                        long long arena_bytes,
                        const __grid_constant__ ParamBatch batch, int size,
                        uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char crop_smem[];
  Setup& setup = *reinterpret_cast<Setup*>(crop_smem);
  Tap* const row_tap = reinterpret_cast<Tap*>(crop_smem + kSetupBytes);
  RowTap* const row_off = reinterpret_cast<RowTap*>(
      crop_smem + kSetupBytes + kBandRows * sizeof(Tap));
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int img = blockIdx.y, band_lo = blockIdx.x * kBandRows;
  const int band_rows = min(kBandRows, size - band_lo);
  const int row3 = 3 * size;

  // The image's setup and the band's row taps, by warp 0.
  if (tid < 32) {
    const CropParams p = batch.img[img];
    const bool ok = p.height > 0 && p.width > 0;
    const int d = p.denom > 1 ? p.denom : 1;
    const int hs = ok ? (p.height + d - 1) / d : 0;
    const int ws = ok ? (p.width + d - 1) / d : 0;
    const float h = (float)hs, w = (float)ws, s = (float)size;
    float y0 = 0.f, x0 = 0.f, sy = 0.f, sx = 0.f;
    if (ok && p.box[0] < 0.f) {
      sy = __fdiv_rn(h, s);
      sx = __fdiv_rn(w, s);
    } else if (ok) {
      y0 = __fmul_rn(p.box[0], h);
      x0 = __fmul_rn(p.box[1], w);
      sy = __fdiv_rn(__fmaf_rn(p.box[2], h, -y0), s);
      sx = __fdiv_rn(__fmaf_rn(p.box[3], w, -x0), s);
    }
    if (tid == 0) {
      setup.src = arena + p.offset;
      setup.height = ok ? p.height : 0;
      setup.width = ok ? p.width : 0;
      setup.row_bytes = 3 * p.width;
      setup.d = d;
      setup.ws = ws;
      setup.flip = p.flip;
      setup.y0 = y0;
      setup.x0 = x0;
      setup.sy = sy;
      setup.sx = sx;
    }
    if (ok && tid < band_rows) row_tap[tid] = crop_tap(band_lo + tid, y0, sy, hs);
  }
  __syncthreads();

  uint8_t* const gout = out + ((size_t)img * size + band_lo) * row3;
  const int oshift = (int)((uintptr_t)gout & 15);
  uint8_t* const obuf = crop_smem + kHeaderBytes + oshift;
  uint8_t* const stage = crop_smem + kHeaderBytes + out_region(size);
  const int budget = stage_bytes(size);
  const Setup st = setup;
  const bool failed = st.height == 0;

  if (!failed) {
    const uint8_t* const lo = arena;
    const uint8_t* const hi = arena + arena_bytes;
    const int d = st.d;
    // Column tiles: the widest of size, size/2, ... whose two source rows
    // fit, by a bound on the span of a tile's source columns.
    int tile = size;
    while (tile > 1) {
      const int span = min(st.ws, (int)((float)(tile - 1) * st.sx) + 4);
      if (pass_bytes(2, span, min(span * d, st.width), d) <= budget) break;
      tile = (tile + 1) >> 1;
    }
    for (int ca = 0; ca < size; ca += tile) {
      const int cb = min(size, ca + tile);
      // The taps are monotone in the output column: the tile's source
      // columns lie between those of its two ends.
      const int first = st.flip ? size - cb : ca;
      const int last = st.flip ? size - 1 - ca : cb - 1;
      const int c_lo = crop_tap(first, st.x0, st.sx, st.ws).i0;
      const int c_hi = crop_tap(last, st.x0, st.sx, st.ws).i1;
      const int span = c_hi - c_lo + 1;
      const int fx_lo = c_lo * d;
      const int fspan = min((c_hi + 1) * d, st.width) - fx_lo;
      for (int ra = 0; ra < band_rows;) {
        // The longest run of the band's rows from ra whose source fits.
        int rb = ra + 1;
        while (rb < band_rows &&
               pass_bytes(row_tap[rb].i1 - row_tap[ra].i0 + 1, span, fspan,
                          d) <= budget)
          ++rb;
        const int r_lo = row_tap[ra].i0;
        const int rows = row_tap[rb - 1].i1 - r_lo + 1;
        int mid = rb;  // the rows sampled before the last wait
        if (d == 1) {
          const int pitch = chunked(3 * span);
          const uint8_t* seg = st.src + (long long)r_lo * st.row_bytes + 3 * c_lo;
          if (tid < rb - ra) {
            const Tap t = row_tap[ra + tid];
            const int a = t.i0 - r_lo, b = t.i1 - r_lo;
            row_off[tid] = {
                a * pitch + (int)((uintptr_t)(seg + (long long)a * st.row_bytes) & 15),
                b * pitch + (int)((uintptr_t)(seg + (long long)b * st.row_bytes) & 15),
                t.w, __fsub_rn(1.f, t.w)};
          }
          // Two groups: the source rows of the run's first half of output
          // rows, then the rest, the first half sampled while the rest
          // lands.
          mid = ra + (rb - ra + 1) / 2;
          const int rows_a = row_tap[mid - 1].i1 - r_lo + 1;
          stage_rows(stage, pitch, seg, st.row_bytes, 0, rows_a, lo, hi);
          cp_async_commit();
          stage_rows(stage, pitch, seg, st.row_bytes, rows_a, rows, lo, hi);
          cp_async_commit();
          cp_async_wait<1>();
          __syncthreads();
        } else {
          // Rows of the averaged image: a group of them at a time, its
          // full-resolution rows staged, then each block's sum rounded.
          const int apitch = round16(3 * span), fpitch = chunked(3 * fspan);
          uint8_t* const scratch = stage + rows * apitch;
          const int group = (budget - rows * apitch) / (d * fpitch);
          if (tid < rb - ra) {
            const Tap t = row_tap[ra + tid];
            row_off[tid] = {(t.i0 - r_lo) * apitch, (t.i1 - r_lo) * apitch,
                            t.w, __fsub_rn(1.f, t.w)};
          }
          const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
          for (int ga = 0; ga < rows; ga += group) {
            const int gb = min(rows, ga + group);
            const int fy_lo = (r_lo + ga) * d;
            const int fy_hi = min((r_lo + gb) * d, st.height);
            const uint8_t* fseg =
                st.src + (long long)fy_lo * st.row_bytes + 3 * fx_lo;
            stage_rows(scratch, fpitch, fseg, st.row_bytes, 0, fy_hi - fy_lo,
                       lo, hi);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            for (int r = ga + warp; r < gb; r += nwarps) {
              const int y_a = (r_lo + r) * d - fy_lo;
              const int y_b = min((r_lo + r + 1) * d, st.height) - fy_lo;
              for (int e = lane; e < 3 * span; e += 32) {
                const int x = e / 3, c = e - 3 * x;
                const int x_a = (c_lo + x) * d;
                const int x_b = min(x_a + d, st.width);
                int sum = 0;
                for (int y = y_a; y < y_b; ++y) {
                  const uint8_t* g = fseg + (long long)y * st.row_bytes;
                  const uint8_t* row = scratch + y * fpitch +
                                       ((uintptr_t)g & 15) +
                                       3 * (x_a - fx_lo) + c;
                  for (int k = 0; k < x_b - x_a; ++k) sum += row[3 * k];
                }
                const int count = (y_b - y_a) * (x_b - x_a);
                stage[r * apitch + e] = (uint8_t)((sum + count / 2) / count);
              }
            }
            __syncthreads();
          }
        }
        // Sample rows r0..r1-1 of the run: a thread a column of the tile,
        // down the rows.  The right neighbour is read at i0 + 1 even where
        // the tap clamps it to i0 (the last column): its weight is then 0,
        // and its product with any level is 0, as with the clamped one's.
        auto sample = [&](int r0, int r1) {
          for (int ox = ca + tid; ox < cb; ox += nthreads) {
            const Tap tx = crop_tap(st.flip ? size - 1 - ox : ox, st.x0, st.sx, st.ws);
            const int c0 = 3 * (tx.i0 - c_lo);
            const float wx = tx.w, wx1 = __fsub_rn(1.f, tx.w);
            uint8_t* dst = obuf + (ra + r0) * row3 + 3 * ox;
            for (int r = r0; r < r1; ++r, dst += row3) {
              const RowTap ty = row_off[r];
              float a[6], b[6];
              two_pixels(stage + ty.off0 + c0, a);
              two_pixels(stage + ty.off1 + c0, b);
  #pragma unroll
              for (int c = 0; c < 3; ++c) {
                const float top = __fmaf_rn(a[c], wx1, __fmul_rn(a[3 + c], wx));
                const float bot = __fmaf_rn(b[c], wx1, __fmul_rn(b[3 + c], wx));
                const float v = __fmaf_rn(top, ty.w1, __fmul_rn(ty.w, bot));
                dst[c] = to_level(__fadd_rn(v, 0.5f));
              }
            }
          }
        };
        sample(0, mid - ra);
        if (mid < rb) {
          cp_async_wait<0>();
          __syncthreads();
          sample(mid - ra, rb - ra);
        }
        __syncthreads();
        ra = rb;
      }
    }
  }

  // The band's rows to the tile: 16-byte stores of the chunks inside it,
  // the bytes of the chunks at either end one by one.
  uint8_t* const g0 = gout - oshift;
  const uint8_t* const s0 = obuf - oshift;
  const int end = oshift + band_rows * row3;
  for (int k = tid; k < (end + 15) >> 4; k += nthreads) {
    const int b0 = 16 * k;
    if (b0 >= oshift && b0 + 16 <= end) {
      *reinterpret_cast<uint4*>(g0 + b0) =
          failed ? make_uint4(0, 0, 0, 0)
                 : *reinterpret_cast<const uint4*>(s0 + b0);
    } else {
      for (int b = max(b0, oshift); b < min(b0 + 16, end); ++b)
        g0[b] = failed ? 0 : s0[b];
    }
  }
}

// This thread's parameter block, packed before each launch that copies it.
inline ParamBatch& batch_buffer() {
  thread_local ParamBatch batch;
  return batch;
}

// The kernel's shared-memory attributes, set once a thread on each device.
inline cudaError_t configure(int device) {
  thread_local std::vector<bool> configured;
  if ((int)configured.size() <= device) configured.resize(device + 1);
  if (configured[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      crop_resize_flip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (!err)
    err = cudaFuncSetAttribute(crop_resize_flip_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  configured[device] = err == cudaSuccess;
  return err;
}

// Whether the kernel takes every image: its denom is 1, 2, 4 or 8, its
// size is not negative and it lies inside the arena.
inline bool valid(long long arena_bytes, const long long* offsets,
                  const int* sizes, const int* denoms, int n) {
  for (int i = 0; i < n; ++i) {
    const int h = sizes[2 * i], w = sizes[2 * i + 1];
    const int d = denoms ? denoms[i] : 1;
    if (h < 0 || w < 0 || (d != 1 && d != 2 && d != 4 && d != 8)) return false;
    if (h > 0 && w > 0 &&
        (offsets[i] < 0 || offsets[i] > arena_bytes - 3LL * h * w))
      return false;
  }
  return true;
}

// Images first..first+n-1 of the caller's arrays as CropParams into `dst`.
inline void pack(CropParams* dst, const long long* offsets, const int* sizes,
                 const float* boxes, const unsigned char* flips,
                 const int* denoms, int first, int n) {
  for (int k = 0; k < n; ++k) {
    const int i = first + k;
    CropParams& p = dst[k];
    p.offset = offsets[i];
    p.height = sizes[2 * i];
    p.width = sizes[2 * i + 1];
    p.flip = flips[i] != 0;
    p.denom = denoms ? denoms[i] : 1;
    for (int c = 0; c < 4; ++c) p.box[c] = boxes[4 * i + c];
  }
}

// The launches of a batch that the entry took: kBatch images at a time.
inline int launch(const uint8_t* arena, long long arena_bytes,
                  const long long* offsets, const int* sizes,
                  const float* boxes, const unsigned char* flips,
                  const int* denoms, int n, int size, uint8_t* out,
                  int device, cudaStream_t stream) {
  if (cudaError_t err = configure(device)) return err;
  const int bands = (size + kBandRows - 1) / kBandRows;
  const int threads = size < kMaxThreads ? (size + 31) / 32 * 32 : kMaxThreads;
  ParamBatch& batch = batch_buffer();
  for (int first = 0; first < n; first += kBatch) {
    const int m = n - first < kBatch ? n - first : kBatch;
    pack(batch.img, offsets, sizes, boxes, flips, denoms, first, m);
    crop_resize_flip_kernel<<<dim3(bands, m), threads, kSmemBytes, stream>>>(
        arena, arena_bytes, batch, size, out + (size_t)first * size * size * 3);
    if (cudaError_t err = cudaGetLastError()) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace crop

// Tiles of `n` images from `arena` (`arena_bytes` bytes on `device`) into
// `out` (n, size, size, 3) uint8, on `stream`, in ceil(n / kBatch)
// launches.  Image i starts at byte offsets[i] and is sizes[2i] x
// sizes[2i + 1] (0 x 0: a failed decode, a zero tile); boxes[4i..4i+3] is
// its normalized crop, flips[i] mirrors it and denoms[i] (1 where denoms
// is null) is its block.  Every array is on the host.  Returns a launch's
// CUDA error, crop::kBadParams for images it refuses (before any launch),
// or 0: launched.
extern "C" int crop_resize_flip_u8(const void* arena, long long arena_bytes,
                                   const long long* offsets, const int* sizes,
                                   const float* boxes,
                                   const unsigned char* flips,
                                   const int* denoms, int n, int size,
                                   void* out, int device, void* stream) {
  if (n <= 0 || size <= 0 || size > crop::kMaxSize || arena_bytes < 0 ||
      device < 0)
    return cudaErrorInvalidValue;
  if (!crop::valid(arena_bytes, offsets, sizes, denoms, n))
    return crop::kBadParams;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err) return err;
  if (current != device && (err = cudaSetDevice(device))) return err;
  const int result = crop::launch((const uint8_t*)arena, arena_bytes, offsets,
                                  sizes, boxes, flips, denoms, n, size,
                                  (uint8_t*)out, device, (cudaStream_t)stream);
  if (current != device) cudaSetDevice(current);
  return result;
}

// The entry's limits, for its callers: the largest tile side, the images a
// launch carries, and the error for images it refuses.
extern "C" int crop_max_size() { return crop::kMaxSize; }
extern "C" int crop_images_per_launch() { return crop::kBatch; }
extern "C" int crop_bad_params() { return crop::kBadParams; }
