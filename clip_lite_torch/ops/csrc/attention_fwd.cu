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
// Five routes compute that function (attention_route() in
// clip_lite_torch/ops/attention.py picks one by dtype, S and, for
// float32, whether K2 takes the gradient):
//   - the CUDA-core route, attention_fwd(): fp32 products, float32 in
//     training at 80 < S <= 256 and below, bf16 at 64 < S <= 256 (q, k
//     and v staged whole).
//   - the tensor-core route, attention_fwd_tc(): bf16 at S <= 64, the
//     products on mma.sync (below, after the CUDA-core kernel).
//   - the 3xTF32 route, attention_fwd_tf32x3(): float32 inference at
//     S <= 80, the products on mma.sync as three TF32 products each, to
//     about 2^-21 of each (plain TF32 would change the numbers).
//   - the key-tiled 3xTF32 route, attention_fwd_tf32x3_tiled(): float32
//     inference at 80 < S <= 1024 (CLIP's ViT-B/16 at 197, ViT-L/14 at
//     257, ViT-L/14-336 at 577) and float32 training at 256 < S <= 1024,
//     keys streamed in tiles with an online softmax.
//   - the key-tiled tensor-core route, attention_fwd_tc_tiled(): bf16 at
//     256 < S <= 1024 (BERT and MPNet past 256 tokens), the same scheme
//     on bf16 mma.sync.
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
  if (drop.active) tile_dropout<kNT>(s, drop, b, h, i0, S, NH, lane);

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

// ---- 3xTF32 route: float32 inference, S <= kTf32MaxSeq (80) -------------
//
// Why: the CUDA-core kernel above makes one shared-memory load per fp32
// FMA in both products, which caps it near a quarter of the fp32 rate
// (CLIP's towers at S = 50 and 77 ran it at 7.7 and 6.6 TFLOP/s, slower
// than scaled_dot_product_attention).  Here both products run on the
// tensor cores as 3xTF32: each fp32 operand x is split once into
// big = tf32(x) and small = tf32(x - big) (cvt.rna), and
// small.big + big.small + big.big, three mma.sync m16n8k8 TF32 products
// accumulated in fp32, give each product to about 2^-21 of its size
// (TF32 alone: 2^-11), against fp32's 2^-24; small.small is left out.  The
// sums stay fp32.  The fp32 bars (rtol = atol = 1e-5 against the plain
// version) hold it: on the card its distance from a float64 evaluation is
// about 2.5 times the plain version's.  The softmax takes __expf and one
// reciprocal a row (tile_softmax_rows' kFastMath), each within a few ulp.
// Training takes the CUDA-core kernel instead: K2's fp32 recompute
// regenerates that kernel's probabilities, and against them these
// differences moved an fp32 training step's QKV gradients past the bar
// that holds it to the plain step (PERF.md).
//
// The limit, S <= 80 (CLIP's 77 and every shorter length), keeps every
// instantiation in registers: at 11 tiles of keys and more ptxas spills.
//
// What bounds it: bytes, on paper.  At CLIP's text tower (B = 128,
// S = 77, 8 heads, full bias) one launch reads 60.6 MB of qkv and 24.3 MB
// of bias and writes 20.2 MB, 31 us at 3.35 TB/s, against 5.0 GFLOP of
// TF32 products with the padding (about 10 us at the 495 TFLOP/s dense
// peak).  On the card the three mma.sync products a tile, which reach far
// less than that peak, take the larger share (PERF.md).
//
// A block of one warp per 16 query rows (S padded to a multiple of 16 for
// the rows, of 8 for the keys: kNT tiles of 8 keys) walks over every
// gridDim-th (b, h), the grid as large as the card holds at once, with
// two stages of shared memory: the next (b, h)'s k, v and key bias are
// copied with cp.async (16 bytes; 4 for the bias) while this one
// computes, so that the copies of one head overlap the products of
// another inside every block and not only across blocks.  k sits at a
// row stride of 72 floats and v at 68, so that the fragment loads below
// are free of bank conflicts; rows S.. are zeroed.  q is not staged: each
// element is read by one lane once, so its A fragments go from device
// memory into registers (the next head's right after this one's scores),
// and the shared memory stays free for the stages.  Each full-bias
// element is read once, straight into its accumulator's position, while
// the scores are computed.
//
// The k index of an mma is a summation index, so each product permutes it
// inside every 8-wide chunk: A column t is element 2t of the chunk and
// column t + 4 element 2t + 1.  Then q's fragment is one float2 per row
// and chunk, k's one float2 of shared memory, and the scores' accumulator
// (c0, c1 = P[g][8n + 2t, 2t + 1], c2, c3 the same of row g + 8) is the A
// fragment of ctx = P V as it stands: a0 = c0, a1 = c2, a2 = c1, a3 = c3,
// with V rows 8n + 2t and 8n + 2t + 1 as B.  Padded keys never enter the
// softmax (their probabilities are 0 and their v rows 0); padded rows are
// never written.  Dropout calls keep_at() per element, as the other
// routes do.  The context leaves with one 16-byte store a lane per 8
// columns, after one exchange within each pair of lanes.  wgmma would pad
// the query tile to 64 rows (77 -> 128).
constexpr int kTf32MaxSeq = 80;
constexpr int kKRow = 72;  // floats per staged k row: float2 loads, no conflicts
constexpr int kVRow = 68;  // floats per staged v row: scalar loads, no conflicts

// The ablation's cuts: clip_lite_torch/scripts/k1_fp32_ablation.py builds
// this file with -DK1_TF32X3_CUT=<n> to time the kernel without one part
// (a cut build's output is wrong by design).  A normal build cuts nothing.
#ifndef K1_TF32X3_CUT
#define K1_TF32X3_CUT 0
#endif
enum Tf32Cut {
  kCutNone,
  kCutProducts,  // TF32 alone: one product a tile in place of three
  kCutCopies,    // k and v never copied into shared memory
  kCutStores,    // the context never written
  kCutFastMath,  // expf and a division an element in place of __expf, __frcp_rn
};
constexpr int kTf32Cut = K1_TF32X3_CUT;

// c += A B of split fp32 operands as 3xTF32 (TF32 alone under the cut).
__device__ __forceinline__ void tf32x3_product(float (&c)[4], const uint32_t (&ab)[4],
                                               const uint32_t (&as)[4],
                                               const uint32_t (&bb)[2],
                                               const uint32_t (&bs)[2]) {
  if constexpr (kTf32Cut == kCutProducts) {
    mma::mma_tf32(c, ab, bb[0], bb[1]);
  } else {
    mma::mma_tf32x3(c, ab, as, bb, bs);
  }
}

template <int kNT>
__host__ __device__ constexpr int tf32_threads() {
  return 32 * ((kNT + 1) / 2);
}

// One stage of shared memory: k (8 kNT x kKRow), v (8 kNT x kVRow) and
// the key bias (8 kNT), fp32.  A block holds two.
template <int kNT>
__host__ __device__ constexpr int tf32_stage_floats() {
  return 8 * kNT * (kKRow + kVRow + 1);
}

// Stage rows 0..n-1 of a 64-wide fp32 slice (row stride ld floats, every
// row 16-byte aligned) into a tile of row stride kStride with cp.async,
// and zero rows n..n_pad-1.
template <int kStride>
__device__ __forceinline__ void stage_rows_f32(float* tile, const float* src, size_t ld,
                                               int n, int n_pad, int tid, int nthreads) {
  for (int c = tid; c < n_pad * 16; c += nthreads) {
    const int r = c >> 4;
    float* dst = tile + r * kStride + (c & 15) * 4;
    if (r < n) {
      if (kTf32Cut != kCutCopies) mma::cp_async16(dst, src + r * ld + (c & 15) * 4);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Start the copies of item w = (b, h)'s k, v and key bias into a stage.
template <int kNT, bool kFull>
__device__ __forceinline__ void stage_item(float* stage, const float* qkv,
                                           const float* bias, int w, int S, int NH,
                                           int tid) {
  constexpr int kKeys = 8 * kNT;
  constexpr int kThreadsTf32 = tf32_threads<kNT>();
  const int b = w / NH, h = w % NH;
  const size_t row3 = (size_t)3 * NH * 64;
  const float* src = qkv + (size_t)b * S * row3 + (size_t)h * 64;
  stage_rows_f32<kKRow>(stage, src + NH * 64, row3, S, kKeys, tid, kThreadsTf32);
  stage_rows_f32<kVRow>(stage + kKeys * kKRow, src + 2 * NH * 64, row3, S, kKeys, tid,
                        kThreadsTf32);
  if (!kFull) {
    float* key_bias = stage + kKeys * (kKRow + kVRow);
    for (int j = tid; j < kKeys; j += kThreadsTf32) {
      if (j < S) {
        mma::cp_async4(key_bias + j, bias + (size_t)b * S + j);
      } else {
        key_bias[j] = 0.f;
      }
    }
  }
}

// This lane's A fragments of item w's q, rows i0 + g + 8r, columns
// 8kc + 2t and 8kc + 2t + 1 (0 on padded rows), from device memory.
__device__ __forceinline__ void load_q(float2 (&qa)[8][2], const float* qkv, int w,
                                       int S, int NH, int i0, int lane) {
  const int b = w / NH, h = w % NH;
  const size_t row3 = (size_t)3 * NH * 64;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    const float* row = qkv + ((size_t)b * S + i) * row3 + (size_t)h * 64 + 2 * t;
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      qa[kc][r] = i < S ? *reinterpret_cast<const float2*>(row + 8 * kc)
                        : make_float2(0.f, 0.f);
    }
  }
}

// Write a warp's 16 x 64 context (rows i0.., head h of item b) into out
// (B, S, H), rows i >= S left out.  Lanes t and t ^ 1 swap halves: an
// even lane stores row g, columns 8np + 2t .. 2t + 3, an odd one row
// g + 8, columns 8np + 2t - 2 .. 2t + 1, each as one 16-byte store.
__device__ __forceinline__ void store_context(float* out, const float (&o)[8][4], int b,
                                              int h, int i0, int S, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const int i = i0 + g + (odd ? 8 : 0);
  float* dst = out + ((size_t)b * S + i) * H + (size_t)h * 64 + 2 * (t & ~1);
#pragma unroll
  for (int np = 0; np < 8; ++np) {
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? o[np][0] : o[np][2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? o[np][1] : o[np][3], 1);
    if (i < S && kTf32Cut != kCutStores) {
      *reinterpret_cast<float4*>(dst + np * 8) =
          odd ? make_float4(x0, x1, o[np][2], o[np][3])
              : make_float4(o[np][0], o[np][1], x0, x1);
    }
  }
}

template <int kNT, bool kFull>
__global__ void __launch_bounds__(32 * ((kNT + 1) / 2))
attention_fwd_tf32x3_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                            float* __restrict__ out, int B, int S, int NH, float scale,
                            Dropout drop) {
  using namespace mma;
  constexpr int kKeys = 8 * kNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);

  const int items = B * NH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = (tid >> 5) * 16;
  const int H = NH * 64;
  int w = blockIdx.x;
  if (w >= items) return;
  stage_item<kNT, kFull>(stages, qkv, bias, w, S, NH, tid);
  cp_async_commit();
  float2 qa[8][2];
  load_q(qa, qkv, w, S, NH, i0, lane);

  for (int buf = 0; w < items; w += gridDim.x, buf ^= 1) {
    // The next item's copies fly while this one computes.
    const int next = w + gridDim.x;
    if (next < items) {
      stage_item<kNT, kFull>(stages + (buf ^ 1) * tf32_stage_floats<kNT>(), qkv, bias,
                             next, S, NH, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* k_s = stages + buf * tf32_stage_floats<kNT>();
    const float* v_s = k_s + kKeys * kKRow;
    const float* key_bias = v_s + kKeys * kVRow;
    const int b = w / NH, h = w % NH;

    // The full bias of this lane's accumulator positions, loaded while
    // the scores are computed.
    float bz[kNT][4];
    if (kFull) {
      const float* bias_bh = bias + ((size_t)b * NH + h) * S * S;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1);
          const int j = n * 8 + 2 * t + (e & 1);
          bz[n][e] = i < S && j < S ? bias_bh[(size_t)i * S + j] : 0.f;
        }
      }
    }

    float s[kNT][4] = {};
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      uint32_t ab[4], as[4];
      split_tf32(qa[kc][0].x, ab[0], as[0]);
      split_tf32(qa[kc][1].x, ab[1], as[1]);
      split_tf32(qa[kc][0].y, ab[2], as[2]);
      split_tf32(qa[kc][1].y, ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 kv =
            *reinterpret_cast<const float2*>(k_s + (n * 8 + g) * kKRow + 8 * kc + 2 * t);
        uint32_t bb[2], bs[2];
        split_tf32(kv.x, bb[0], bs[0]);
        split_tf32(kv.y, bb[1], bs[1]);
        tf32x3_product(s[n], ab, as, bb, bs);
      }
    }
    if (next < items) load_q(qa, qkv, next, S, NH, i0, lane);

    // s * scale + bias, keys j >= S out; then the softmax of each row.
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        s[n][e] = j < S ? s[n][e] * scale + (kFull ? bz[n][e] : key_bias[j]) : -INFINITY;
      }
    }
    tile_softmax_rows<kNT, kTf32Cut != kCutFastMath>(s);
    if (drop.active) tile_dropout<kNT>(s, drop, b, h, i0, S, NH, lane);

    float o[8][4] = {};
#pragma unroll
    for (int kc = 0; kc < kNT; ++kc) {
      uint32_t ab[4], as[4];
      split_tf32(s[kc][0], ab[0], as[0]);
      split_tf32(s[kc][2], ab[1], as[1]);
      split_tf32(s[kc][1], ab[2], as[2]);
      split_tf32(s[kc][3], ab[3], as[3]);
      const float* v = v_s + (8 * kc + 2 * t) * kVRow + g;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t bb[2], bs[2];
        split_tf32(v[np * 8], bb[0], bs[0]);
        split_tf32(v[kVRow + np * 8], bb[1], bs[1]);
        tf32x3_product(o[np], ab, as, bb, bs);
      }
    }
    store_context(out, o, b, h, i0, S, H, lane);
    // Every warp is done with this stage before it takes the item after next.
    __syncthreads();
  }
}

// ---- key-tiled 3xTF32 route: float32 inference, 80 < S <= 1024 ----------
//
// Replaces the same TPU kernel, clip_lite_tpu/ops/attention.py::
// _attention_fwd_kernel, at the lengths of CLIP's larger vision towers:
// ViT-B/16 (S = 197), ViT-L/14 (257) and ViT-L/14 at 336 px (577), where
// the JAX package's wrapper falls back to XLA above 256
// (clip_lite_tpu/ops/attention.py:353-356).  The route above holds every
// key tile of a head in registers and stops at S = 80; the CUDA-core
// kernel stages q, k and v whole in shared memory (197 KB at S = 256) and
// runs CLIP's lengths on the CUDA cores, slower than
// scaled_dot_product_attention.
//
// What bounds it: at (B, S, NH) = (128, 197, 12) the 310 MB of qkv and
// context take 0.0925 ms at 3.35 TB/s and the three TF32 products (45.8
// GFLOP) as long at the 495 TFLOP/s dense peak: both terms.  From S = 257
// on the products bind: 104 GFLOP, 0.210 ms, against 0.161 ms of bytes
// at (128, 257, 16), and 1.058 ms against 0.361 at 577 (the products
// grow as S^2, the bytes as S).  So the design keeps the scores and
// probabilities in registers, reads each qkv byte from device memory once
// per block that needs it (the blocks of one head run side by side and
// share k and v through the L2), and spends the fewest instructions it
// can beside the products: the same 3xTF32 mma.sync m16n8k8 products as
// the route above (mma.cuh's cvt.rna split, the permuted k index that
// makes the scores' accumulator P's A fragment as it stands).  It does
// not reach the bound: on the card it takes 5-8 times it, 1.1-1.2 times
// less than scaled_dot_product_attention (PERF.md section 6), its
// products at about a quarter of the rate mma.sync reaches alone.
//
// One block of four warps owns one (b, h) and 64 query rows, a warp 16 of
// them, q's fragments in registers.  Keys and values stream through
// shared memory in tiles of 32 (kTiledKeys), two stages: tile t + 1's k,
// v and key bias are copied with cp.async (16 bytes; 4 for the bias)
// while tile t computes, at the route above's row strides (72 and 68
// floats: no bank conflicts).  Per tile each warp computes its 16 x 32
// scores, adds the scale and the bias (a full bias read straight from
// device memory into the score fragments, each element once), and takes
// an online softmax in fp32 (Milakov and Gimelshein, 2018): a running max
// and a lane's share of the running sum a row; when the max rises the sum
// and the context accumulator are rescaled by __expf(m_old - m_new);
// p = __expf(s - m_new) unnormalised; dropout (keep_at, or the explicit
// keep mask) scales kept p by 1 / (1 - rate) and zeroes the rest, the sum
// taking the undropped p, as softmax-then-dropout does; then ctx += P V.
// One reciprocal a row at the end normalises the context.  The
// probabilities of float32 need no rounding to the compute type.
//
// Accuracy: the tensor cores' fp32 accumulation does not round to
// nearest, so its error grows with the number of products chained into
// one accumulator.  Chained over all of S (3 S / 8 products) the context
// lay 5-8 times the plain version's distance from float64 at S = 577 and
// 1024.  So each tile's products of P V (12 a column tile) go into a
// fresh accumulator, added to the context with one fp32 addition a tile,
// and the scores take two accumulators of 12 products each (the even and
// the odd 8-dim chunks of the head) in place of one of 24: at 0.9-1.2
// times the plain version's distance from float64, and faster
// (clip_lite_torch/scripts/k1_tiled_variants.py times the other forms).
//
// The ragged tail: the last key tile holds S mod 32 keys (1 at S = 257
// and 577, 5 at 197), so that tile computes only its 8-key chunks that
// hold a key (at S = 257 one chunk of eight) and zeroes only the rows up
// to the next multiple of 8; keys j >= S within that chunk enter neither
// the softmax nor the products.  Full tiles take a copy of the step
// without those branches, so that the compiler interleaves their chunks'
// products (with the branches in every tile the kernel took a third
// longer and more).
// Query rows go in tiles of 16 a warp: at S = 257 the fifth block of a
// head has one warp with rows (one of them real), the other three only
// copy k and v for it.
//
// The limit, S <= 1024 (kTiledMaxSeq, attention_common.cuh): nothing in
// the kernel depends on S but the count of tiles.  Training takes this
// kernel too above 256 tokens (K2's key-tiled route regenerates its
// probabilities with the same 3xTF32 scores); at 80 < S <= 256 it keeps
// the CUDA-core kernel, whose probabilities the CUDA-core K2 regenerates.
constexpr int kTiledKeys = 32;            // keys a tile
constexpr int kTiledNT = kTiledKeys / 8;  // 8-key chunks a tile

// One stage: k (32 x kKRow), v (32 x kVRow) and the key bias (32), fp32:
// 18,048 bytes; two a block.
constexpr int kTiledStageFloats = kTiledKeys * (kKRow + kVRow + 1);

// Start the copies of key tile [key0, key0 + 32) of (b, h): k, v and (for
// a key bias) the bias; rows from S up to the next multiple of 8 zeroed,
// the rest of the tile left as it is (no product reads it).
template <bool kFull>
__device__ __forceinline__ void stage_key_tile(float* stage, const float* qkv,
                                               const float* bias, int b, int h,
                                               int key0, int S, int NH, int tid) {
  const int n = min(kTiledKeys, S - key0);
  const int n_pad = (n + 7) & ~7;
  const size_t row3 = (size_t)3 * NH * 64;
  const float* src = qkv + ((size_t)b * S + key0) * row3 + (size_t)h * 64;
  stage_rows_f32<kKRow>(stage, src + NH * 64, row3, n, n_pad, tid, kTiledThreads);
  stage_rows_f32<kVRow>(stage + kTiledKeys * kKRow, src + 2 * NH * 64, row3, n, n_pad,
                        tid, kTiledThreads);
  if (!kFull) {
    float* key_bias = stage + kTiledKeys * (kKRow + kVRow);
    for (int j = tid; j < n_pad; j += kTiledThreads) {
      if (j < n) {
        mma::cp_async4(key_bias + j, bias + (size_t)b * S + key0 + j);
      } else {
        key_bias[j] = 0.f;
      }
    }
  }
}

// One key tile [key0, key0 + 32) of a warp's 16 query rows: the scores,
// the online softmax's update of (m, l, o), and ctx += P V.  kTail: the
// last tile, which may hold fewer keys; its 8-key chunks without a key
// are skipped and keys j >= S leave the softmax.
template <bool kFull, bool kTail>
__device__ __forceinline__ void tiled_step(const float2 (&qa)[8][2], float (&m)[2],
                                           float (&l)[2], float (&o)[8][4],
                                           const float* k_s, const float* bias_bh,
                                           int key0, int b, int h, int i0, int S,
                                           int NH, float scale, const Dropout& drop,
                                           int lane) {
  using namespace mma;
  const int g = lane >> 2, t = lane & 3;
  const float* v_s = k_s + kTiledKeys * kKRow;
  const float* key_bias = v_s + kTiledKeys * kVRow;
  // The tile's 8-key chunks that hold a key (all but in the last tile).
  const int chunks = kTail ? min(kTiledNT, (S - key0 + 7) / 8) : kTiledNT;

  // The scores in two accumulators, of the even and the odd 8-dim chunks.
  float s[kTiledNT][4] = {}, s_odd[kTiledNT][4] = {};
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    uint32_t ab[4], as[4];
    split_tf32(qa[kc][0].x, ab[0], as[0]);
    split_tf32(qa[kc][1].x, ab[1], as[1]);
    split_tf32(qa[kc][0].y, ab[2], as[2]);
    split_tf32(qa[kc][1].y, ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < kTiledNT; ++n) {
      if (!kTail || n < chunks) {
        const float2 kv = *reinterpret_cast<const float2*>(
            k_s + (n * 8 + g) * kKRow + 8 * kc + 2 * t);
        uint32_t bb[2], bs[2];
        split_tf32(kv.x, bb[0], bs[0]);
        split_tf32(kv.y, bb[1], bs[1]);
        tf32x3_product(kc & 1 ? s_odd[n] : s[n], ab, as, bb, bs);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kTiledNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += s_odd[n][e];
  }
  // s * scale + bias, keys j >= S out; the tile's row max.
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kTiledNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1);
      const int j = key0 + n * 8 + 2 * t + (e & 1);
      float v = -INFINITY;
      if (!kTail || j < S) {
        const float bij = kFull ? (i < S ? bias_bh[(size_t)i * S + j] : 0.f)
                                : key_bias[j - key0];
        v = s[n][e] * scale + bij;
      }
      s[n][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // Every tile holds a key of finite score, so mx is finite and the
  // first tile's factor is __expf(-inf) = 0.
  const float corr[2] = {__expf(m[0] - mx[0]), __expf(m[1] - mx[1])};
  m[0] = mx[0];
  m[1] = mx[1];
  l[0] *= corr[0];
  l[1] *= corr[1];
#pragma unroll
  for (int np = 0; np < 8; ++np) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[np][e] *= corr[e >> 1];
  }
#pragma unroll
  for (int n = 0; n < kTiledNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[n][e] - mx[e >> 1]);  // exp(-inf) = 0
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
  if (drop.active) tile_dropout<kTiledNT>(s, drop, b, h, i0, S, NH, lane, key0);

  // ctx += P V: chunk kc's scores are P's A fragment as they stand
  // (a0 = c0, a1 = c2, a2 = c1, a3 = c3), with v rows 8kc + 2t and
  // 8kc + 2t + 1 as B; the tile's products in a fresh accumulator.
  float ot[8][4] = {};
#pragma unroll
  for (int kc = 0; kc < kTiledNT; ++kc) {
    if (!kTail || kc < chunks) {
      uint32_t ab[4], as[4];
      split_tf32(s[kc][0], ab[0], as[0]);
      split_tf32(s[kc][2], ab[1], as[1]);
      split_tf32(s[kc][1], ab[2], as[2]);
      split_tf32(s[kc][3], ab[3], as[3]);
      const float* v = v_s + (8 * kc + 2 * t) * kVRow + g;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t bb[2], bs[2];
        split_tf32(v[np * 8], bb[0], bs[0]);
        split_tf32(v[kVRow + np * 8], bb[1], bs[1]);
        tf32x3_product(ot[np], ab, as, bb, bs);
      }
    }
  }
#pragma unroll
  for (int np = 0; np < 8; ++np) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[np][e] += ot[np][e];
  }
}

template <bool kFull>
__global__ void __launch_bounds__(kTiledThreads)
attention_fwd_tf32x3_tiled_kernel(const float* __restrict__ qkv,
                                  const float* __restrict__ bias,
                                  float* __restrict__ out, int S, int NH, int q_tiles,
                                  float scale, Dropout drop) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);

  const int w = blockIdx.x / q_tiles;  // (b, h)
  const int b = w / NH, h = w % NH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i0 = (blockIdx.x % q_tiles) * kTiledRows + (tid >> 5) * 16;
  const bool rows = i0 < S;  // this warp has a real query row
  const int n_tiles = (S + kTiledKeys - 1) / kTiledKeys;

  stage_key_tile<kFull>(stages, qkv, bias, b, h, 0, S, NH, tid);
  cp_async_commit();
  float2 qa[8][2];
  load_q(qa, qkv, w, S, NH, i0, lane);
  const float* bias_bh = kFull ? bias + ((size_t)b * NH + h) * S * S : nullptr;

  // Rows g and g + 8: the running max, and this lane's share of the sum.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4] = {};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_key_tile<kFull>(stages + (buf ^ 1) * kTiledStageFloats, qkv, bias, b, h,
                            (kt + 1) * kTiledKeys, S, NH, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (rows) {
      const float* k_s = stages + buf * kTiledStageFloats;
      const int key0 = kt * kTiledKeys;
      // A full tile takes no branch; the last, ragged one may skip chunks.
      if (key0 + kTiledKeys <= S) {
        tiled_step<kFull, false>(qa, m, l, o, k_s, bias_bh, key0, b, h, i0, S, NH,
                                 scale, drop, lane);
      } else {
        tiled_step<kFull, true>(qa, m, l, o, k_s, bias_bh, key0, b, h, i0, S, NH,
                                scale, drop, lane);
      }
    }
    // Every warp is done with this stage before the next tile refills it.
    __syncthreads();
  }
  if (!rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
  for (int np = 0; np < 8; ++np) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[np][e] *= inv[e >> 1];
  }
  store_context(out, o, b, h, i0, S, NH * 64, lane);
}

// ---- key-tiled tensor-core route: bf16, 256 < S <= 1024 -----------------
//
// Replaces the same TPU kernel, clip_lite_tpu/ops/attention.py::
// _attention_fwd_kernel, where the JAX package's wrapper falls back to XLA
// (above 256 tokens, attention.py:353-356): BERT and MPNet over captions
// of up to 512 and 514 tokens, in bf16 (every config sets AMP), in
// inference and in training.  The tensor-core route above stages a head
// whole and stops at 64; the CUDA-core kernel stages q, k and v in fp32
// and stops at 256.
//
// What bounds it: bytes.  At (B, S, NH) = (128, 512, 12) one launch reads
// 302 MB of qkv and writes 101 MB of context (0.120 ms at 3.35 TB/s),
// against 103 GFLOP of bf16 products (0.104 ms at the 989 TFLOP/s dense
// peak); a full bias adds 1.61 GB of fp32 reads (0.60 ms).  The design is
// the key-tiled 3xTF32 kernel's above on bf16 mma.sync m16n8k16: one block
// of four warps owns one (b, h) and 64 query rows, a warp 16 of them, q's
// A fragments in registers (straight from device memory, 0 on rows
// i >= S); keys and values stream through shared memory in tiles of 64
// (kTcTiledKeys), two stages: tile t + 1's k, v and key bias are copied
// with cp.async while tile t computes, rows at the tensor-core route's
// stride of 144 bytes (ldmatrix free of bank conflicts).  Per tile each
// warp takes its 16 x 64 scores (A = q, B = k rows by ldmatrix), adds the
// scale and the bias (a full bias read straight from device memory into
// the score fragments, each element once), and updates an online softmax
// in fp32: the running max a row, a lane's share of the running sum, the
// sum and the context rescaled by __expf(m_old - m_new) when the max
// rises; p = __expf(s - m_new); dropout (keep_at: Philox, or the explicit
// keep mask) scales kept p by 1 / (1 - rate) and zeroes the rest, the sum
// taking the undropped p; p rounded to bf16 and repacked in registers as
// the A operand of ctx += P V (mma.cuh's accum_to_a; V by
// ldmatrix.trans).  One reciprocal a row at the end normalises the
// context, which leaves through shared memory with 16-byte stores.
//
// Rounding: the TPU kernel and the plain version round the normalised
// probabilities p / l to bf16 before P V; an online softmax rounds the
// unnormalised p = exp(s - m) <= 1 instead, and divides the fp32 sum by l
// after.  Both roundings are relative, 2^-9 of each term, so the context
// lies as far from the exact function as the plain version's does, but
// not at the same bits: the bar is bf16's (rtol 1.6e-2, atol 1e-2 against
// the plain version) and, as for the tensor-core route, at most twice the
// plain version's distance from a float64 evaluation of the same inputs.
// The context's products are chained in fp32 over all of S: in bf16 the
// rounding of p, not the accumulation, sets the error.
//
// The ragged tail: the last tile holds S mod 64 keys (1 at S = 257), its
// other rows zeroed in shared memory and their keys out of the softmax
// (-inf, so p = 0 exactly against zero rows of v).  Query rows past S
// (the last block of a head) see q = 0 and are never written.
constexpr int kTcTiledKeys = 64;
constexpr int kTcTiledNT = kTcTiledKeys / 8;
// One stage: k, v (64 x kRow bf16 each) and the key bias (64 fp32):
// 18,688 bytes; two a block.
constexpr int kTcTiledStageBytes =
    2 * kTcTiledKeys * mma::kRow * (int)sizeof(bf16) + kTcTiledKeys * (int)sizeof(float);

// Start the copies of key tile [key0, key0 + 64) of (b, h): k, v and (for
// a key bias) the bias; the tile's rows past S zeroed.
template <bool kFull>
__device__ __forceinline__ void stage_tc_key_tile(unsigned char* stage, const bf16* qkv,
                                                  const float* bias, int b, int h,
                                                  int key0, int S, int NH, int tid) {
  const int n = min(kTcTiledKeys, S - key0);
  const size_t row3 = (size_t)3 * NH * 64;
  const bf16* src = qkv + ((size_t)b * S + key0) * row3 + (size_t)h * 64;
  bf16* k_s = reinterpret_cast<bf16*>(stage);
  bf16* v_s = k_s + kTcTiledKeys * mma::kRow;
  mma::stage_rows(k_s, src + NH * 64, row3, n, kTcTiledKeys, tid, kTiledThreads);
  mma::stage_rows(v_s, src + 2 * NH * 64, row3, n, kTcTiledKeys, tid, kTiledThreads);
  if (!kFull) {
    float* key_bias = reinterpret_cast<float*>(v_s + kTcTiledKeys * mma::kRow);
    for (int j = tid; j < kTcTiledKeys; j += kTiledThreads) {
      if (j < n) {
        mma::cp_async4(key_bias + j, bias + (size_t)b * S + key0 + j);
      } else {
        key_bias[j] = 0.f;
      }
    }
  }
}

// This lane's A fragments of q (rows i0 + g, i0 + g + 8; 16-deep chunk
// kc of the head), from device memory; 0 on rows i >= S.
__device__ __forceinline__ void load_q_bf16(uint32_t (&qa)[4][4], const bf16* qkv, int b,
                                            int h, int S, int NH, int i0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const size_t row3 = (size_t)3 * NH * 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    const bf16* row = qkv + ((size_t)b * S + min(i, S - 1)) * row3 + (size_t)h * 64 + 2 * t;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      qa[kc][r] = i < S ? *reinterpret_cast<const uint32_t*>(row + 16 * kc) : 0u;
      qa[kc][r + 2] = i < S ? *reinterpret_cast<const uint32_t*>(row + 16 * kc + 8) : 0u;
    }
  }
}

// One key tile [key0, key0 + 64) of a warp's 16 query rows: the scores,
// the online softmax's update of (m, l, o), and ctx += P V.
template <bool kFull>
__device__ __forceinline__ void tc_tiled_step(const uint32_t (&qa)[4][4], float (&m)[2],
                                              float (&l)[2], float (&o)[8][4],
                                              const unsigned char* stage,
                                              const float* bias_bh, int key0, int b,
                                              int h, int i0, int S, int NH, float scale,
                                              const Dropout& drop, int lane) {
  using namespace mma;
  const int g = lane >> 2, t = lane & 3;
  const bf16* k_s = reinterpret_cast<const bf16*>(stage);
  const bf16* v_s = k_s + kTcTiledKeys * kRow;
  const float* key_bias = reinterpret_cast<const float*>(v_s + kTcTiledKeys * kRow);

  float s[kTcTiledNT][4] = {};
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int np = 0; np < kTcTiledNT / 2; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, bt_rows(k_s, kRow, np * 16, kc * 16, lane));
      mma_bf16(s[2 * np], qa[kc], bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], qa[kc], bk[2], bk[3]);
    }
  }
  // s * scale + bias, keys j >= S out; the tile's row max.
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kTcTiledNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1);
      const int j = key0 + n * 8 + 2 * t + (e & 1);
      float v = -INFINITY;
      if (j < S) {
        const float bij = kFull ? (i < S ? bias_bh[(size_t)i * S + j] : 0.f)
                                : key_bias[j - key0];
        v = s[n][e] * scale + bij;
      }
      s[n][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // Every tile holds a key of finite score, so mx is finite and the first
  // tile's factor is __expf(-inf) = 0.
  const float corr[2] = {__expf(m[0] - mx[0]), __expf(m[1] - mx[1])};
  m[0] = mx[0];
  m[1] = mx[1];
  l[0] *= corr[0];
  l[1] *= corr[1];
#pragma unroll
  for (int np = 0; np < 8; ++np) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[np][e] *= corr[e >> 1];
  }
#pragma unroll
  for (int n = 0; n < kTcTiledNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[n][e] - mx[e >> 1]);  // exp(-inf) = 0
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
  if (drop.active) tile_dropout<kTcTiledNT>(s, drop, b, h, i0, S, NH, lane, key0);

  // ctx += P V: p rounded to bf16 as P's A fragment, V by ldmatrix.trans.
#pragma unroll
  for (int kc = 0; kc < kTcTiledKeys / 16; ++kc) {
    uint32_t a[4];
    accum_to_a(a, s, kc);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, b_rows(v_s, kRow, kc * 16, np * 16, lane));
      mma_bf16(o[2 * np], a, bv[0], bv[1]);
      mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
    }
  }
}

template <bool kFull>
__global__ void __launch_bounds__(kTiledThreads)
attention_fwd_tc_tiled_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                              bf16* __restrict__ out, int S, int NH, int q_tiles,
                              float scale, Dropout drop) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int w = blockIdx.x / q_tiles;  // (b, h)
  const int b = w / NH, h = w % NH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (blockIdx.x % q_tiles) * kTiledRows;
  const int r0 = (tid >> 5) * 16;  // the warp's rows in the block
  const int i0 = row0 + r0;
  const bool rows = i0 < S;  // this warp has a real query row
  const int n_tiles = (S + kTcTiledKeys - 1) / kTcTiledKeys;

  stage_tc_key_tile<kFull>(smem_raw, qkv, bias, b, h, 0, S, NH, tid);
  cp_async_commit();
  uint32_t qa[4][4];
  load_q_bf16(qa, qkv, b, h, S, NH, i0, lane);
  const float* bias_bh = kFull ? bias + ((size_t)b * NH + h) * S * S : nullptr;

  // Rows g and g + 8: the running max, and this lane's share of the sum.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4] = {};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_tc_key_tile<kFull>(smem_raw + (buf ^ 1) * kTcTiledStageBytes, qkv, bias, b, h,
                               (kt + 1) * kTcTiledKeys, S, NH, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (rows) {
      tc_tiled_step<kFull>(qa, m, l, o, smem_raw + buf * kTcTiledStageBytes, bias_bh,
                           kt * kTcTiledKeys, b, h, i0, S, NH, scale, drop, lane);
    }
    // Every warp is done with this stage before the next tile refills it.
    __syncthreads();
  }
  // The context, normalised, through the first stage's k rows, then out.
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);
  if (rows) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int np = 0; np < 8; ++np) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[np][e] *= inv[e >> 1];
    }
    accum_to_tile(tile, r0, o, lane);
  }
  __syncthreads();
  const int H = NH * 64;
  store_rows(out + ((size_t)b * S + row0) * H + (size_t)h * 64, H, tile,
             min(kTiledRows, S - row0), tid, kTiledThreads);
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

template <int kNT, bool kFull>
int launch_tf32x3(const void* qkv, const void* bias, void* out, int B, int S, int NH,
                  const Dropout& drop, cudaStream_t stream) {
  auto kernel = attention_fwd_tf32x3_kernel<kNT, kFull>;
  // Two stages: at most 88.1 KB (kNT = 10).  The largest shared-memory
  // carveout, so that as many blocks are resident as the occupancy query
  // below counts.
  const size_t smem = 2 * sizeof(float) * tf32_stage_floats<kNT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  // As many blocks as are resident at once, each over every gridDim-th
  // (b, h).
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        tf32_threads<kNT>(), smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * NH < sms * per_sm ? B * NH : sms * per_sm;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<blocks, tf32_threads<kNT>(), smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<float*>(out), B, S, NH, 1.0f / sqrtf(64.0f), drop);
  return (int)cudaGetLastError();
}

// The launch for kNT = ceil(S / 8) tiles of keys, 1 <= kNT <= 10; at 3
// tiles (S = 17..24) ptxas spills the full-bias kernel, so 4 take them.
template <bool kFull, int kNT = 1>
int launch_tf32x3_seq(const void* qkv, const void* bias, void* out, int B, int S,
                      int NH, const Dropout& drop, cudaStream_t stream) {
  if constexpr (kNT == 3) {
    return launch_tf32x3_seq<kFull, 4>(qkv, bias, out, B, S, NH, drop, stream);
  } else {
    if constexpr (kNT < kTf32MaxSeq / 8) {
      if (S > 8 * kNT) {
        return launch_tf32x3_seq<kFull, kNT + 1>(qkv, bias, out, B, S, NH, drop, stream);
      }
    }
    return launch_tf32x3<kNT, kFull>(qkv, bias, out, B, S, NH, drop, stream);
  }
}

template <bool kFull>
int launch_tf32x3_tiled(const void* qkv, const void* bias, void* out, int B, int S,
                        int NH, const Dropout& drop, cudaStream_t stream) {
  auto kernel = attention_fwd_tf32x3_tiled_kernel<kFull>;
  // Two stages, 36,096 bytes.
  const size_t smem = 2 * sizeof(float) * kTiledStageFloats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  // One block a (b, h) and 64 query rows, the query tiles of a head next
  // to each other, so that the blocks sharing k and v run together.
  const int q_tiles = (S + kTiledRows - 1) / kTiledRows;
  const long long blocks = (long long)B * NH * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kTiledThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<float*>(out), S, NH, q_tiles, 1.0f / sqrtf(64.0f), drop);
  return (int)cudaGetLastError();
}

template <bool kFull>
int launch_tc_tiled(const void* qkv, const void* bias, void* out, int B, int S, int NH,
                    const Dropout& drop, cudaStream_t stream) {
  // Two stages, 37,376 bytes: no opt-in needed.
  const size_t smem = 2 * kTcTiledStageBytes;
  // One block a (b, h) and 64 query rows, the query tiles of a head next
  // to each other, so that the blocks sharing k and v run together.
  const int q_tiles = (S + kTiledRows - 1) / kTiledRows;
  const long long blocks = (long long)B * NH * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  attention_fwd_tc_tiled_kernel<kFull><<<(unsigned)blocks, kTiledThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), S, NH, q_tiles, 1.0f / sqrtf(64.0f), drop);
  return (int)cudaGetLastError();
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

// The 3xTF32 route: attention_fwd's arguments and function, for float32
// (dtype 0) at 1 <= S <= 80 only; any other dtype or S is refused with
// cudaErrorInvalidValue, and qkv or out not 16-byte aligned with
// cudaErrorMisalignedAddress.
int attention_fwd_tf32x3(const void* qkv, const void* bias, const void* keep,
                         void* out, int B, int S, int NH, int HD, int dtype,
                         int full_bias, int dropout, unsigned int threshold,
                         float inv_keep, unsigned long long seed, void* stream) {
  if (HD != 64 || dtype != 0 || B < 1 || B > 65535 || S < 1 || S > kTf32MaxSeq ||
      NH < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned16(qkv) || misaligned16(out)) return (int)cudaErrorMisalignedAddress;
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full_bias ? launch_tf32x3_seq<true>(qkv, bias, out, B, S, NH, drop, st)
                   : launch_tf32x3_seq<false>(qkv, bias, out, B, S, NH, drop, st);
}

// The key-tiled 3xTF32 route: attention_fwd's arguments and function, for
// float32 (dtype 0) at 80 < S <= 1024 only; any other dtype or S is
// refused with cudaErrorInvalidValue, and qkv or out not 16-byte aligned
// with cudaErrorMisalignedAddress.
int attention_fwd_tf32x3_tiled(const void* qkv, const void* bias, const void* keep,
                               void* out, int B, int S, int NH, int HD, int dtype,
                               int full_bias, int dropout, unsigned int threshold,
                               float inv_keep, unsigned long long seed, void* stream) {
  if (HD != 64 || dtype != 0 || B < 1 || B > 65535 || S <= kTf32MaxSeq ||
      S > kTiledMaxSeq || NH < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned16(qkv) || misaligned16(out)) return (int)cudaErrorMisalignedAddress;
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full_bias ? launch_tf32x3_tiled<true>(qkv, bias, out, B, S, NH, drop, st)
                   : launch_tf32x3_tiled<false>(qkv, bias, out, B, S, NH, drop, st);
}

// The key-tiled tensor-core route: attention_fwd's arguments and function,
// for bf16 (dtype 1) at 1 <= S <= 1024 (attention_route() sends it
// 256 < S); any other dtype or S is refused with cudaErrorInvalidValue,
// and qkv or out not 16-byte aligned with cudaErrorMisalignedAddress.
int attention_fwd_tc_tiled(const void* qkv, const void* bias, const void* keep,
                           void* out, int B, int S, int NH, int HD, int dtype,
                           int full_bias, int dropout, unsigned int threshold,
                           float inv_keep, unsigned long long seed, void* stream) {
  if (HD != 64 || dtype != 1 || B < 1 || B > 65535 || S < 1 || S > kTiledMaxSeq ||
      NH < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned16(qkv) || misaligned16(out)) return (int)cudaErrorMisalignedAddress;
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full_bias ? launch_tc_tiled<true>(qkv, bias, out, B, S, NH, drop, st)
                   : launch_tc_tiled<false>(qkv, bias, out, B, S, NH, drop, st);
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
