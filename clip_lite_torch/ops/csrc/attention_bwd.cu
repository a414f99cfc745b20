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
// Two routes compute that function (attention_route() in
// clip_lite_torch/ops/attention.py picks one by dtype and S): the
// CUDA-core route, attention_bwd() (fp32 products; float32 at any S, bf16
// at S > 64; float32 stays off the tensor cores, which would read it as
// TF32), and the tensor-core route, attention_bwd_tc() (bf16 at S <= 64;
// one pass on mma.sync, after the CUDA-core kernel below).
//
// CUDA-core route.  Design: one block per (b, h), as K1, in two passes, so that no
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
// read twice from device memory (the second read mostly from L2); the
// tensor-core route reads them once, in bf16 at up to 64 rows.  A key column j >= S
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

// ---- tensor-core route: bf16, S <= kTcMaxSeq (64), one pass -------------
//
// Why: the CUDA-core kernel reads both operands of every fp32 FMA of its
// four recompute products from shared memory (about 36 M warp-wide loads
// a launch at the flagship shape, some 150 us of its 181), and its second
// pass reads q, g, k and v again.  Every product of K2 is bf16 x bf16
// summed in fp32 (g, p_d and ds' are rounded to bf16 first, as in the JAX
// kernel), which is what mma.sync ... .f32.bf16.bf16.f32 computes.
//
// One block per (b, h), one warp per 16 rows (S padded to kSp, a multiple
// of 16).  q, k, v and g of the head are staged once with 16-byte cp.async
// (32 KB at S = 64), rows S..kSp-1 zeroed; nothing is read twice from
// device memory.
//   Phase 1, warp w owns query rows 16w..16w+15: S = Q K^T and
//     dP = G V^T (mma; A by ldmatrix, B = k, v rows by ldmatrix), the
//     softmax on the accumulators (tile_softmax, as K1's tensor-core
//     route), dropout by keep_at() on both, D_i = sum_j dp_ij p_ij over
//     the four lanes of a row, ds = p (dp - D_i) in fp32, dbias = ds
//     written once from the fragment (full bias), ds' = bf16(ds / 8) and
//     pd = bf16(p_d) into shared memory, and dq = ds' K with ds' repacked
//     in registers as the A operand (mma.cuh's accum_to_a), K by
//     ldmatrix.trans.
//   Barrier; phase 2, warp w owns key rows 16w..16w+15: dk = ds'^T Q and
//     dv = pd^T G, the transposed A operands and Q, G by ldmatrix.trans
//     from the (kSp, kSp) ds' and pd tiles (row stride kSp + 8, free of
//     bank conflicts).
// Each output row is owned by one warp, so nothing needs atomics; dq, dk
// and dv go through the staged tiles (free after phase 2) and leave with
// 16-byte stores.  Padded rows carry p_d = 0 and ds = 0; padded keys never
// enter the softmax, D_i or dbias.
using bf16 = __nv_bfloat16;

// Shared memory: q, k, v, g (kSp x kRow bf16 each), ds' and pd
// (kSp x (kSp + 8) bf16 each), the key bias (kSp fp32).
template <int kSp>
constexpr size_t tc_smem_bytes() {
  return (4 * kSp * mma::kRow + 2 * kSp * (kSp + 8)) * sizeof(bf16) +
         kSp * sizeof(float);
}

template <int kSp, bool kFull>
__global__ void __launch_bounds__(kSp * 2)
attention_bwd_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const bf16* __restrict__ grad, bf16* __restrict__ dqkv,
                        float* __restrict__ dbias, int S, int NH, float scale,
                        Dropout drop) {
  using namespace mma;
  constexpr int kNT = kSp / 8;         // 8-column accumulator tiles over keys
  constexpr int kTcThreads = kSp * 2;  // one warp per 16 rows
  constexpr int kDs = kSp + 8;         // row stride of the ds' and pd tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kSp * kRow;
  bf16* v_s = k_s + kSp * kRow;
  bf16* g_s = v_s + kSp * kRow;
  bf16* ds_s = g_s + kSp * kRow;
  bf16* pd_s = ds_s + kSp * kDs;
  float* key_bias = reinterpret_cast<float*>(pd_s + kSp * kDs);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = NH * 64;
  const size_t row3 = (size_t)3 * H;
  const bf16* src = qkv + (size_t)b * S * row3 + (size_t)h * 64;
  const int tid = threadIdx.x;
  stage_rows(q_s, src, row3, S, kSp, tid, kTcThreads);
  stage_rows(k_s, src + H, row3, S, kSp, tid, kTcThreads);
  stage_rows(v_s, src + 2 * H, row3, S, kSp, tid, kTcThreads);
  stage_rows(g_s, grad + (size_t)b * S * H + (size_t)h * 64, H, S, kSp, tid,
             kTcThreads);
  if (!kFull) {
    for (int j = tid; j < kSp; j += kTcThreads) {
      key_bias[j] = j < S ? bias[(size_t)b * S + j] : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16;  // query rows in phase 1, key rows in phase 2
  const size_t bh = ((size_t)b * NH + h) * S * S;

  // ---- phase 1: the warp's query rows -> dq, ds', pd ----------------------
  float s[kNT][4] = {};
  float dp[kNT][4] = {};
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t aq[4], ag[4];
    ldmatrix_x4(aq, a_rows(q_s, kRow, r0, kc * 16, lane));
    ldmatrix_x4(ag, a_rows(g_s, kRow, r0, kc * 16, lane));
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bk[4], bv[4];
      ldmatrix_x4(bk, bt_rows(k_s, kRow, np * 16, kc * 16, lane));
      mma_bf16(s[2 * np], aq, bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
      ldmatrix_x4(bv, bt_rows(v_s, kRow, np * 16, kc * 16, lane));
      mma_bf16(dp[2 * np], ag, bv[0], bv[1]);
      mma_bf16(dp[2 * np + 1], ag, bv[2], bv[3]);
    }
  }
  tile_softmax<kNT, kFull>(s, kFull ? bias + bh : nullptr, key_bias, r0, S, scale, lane);

  // Dropout on p (-> p_d, to shared memory) and on dp; D_i = sum_j dp p.
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    float pd[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + gr + 8 * (e >> 1);
      const int j = n * 8 + 2 * t + (e & 1);
      pd[e] = i < S ? s[n][e] : 0.f;
      if (drop.active && i < S && j < S) {
        const bool kept = keep_at(drop, b, h, i, j, NH, S);
        pd[e] = kept ? pd[e] * drop.inv_keep : 0.f;
        dp[n][e] = kept ? dp[n][e] * drop.inv_keep : 0.f;
      }
      dot[e >> 1] += dp[n][e] * s[n][e];
    }
    *reinterpret_cast<uint32_t*>(pd_s + (r0 + gr) * kDs + n * 8 + 2 * t) =
        pack_bf16(pd[0], pd[1]);
    *reinterpret_cast<uint32_t*>(pd_s + (r0 + gr + 8) * kDs + n * 8 + 2 * t) =
        pack_bf16(pd[2], pd[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
    dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
  }
  // ds in fp32; dbias = ds; s becomes ds' = ds / sqrt(HD) (rounded when
  // packed), also to shared memory for phase 2.
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + gr + 8 * (e >> 1);
      const int j = n * 8 + 2 * t + (e & 1);
      const float ds = s[n][e] * (dp[n][e] - dot[e >> 1]);
      if (kFull && i < S && j < S) dbias[bh + (size_t)i * S + j] = ds;
      s[n][e] = ds * scale;
    }
    *reinterpret_cast<uint32_t*>(ds_s + (r0 + gr) * kDs + n * 8 + 2 * t) =
        pack_bf16(s[n][0], s[n][1]);
    *reinterpret_cast<uint32_t*>(ds_s + (r0 + gr + 8) * kDs + n * 8 + 2 * t) =
        pack_bf16(s[n][2], s[n][3]);
  }
  float acc[8][4] = {};
#pragma unroll
  for (int kc = 0; kc < kSp / 16; ++kc) {
    uint32_t a[4];
    accum_to_a(a, s, kc);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bk[4];
      ldmatrix_x4_trans(bk, b_rows(k_s, kRow, kc * 16, np * 16, lane));
      mma_bf16(acc[2 * np], a, bk[0], bk[1]);
      mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
    }
  }
  uint32_t dq[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dq[n][0] = pack_bf16(acc[n][0], acc[n][1]);
    dq[n][1] = pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncthreads();

  // ---- phase 2: the warp's key rows -> dk = ds'^T Q, dv = pd^T G ----------
  float dk[8][4] = {};
  float dv[8][4] = {};
#pragma unroll
  for (int kc = 0; kc < kSp / 16; ++kc) {
    uint32_t ads[4], apd[4];
    ldmatrix_x4_trans(ads, at_rows(ds_s, kDs, kc * 16, r0, lane));
    ldmatrix_x4_trans(apd, at_rows(pd_s, kDs, kc * 16, r0, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bq[4], bg[4];
      ldmatrix_x4_trans(bq, b_rows(q_s, kRow, kc * 16, np * 16, lane));
      mma_bf16(dk[2 * np], ads, bq[0], bq[1]);
      mma_bf16(dk[2 * np + 1], ads, bq[2], bq[3]);
      ldmatrix_x4_trans(bg, b_rows(g_s, kRow, kc * 16, np * 16, lane));
      mma_bf16(dv[2 * np], apd, bg[0], bg[1]);
      mma_bf16(dv[2 * np + 1], apd, bg[2], bg[3]);
    }
  }
  __syncthreads();  // q, k, v and g are read for the last time

  // dq, dk, dv into the staged tiles' rows of their warp, then out.
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(q_s + (r0 + gr) * kRow + n * 8 + 2 * t) = dq[n][0];
    *reinterpret_cast<uint32_t*>(q_s + (r0 + gr + 8) * kRow + n * 8 + 2 * t) = dq[n][1];
  }
  accum_to_tile(k_s, r0, dk, lane);
  accum_to_tile(v_s, r0, dv, lane);
  __syncthreads();
  bf16* dst = dqkv + (size_t)b * S * row3 + (size_t)h * 64;
  store_rows(dst, row3, q_s, S, tid, kTcThreads);
  store_rows(dst + H, row3, k_s, S, tid, kTcThreads);
  store_rows(dst + 2 * H, row3, v_s, S, tid, kTcThreads);
}

template <int kSp, bool kFull>
int launch_tc(const void* qkv, const void* bias, const void* g, void* dqkv,
              void* dbias, int B, int S, int NH, const Dropout& drop,
              cudaStream_t stream) {
  auto kernel = attention_bwd_tc_kernel<kSp, kFull>;
  const size_t smem = tc_smem_bytes<kSp>();  // 55.5 KB at kSp = 64
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(NH, B), kSp * 2, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<float*>(dbias), S, NH, 1.0f / sqrtf(64.0f), drop);
  return (int)cudaGetLastError();
}

template <bool kFull>
int launch_tc_seq(const void* qkv, const void* bias, const void* g, void* dqkv,
                  void* dbias, int B, int S, int NH, const Dropout& drop,
                  cudaStream_t stream) {
  switch ((S + 15) / 16) {
    case 1: return launch_tc<16, kFull>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, stream);
    case 2: return launch_tc<32, kFull>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, stream);
    case 3: return launch_tc<48, kFull>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, stream);
    default: return launch_tc<64, kFull>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, stream);
  }
}

bool misaligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

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

// The tensor-core route: attention_bwd's arguments and function, for
// bf16 (dtype 1) at 1 <= S <= 64 only; any other dtype or S is refused
// with cudaErrorInvalidValue, and qkv, g or dqkv not 16-byte aligned with
// cudaErrorMisalignedAddress.
int attention_bwd_tc(const void* qkv, const void* bias, const void* g,
                     const void* keep, void* dqkv, void* dbias, int B, int S,
                     int NH, int HD, int dtype, int full_bias, int dropout,
                     unsigned int threshold, float inv_keep,
                     unsigned long long seed, void* stream) {
  if (HD != 64 || dtype != 1 || B < 1 || B > 65535 || S < 1 || S > kTcMaxSeq ||
      NH < 1 || (full_bias && dbias == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned16(qkv) || misaligned16(g) || misaligned16(dqkv)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full_bias
             ? launch_tc_seq<true>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, st)
             : launch_tc_seq<false>(qkv, bias, g, dqkv, dbias, B, S, NH, drop, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
