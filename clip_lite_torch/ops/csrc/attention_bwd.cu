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
// Three routes compute that function (attention_route() in
// clip_lite_torch/ops/attention.py picks one by dtype and S): the
// CUDA-core route, attention_bwd() (fp32 products; float32 at S <= 256,
// bf16 at 64 < S <= 256), the tensor-core route, attention_bwd_tc() (bf16
// at S <= 64; one pass on mma.sync, after the CUDA-core kernel below), and
// the key-tiled route, attention_bwd_tiled() (both types at
// 256 < S <= 1024: two kernels, by query rows and by key columns, each
// streaming the other side through shared memory; at the end of the file).
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

// ---- key-tiled route: bf16 and float32, 256 < S <= 1024 ----------------
//
// Replaces the same TPU kernel, clip_lite_tpu/ops/attention.py::
// _attention_bwd_kernel, where the JAX package's wrapper falls back to XLA
// (above 256 tokens, attention.py:353-356): BERT and MPNet trained on
// captions of up to 512 and 514 tokens.  The CUDA-core kernel above
// stages two S x HD fp32 matrices a pass, 266 KB at S = 512, more than a
// block may have; the tensor-core one stages a head whole and stops at 64.
//
// What bounds it: at (B, S, NH) = (128, 512, 12) in bf16 the five products
// (258 GFLOP) take 0.260 ms at the 989 TFLOP/s dense peak and the bytes
// (qkv and g read, dqkv written: 705 MB) 0.210 ms at 3.35 TB/s; a full
// bias adds 1.61 GB of reads and 1.61 GB of dbias writes (1.17 ms in
// all).  In float32 each product is three TF32 products (1.56 ms at the
// 495 TFLOP/s TF32 peak).  This design is the simple one that is right,
// not the fastest: it computes nine products' worth where five would do
// (the scores and g v^T three times each), so that nothing needs atomics
// and nothing of the forward is saved.
//
// Two kernels, one launch each, one call (attention_bwd_tiled):
//   By query rows (attention_bwd_rows_kernel): a block of four warps owns
//     one (b, h) and 64 query rows, a warp 16, q and g of its rows staged
//     once; the key tiles (k, v and the key bias) stream through two
//     cp.async stages, twice.  Sweep A recomputes the scores and
//     dp = g v^T a tile at a time and keeps, per row, the online softmax's
//     max m_i and sum l_i and D_i = sum_j p_ij dp_ij (dp after dropout)
//     as a running sum of exp(s - m) dp, rescaled with l_i when the max
//     rises, divided by l_i at the end: the JAX design and the CUDA-core
//     pass 1's, with nothing of the forward saved.  Sweep B recomputes
//     p_ij = exp(s_ij - m_i) / l_i and ds_ij = p_ij (dp_ij - D_i), writes
//     dbias[b, h, i, j] = ds_ij (a full bias: each element by one lane,
//     once), and accumulates dq_i = sum_j ds'_ij k_j.  m, l and D go to a
//     (B, NH, S, 3) fp32 scratch tensor that the wrapper allocates.
//   By key columns (attention_bwd_cols_kernel): a block owns one (b, h)
//     and 64 keys, a warp 16, k and v of its keys staged once; the query
//     tiles (q, g and the rows' m, l, D) stream through two stages.  Per
//     tile each warp recomputes s^T = K Q^T and dp^T = V G^T, p and ds
//     from the rows' statistics, and accumulates dk_j = sum_i ds'_ij q_i
//     and dv_j = sum_i p_d,ij g_i.
// Both kernels compute a score with one expression: the same products
// chained in the same order over the head dim (the operands swap roles in
// the second kernel, A = k and B = q; each product of two bf16 or TF32
// values is exact in fp32, so the two agree as far as the tensor cores'
// sum of a chunk does not depend on which operand is A), then
// s * scale + bias in fp32, then exp(s - m_i) / l_i; and both draw dropout
// with keep_at() at (b, h, i, j), as K1 does.
//
// Products: bf16 on mma.sync m16n8k16 (the tensor-core route's fragments;
// p_d and ds' rounded to bf16 as the A operand, as the plain version
// rounds them); float32 as 3xTF32 on mma.sync m16n8k8, the scores with
// K1's key-tiled 3xTF32 arithmetic (mma.cuh's split, small.big + big.small
// + big.big, the even and the odd 8-dim chunks in two accumulators), so
// that K2 regenerates the probabilities K1 used.  The tensor cores' fp32
// accumulation does not round to nearest, and dq, dk and dv sum over all
// S keys or query rows: each tile's products go into a fresh accumulator,
// added to the result with one fp32 addition a tile (K1's key-tiled 3xTF32
// kernel found the chain over all of S 5-8 times the plain version's
// distance from float64).  Tiles: 32 keys (rows) in bf16, 16 in float32,
// where the three products a tile and the split operands hold more
// registers.  Staged rows: bf16 at 144 bytes (ldmatrix free of bank
// conflicts), fp32 at 68 floats (the float2 fragment loads and the scalar
// ones both free of them).
//
// Ragged tails: rows of a tile past S are zeroed in shared memory; keys
// j >= S leave the softmax in the first kernel (-inf: p = 0) and rows or
// keys past S get p = ds = 0 in the second; nothing past S is written.
template <typename T>
struct K2Tile;
template <>
struct K2Tile<bf16> {
  static constexpr int kRows = 32;  // keys (first kernel) or queries a tile
  static constexpr int kLd = mma::kRow;
};
template <>
struct K2Tile<float> {
  static constexpr int kRows = 16;
  static constexpr int kLd = 68;
};

// Shared memory of either kernel: its own 64 rows of two 64-wide slices
// (q, g or k, v), then two stages of a tile of the other two slices and
// kStats floats a row (the key bias, 1; the row statistics, 3).
template <typename T>
__host__ __device__ constexpr int k2_fixed_bytes() {
  return 2 * kTiledRows * K2Tile<T>::kLd * (int)sizeof(T);
}
template <typename T, int kStats>
__host__ __device__ constexpr int k2_stage_bytes() {
  return 2 * K2Tile<T>::kRows * K2Tile<T>::kLd * (int)sizeof(T) +
         K2Tile<T>::kRows * kStats * (int)sizeof(float);
}
template <typename T, int kStats>
__host__ __device__ constexpr int k2_smem_bytes() {
  return k2_fixed_bytes<T>() + 2 * k2_stage_bytes<T, kStats>();
}

// Stage rows 0..n-1 of a 64-wide slice (row stride ld elements, every row
// 16-byte aligned) with cp.async at the type's staged stride, rows
// n..n_pad-1 zeroed.
__device__ __forceinline__ void stage_slice(bf16* tile, const bf16* src, size_t ld, int n,
                                            int n_pad, int tid) {
  mma::stage_rows(tile, src, ld, n, n_pad, tid, kTiledThreads);
}
__device__ __forceinline__ void stage_slice(float* tile, const float* src, size_t ld, int n,
                                            int n_pad, int tid) {
  constexpr int kLd = K2Tile<float>::kLd;
  for (int c = tid; c < n_pad * 16; c += kTiledThreads) {
    const int r = c >> 4;
    float* dst = tile + r * kLd + (c & 15) * 4;
    if (r < n) {
      mma::cp_async16(dst, src + r * ld + (c & 15) * 4);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Start the copies of n fp32 values into a stage (cp.async, 4 bytes), the
// rest up to n_pad zeroed.
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int n, int n_pad,
                                             int tid) {
  for (int c = tid; c < n_pad; c += kTiledThreads) {
    if (c < n) {
      mma::cp_async4(dst + c, src + c);
    } else {
      dst[c] = 0.f;
    }
  }
}

// s[n] += A B^T over the head dim, bf16: A = rows r0..r0+15 of the staged
// tile a, B^T's columns = rows 8n.. of the staged tile bt; the four 16-deep
// chunks in order.  kAIsQuery names which side q is (the same products in
// the same order either way in bf16).
template <int kNT, bool kAIsQuery>
__device__ __forceinline__ void tile_scores(float (&s)[kNT][4], const bf16* a, int r0,
                                            const bf16* bt, int lane) {
  using namespace mma;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t af[4];
    ldmatrix_x4(af, a_rows(a, kRow, r0, kc * 16, lane));
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, bt_rows(bt, kRow, np * 16, kc * 16, lane));
      mma_bf16(s[2 * np], af, bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], af, bk[2], bk[3]);
    }
  }
}

// The same in float32, as K1's key-tiled 3xTF32 kernel computes its
// scores: each 8-wide chunk's index permuted (A column t = element 2t,
// column t + 4 = element 2t + 1, B's rows alike), the even and the odd
// chunks in two accumulators added at the end, and the three TF32
// products of a chunk in K1's order of q's and k's parts (q_small k_big,
// q_big k_small, q_big k_big): with A = k (kAIsQuery false) the operands
// swap and so do the first two products' operands.
template <int kNT, bool kAIsQuery>
__device__ __forceinline__ void tile_scores(float (&s)[kNT][4], const float* a, int r0,
                                            const float* bt, int lane) {
  using namespace mma;
  constexpr int kLd = K2Tile<float>::kLd;
  const int g = lane >> 2, t = lane & 3;
  float s_odd[kNT][4] = {};
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const float2 x0 = *reinterpret_cast<const float2*>(a + (r0 + g) * kLd + 8 * kc + 2 * t);
    const float2 x1 =
        *reinterpret_cast<const float2*>(a + (r0 + g + 8) * kLd + 8 * kc + 2 * t);
    uint32_t ab[4], as[4];
    split_tf32(x0.x, ab[0], as[0]);
    split_tf32(x1.x, ab[1], as[1]);
    split_tf32(x0.y, ab[2], as[2]);
    split_tf32(x1.y, ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(bt + (n * 8 + g) * kLd + 8 * kc + 2 * t);
      uint32_t bb[2], bs[2];
      split_tf32(y.x, bb[0], bs[0]);
      split_tf32(y.y, bb[1], bs[1]);
      float(&c)[4] = kc & 1 ? s_odd[n] : s[n];
      if (kAIsQuery) {
        mma_tf32(c, as, bb[0], bb[1]);
        mma_tf32(c, ab, bs[0], bs[1]);
      } else {
        mma_tf32(c, ab, bs[0], bs[1]);
        mma_tf32(c, as, bb[0], bb[1]);
      }
      mma_tf32(c, ab, bb[0], bb[1]);
    }
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += s_odd[n][e];
  }
}

// o[np] += P X, bf16: P (16 rows x 8 kNT, fp32 accumulator tiles) rounded
// to bf16 as the A operand, X = rows 0..8 kNT - 1 of the staged tile x.
template <int kNT>
__device__ __forceinline__ void tile_pv(float (&o)[8][4], const float (&p)[kNT][4],
                                        const bf16* x, int lane) {
  using namespace mma;
#pragma unroll
  for (int kc = 0; kc < kNT / 2; ++kc) {
    uint32_t a[4];
    accum_to_a(a, p, kc);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bx[4];
      ldmatrix_x4_trans(bx, b_rows(x, kRow, kc * 16, np * 16, lane));
      mma_bf16(o[2 * np], a, bx[0], bx[1]);
      mma_bf16(o[2 * np + 1], a, bx[2], bx[3]);
    }
  }
}

// The same in float32, 3xTF32: chunk kc's accumulator tile is P's A
// fragment as it stands (a0 = c0, a1 = c2, a2 = c1, a3 = c3), with rows
// 8kc + 2t and 8kc + 2t + 1 of x as B.
template <int kNT>
__device__ __forceinline__ void tile_pv(float (&o)[8][4], const float (&p)[kNT][4],
                                        const float* x, int lane) {
  using namespace mma;
  constexpr int kLd = K2Tile<float>::kLd;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kNT; ++kc) {
    uint32_t ab[4], as[4];
    split_tf32(p[kc][0], ab[0], as[0]);
    split_tf32(p[kc][2], ab[1], as[1]);
    split_tf32(p[kc][1], ab[2], as[2]);
    split_tf32(p[kc][3], ab[3], as[3]);
    const float* xr = x + (8 * kc + 2 * t) * kLd + g;
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t bb[2], bs[2];
      split_tf32(xr[np * 8], bb[0], bs[0]);
      split_tf32(xr[kLd + np * 8], bb[1], bs[1]);
      mma_tf32x3(o[np], ab, as, bb, bs);
    }
  }
}

// o += P X into a fresh accumulator, then added: the tile's chain alone.
template <int kNT, typename T>
__device__ __forceinline__ void add_tile_pv(float (&o)[8][4], const float (&p)[kNT][4],
                                            const T* x, int lane) {
  float ot[8][4] = {};
  tile_pv<kNT>(ot, p, x, lane);
#pragma unroll
  for (int np = 0; np < 8; ++np) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[np][e] += ot[np][e];
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Write a warp's 16 x 64 fp32 accumulator, rounded to T, into rows
// i0 + g, i0 + g + 8 of a 64-wide slice of device memory (row stride ld),
// rows i >= S left out.
template <typename T>
__device__ __forceinline__ void store_acc_rows(T* dst, size_t ld, const float (&o)[8][4],
                                               int i0, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i < S) {
      T* row = dst + (size_t)i * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) store_pair(row + 8 * n, o[n][2 * r], o[n][2 * r + 1]);
    }
  }
}

template <typename T, bool kFull>
__global__ void __launch_bounds__(kTiledThreads)
attention_bwd_rows_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                          const T* __restrict__ grad, T* __restrict__ dqkv,
                          float* __restrict__ dbias, float* __restrict__ stats, int S,
                          int NH, int row_tiles, float scale, Dropout drop) {
  using namespace mma;
  constexpr int kKeys = K2Tile<T>::kRows, kLd = K2Tile<T>::kLd, kNT = kKeys / 8;
  constexpr int kStage = k2_stage_bytes<T, 1>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* g_s = q_s + kTiledRows * kLd;
  unsigned char* stages = smem_raw + k2_fixed_bytes<T>();

  const int w = blockIdx.x / row_tiles;  // (b, h)
  const int b = w / NH, h = w % NH;
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x % row_tiles) * kTiledRows;
  const int r0 = (tid >> 5) * 16;  // the warp's rows in the block
  const int i0 = row0 + r0;
  const bool rows = i0 < S;  // this warp has a real query row
  const int H = NH * 64;
  const size_t row3 = (size_t)3 * H;
  const T* head = qkv + (size_t)b * S * row3 + (size_t)h * 64;  // q_h of row 0
  const size_t bh = ((size_t)b * NH + h) * S * S;
  const int n_tiles = (S + kKeys - 1) / kKeys;

  // Start the copies of key tile kt: k, v and (a key bias) the bias.
  auto stage_keys = [&](int kt, int buf) {
    const int key0 = kt * kKeys, n = min(kKeys, S - key0);
    T* k_t = reinterpret_cast<T*>(stages + buf * kStage);
    T* v_t = k_t + kKeys * kLd;
    stage_slice(k_t, head + (size_t)key0 * row3 + H, row3, n, kKeys, tid);
    stage_slice(v_t, head + (size_t)key0 * row3 + 2 * H, row3, n, kKeys, tid);
    if (!kFull) {
      stage_floats(reinterpret_cast<float*>(v_t + kKeys * kLd), bias + (size_t)b * S + key0,
                   n, kKeys, tid);
    }
  };
  const int n_q = min(kTiledRows, S - row0);
  stage_slice(q_s, head + (size_t)row0 * row3, row3, n_q, kTiledRows, tid);
  stage_slice(g_s, grad + ((size_t)b * S + row0) * H + (size_t)h * 64, H, n_q, kTiledRows,
              tid);
  stage_keys(0, 0);
  cp_async_commit();

  // Rows g and g + 8: the running max, this lane's shares of the sum and
  // of sum_j exp(s - m) dp; after sweep A, l and D of the row.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float dq[8][4] = {};
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int kt = it % n_tiles, buf = it & 1;
    if (it + 1 < 2 * n_tiles) stage_keys((it + 1) % n_tiles, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == n_tiles) {  // sweep A done: the rows' l and D
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
        dd[r] /= l[r];
      }
    }
    if (rows) {
      const T* k_t = reinterpret_cast<const T*>(stages + buf * kStage);
      const T* v_t = k_t + kKeys * kLd;
      const float* key_bias = reinterpret_cast<const float*>(v_t + kKeys * kLd);
      const int key0 = kt * kKeys;
      float s[kNT][4] = {}, dp[kNT][4] = {};
      tile_scores<kNT, true>(s, q_s, r0, k_t, lane);
      tile_scores<kNT, true>(dp, g_s, r0, v_t, lane);
      // s * scale + bias, keys j >= S out; dp after dropout.
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1);
          const int j = key0 + n * 8 + 2 * t + (e & 1);
          float v = -INFINITY;
          if (j < S) {
            const float bij =
                kFull ? (i < S ? bias[bh + (size_t)i * S + j] : 0.f) : key_bias[j - key0];
            v = s[n][e] * scale + bij;
            if (drop.active && i < S) {
              dp[n][e] = keep_at(drop, b, h, i, j, NH, S) ? dp[n][e] * drop.inv_keep : 0.f;
            }
          }
          s[n][e] = v;
        }
      }
      if (it < n_tiles) {
        // Sweep A: the online max, sum and sum of exp(s - m) dp.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // Every tile holds a key of finite score: mx is finite.
          const float corr = __expf(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= corr;
          dd[r] *= corr;
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[n][e] - m[e >> 1]);  // exp(-inf) = 0
            l[e >> 1] += p;
            dd[e >> 1] += p * dp[n][e];
          }
        }
      } else {
        // Sweep B: p, ds (-> dbias), ds' = ds / sqrt(HD); dq += ds' K.
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e >> 1);
            const int j = key0 + n * 8 + 2 * t + (e & 1);
            const int r = e >> 1;
            const float p = __expf(s[n][e] - m[r]) / l[r];  // 0 for j >= S
            const float ds = p * (dp[n][e] - dd[r]);
            if (kFull && i < S && j < S) dbias[bh + (size_t)i * S + j] = ds;
            s[n][e] = ds * scale;
          }
        }
        add_tile_pv<kNT>(dq, s, k_t, lane);
      }
    }
    // Every warp is done with this stage before the next tile refills it.
    __syncthreads();
  }
  if (rows) {
    store_acc_rows(dqkv + (size_t)b * S * row3 + (size_t)h * 64, row3, dq, i0, S, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i < S) {
          float* st = stats + (((size_t)b * NH + h) * S + i) * 3;
          st[0] = m[r];
          st[1] = l[r];
          st[2] = dd[r];
        }
      }
    }
  }
}

template <typename T, bool kFull>
__global__ void __launch_bounds__(kTiledThreads)
attention_bwd_cols_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                          const T* __restrict__ grad, T* __restrict__ dqkv,
                          const float* __restrict__ stats, int S, int NH, int col_tiles,
                          float scale, Dropout drop) {
  using namespace mma;
  constexpr int kQ = K2Tile<T>::kRows, kLd = K2Tile<T>::kLd, kNT = kQ / 8;
  constexpr int kStage = k2_stage_bytes<T, 3>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kTiledRows * kLd;
  unsigned char* stages = smem_raw + k2_fixed_bytes<T>();

  const int w = blockIdx.x / col_tiles;  // (b, h)
  const int b = w / NH, h = w % NH;
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % col_tiles) * kTiledRows;
  const int r0 = (tid >> 5) * 16;  // the warp's keys in the block
  const int j0 = col0 + r0;
  const bool rows = j0 < S;  // this warp has a real key
  const int H = NH * 64;
  const size_t row3 = (size_t)3 * H;
  const T* head = qkv + (size_t)b * S * row3 + (size_t)h * 64;
  const size_t bh = ((size_t)b * NH + h) * S * S;
  const float* stats_bh = stats + ((size_t)b * NH + h) * S * 3;
  const int n_tiles = (S + kQ - 1) / kQ;

  // Start the copies of query tile qt: q, g and the rows' m, l, D.
  auto stage_queries = [&](int qt, int buf) {
    const int q0 = qt * kQ, n = min(kQ, S - q0);
    T* q_t = reinterpret_cast<T*>(stages + buf * kStage);
    T* g_t = q_t + kQ * kLd;
    stage_slice(q_t, head + (size_t)q0 * row3, row3, n, kQ, tid);
    stage_slice(g_t, grad + ((size_t)b * S + q0) * H + (size_t)h * 64, H, n, kQ, tid);
    stage_floats(reinterpret_cast<float*>(g_t + kQ * kLd), stats_bh + (size_t)q0 * 3, 3 * n,
                 3 * kQ, tid);
  };
  const int n_k = min(kTiledRows, S - col0);
  stage_slice(k_s, head + (size_t)col0 * row3 + H, row3, n_k, kTiledRows, tid);
  stage_slice(v_s, head + (size_t)col0 * row3 + 2 * H, row3, n_k, kTiledRows, tid);
  stage_queries(0, 0);
  cp_async_commit();
  // The key bias of this lane's keys j0 + g, j0 + g + 8.
  float kb[2] = {0.f, 0.f};
  if (!kFull) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + g + 8 * r;
      if (j < S) kb[r] = bias[(size_t)b * S + j];
    }
  }

  float dk[8][4] = {}, dv[8][4] = {};
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n_tiles) stage_queries(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (rows) {
      const T* q_t = reinterpret_cast<const T*>(stages + buf * kStage);
      const T* g_t = q_t + kQ * kLd;
      const float* st = reinterpret_cast<const float*>(g_t + kQ * kLd);
      const int q0 = qt * kQ;
      // s^T and dp^T: rows = this warp's keys, columns = the tile's queries.
      float s[kNT][4] = {}, dp[kNT][4] = {};
      tile_scores<kNT, false>(s, k_s, r0, q_t, lane);
      tile_scores<kNT, false>(dp, v_s, r0, g_t, lane);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g + 8 * (e >> 1);
          const int c = n * 8 + 2 * t + (e & 1);
          const int i = q0 + c;
          float pd = 0.f, ds = 0.f;
          if (i < S && j < S) {
            const float bij = kFull ? bias[bh + (size_t)i * S + j] : kb[e >> 1];
            const float sc = s[n][e] * scale + bij;  // the first kernel's expression
            const float p = __expf(sc - st[3 * c]) / st[3 * c + 1];
            float dpd = dp[n][e];
            pd = p;
            if (drop.active) {
              const bool keep = keep_at(drop, b, h, i, j, NH, S);
              pd = keep ? p * drop.inv_keep : 0.f;
              dpd = keep ? dpd * drop.inv_keep : 0.f;
            }
            ds = p * (dpd - st[3 * c + 2]);
          }
          s[n][e] = ds * scale;
          dp[n][e] = pd;
        }
      }
      add_tile_pv<kNT>(dv, dp, g_t, lane);
      add_tile_pv<kNT>(dk, s, q_t, lane);
    }
    // Every warp is done with this stage before the next tile refills it.
    __syncthreads();
  }
  if (rows) {
    T* dst = dqkv + (size_t)b * S * row3 + (size_t)h * 64;
    store_acc_rows(dst + H, row3, dk, j0, S, lane);
    store_acc_rows(dst + 2 * H, row3, dv, j0, S, lane);
  }
}

template <typename T, bool kFull>
int launch_tiled(const void* qkv, const void* bias, const void* g, void* dqkv, void* dbias,
                 void* stats, int B, int S, int NH, const Dropout& drop,
                 cudaStream_t stream) {
  auto by_rows = attention_bwd_rows_kernel<T, kFull>;
  auto by_cols = attention_bwd_cols_kernel<T, kFull>;
  // 37.1 and 37.6 KB in bf16, 52.4 and 52.6 KB in float32.
  const int smem_rows = k2_smem_bytes<T, 1>(), smem_cols = k2_smem_bytes<T, 3>();
  cudaError_t err = cudaSuccess;
  if (smem_rows > 48 * 1024) {
    err = cudaFuncSetAttribute(by_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_rows);
  }
  if (err == cudaSuccess && smem_cols > 48 * 1024) {
    err = cudaFuncSetAttribute(by_cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_cols);
  }
  if (err != cudaSuccess) return (int)err;
  // One block a (b, h) and 64 rows (or keys), the tiles of a head next to
  // each other, so that the blocks sharing the streamed slices run together.
  const int tiles = (S + kTiledRows - 1) / kTiledRows;
  const long long blocks = (long long)B * NH * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale = 1.0f / sqrtf(64.0f);
  by_rows<<<(unsigned)blocks, kTiledThreads, smem_rows, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(g),
      static_cast<T*>(dqkv), static_cast<float*>(dbias), static_cast<float*>(stats), S, NH,
      tiles, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  by_cols<<<(unsigned)blocks, kTiledThreads, smem_cols, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(g),
      static_cast<T*>(dqkv), static_cast<const float*>(stats), S, NH, tiles, scale, drop);
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

// The key-tiled route: attention_bwd's arguments and function, for
// float32 or bf16 at 1 <= S <= 1024 (attention_route() sends it
// 256 < S), with stats a (B, NH, S, 3) float32 scratch tensor (each query
// row's softmax max, sum and D, written by the first kernel and read by
// the second); any other dtype or S, or a null stats, is refused with
// cudaErrorInvalidValue, and qkv, g or dqkv not 16-byte aligned with
// cudaErrorMisalignedAddress.  Launches both kernels on the stream.
int attention_bwd_tiled(const void* qkv, const void* bias, const void* g,
                        const void* keep, void* dqkv, void* dbias, void* stats, int B,
                        int S, int NH, int HD, int dtype, int full_bias, int dropout,
                        unsigned int threshold, float inv_keep, unsigned long long seed,
                        void* stream) {
  if (HD != 64 || (dtype != 0 && dtype != 1) || B < 1 || B > 65535 || S < 1 ||
      S > kTiledMaxSeq || NH < 1 || (full_bias && dbias == nullptr) || stats == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned16(qkv) || misaligned16(g) || misaligned16(dqkv)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const Dropout drop{static_cast<const int8_t*>(keep), seed, threshold,
                     inv_keep, dropout != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return full_bias
               ? launch_tiled<float, true>(qkv, bias, g, dqkv, dbias, stats, B, S, NH, drop, st)
               : launch_tiled<float, false>(qkv, bias, g, dqkv, dbias, stats, B, S, NH, drop,
                                            st);
  }
  return full_bias
             ? launch_tiled<bf16, true>(qkv, bias, g, dqkv, dbias, stats, B, S, NH, drop, st)
             : launch_tiled<bf16, false>(qkv, bias, g, dqkv, dbias, stats, B, S, NH, drop, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
