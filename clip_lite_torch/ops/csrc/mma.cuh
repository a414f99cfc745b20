// Tensor-core building blocks of the attention kernels (the bf16
// tensor-core routes of K1 and K2, K1's float32 3xTF32 route): 16-byte
// cp.async staging, ldmatrix fragment loads, the mma.sync m16n8k16 bf16
// product and the m16n8k8 TF32 product with fp32 accumulation, and the
// TF32 split of an fp32 operand, all as inline PTX so that nvcc builds in
// seconds.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 16, row major), four .b32 registers of two bf16 each:
//     a0 = A[g][2t, 2t+1]    a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]  a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col": B[k][n]), two registers:
//     b0 = B[2t, 2t+1][g]    b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, fp32), four floats:
//     c0, c1 = C[g][2t, 2t+1]    c2, c3 = C[g+8][2t, 2t+1]
// The lower half of a .b32 register holds the element of the lower
// column (A) or row (B) index.
//
// Two 8-column accumulator tiles C_n, C_{n+1} of a 16-row product are the
// A fragment of the next product's 16-deep chunk, once rounded to bf16:
// a0 = (C_n c0, c1), a1 = (C_n c2, c3), a2 = (C_{n+1} c0, c1),
// a3 = (C_{n+1} c2, c3) -- see accum_to_a().
//
// Staged tiles are row-major bf16 in shared memory with a row stride of
// 16 bytes more than a multiple of 128 (kRow below: 72 elements, 144
// bytes), so the eight 16-byte rows that one ldmatrix phase reads fall in
// eight different groups of four banks: no bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// Elements per staged row of a 64-wide head slice: 64 + 8 of padding.
constexpr int kRow = 72;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// 4 bytes from device memory to shared memory (through L1).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// Wait for every cp.async this thread started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Close this thread's group of cp.async copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, and register m of each lane receives row g, columns 2t, 2t+1
// of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: register m receives rows 2t, 2t+1, column g of
// matrix m.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += A B over one 16 x 8 x 16 tile, bf16 products summed in fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- 3xTF32 (the float32 tensor-core route of K1) -----------------------
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 fragments (PTX ISA,
// "Matrix Fragments for mma.m16n8k8", .tf32), g = lane / 4, t = lane % 4:
//   A (16 x 8):  a0 = A[g][t]  a1 = A[g+8][t]  a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8):   b0 = B[t][g]  b1 = B[t+4][g]
//   C, D:        as m16n8k16's (c0, c1 = C[g][2t, 2t+1], c2, c3 = row g+8).
// A TF32 operand is an fp32 bit pattern whose low 13 mantissa bits are 0.

// x rounded to TF32: to nearest, ties away from zero (cvt.rna), low 13
// bits zero.
__device__ __forceinline__ void cvt_tf32(uint32_t& r, float x) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
}

// x = big + small + O(2^-22 |x|): big is x in TF32, small the rest of it
// in TF32 (x - big is exact in fp32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  cvt_tf32(big, x);
  cvt_tf32(small, __fsub_rn(x, __uint_as_float(big)));
}

// c += A B over one 16 x 8 x 8 tile of TF32 operands, summed in fp32.
// Not volatile: it has no effect but its result, so the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += A B with fp32 operands given split (big, small), to about
// fp32's accuracy: small.big + big.small first, then big.big (small.small,
// 2^-22 of a product, is left out).
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

// Two fp32 values rounded to nearest bf16, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows 0..n-1 of a 64-wide bf16 slice (row stride ld elements in
// device memory, every row 16-byte aligned) into a tile of row stride kRow
// with cp.async, and zero rows n..n_pad-1; the block's threads (tid of
// nthreads) share the 16-byte pieces.  The caller waits with
// cp_async_wait_all() and a barrier.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                           size_t ld, int n, int n_pad, int tid,
                                           int nthreads) {
  for (int c = tid; c < n_pad * 8; c += nthreads) {
    const int r = c >> 3;
    __nv_bfloat16* dst = tile + r * kRow + (c & 7) * 8;
    if (r < n) {
      cp_async16(dst, src + r * ld + (c & 7) * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Write rows 0..n-1 of a staged tile back to a 64-wide slice of device
// memory (row stride ld), 16 bytes a store.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t ld,
                                           const __nv_bfloat16* tile, int n, int tid,
                                           int nthreads) {
  for (int c = tid; c < n * 8; c += nthreads) {
    const int r = c >> 3;
    *reinterpret_cast<uint4*>(dst + r * ld + (c & 7) * 8) =
        *reinterpret_cast<const uint4*>(tile + r * kRow + (c & 7) * 8);
  }
}

// Write a warp's 16 x 64 fp32 accumulator (eight 8-column tiles), rounded
// to bf16, into rows r0..r0+15 of a staged tile.
__device__ __forceinline__ void accum_to_tile(__nv_bfloat16* tile, int r0,
                                              const float (&c)[8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + (r0 + g) * kRow + n * 8 + 2 * t) =
        pack_bf16(c[n][0], c[n][1]);
    *reinterpret_cast<uint32_t*>(tile + (r0 + g + 8) * kRow + n * 8 + 2 * t) =
        pack_bf16(c[n][2], c[n][3]);
  }
}

// The A fragment of 16-deep chunk kc from accumulator tiles 2kc, 2kc+1.
template <int kTiles>
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4], const float (&c)[kTiles][4],
                                           int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Row addresses for ldmatrix_x4 of the A fragment of rows r0..r0+15,
// columns c0..c0+15 of a row-major tile with row stride ld.
__device__ __forceinline__ const __nv_bfloat16* a_rows(const __nv_bfloat16* tile, int ld,
                                                       int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

// Row addresses for ldmatrix_x4 of the B fragments of two n-tiles when B
// is stored transposed (B[k][n] = T[n][k], T row-major): rows n0..n0+15,
// depth k0..k0+15.  Registers 0, 1 are (b0, b1) of n-tile n0, registers
// 2, 3 those of n-tile n0 + 8.
__device__ __forceinline__ const __nv_bfloat16* bt_rows(const __nv_bfloat16* tile, int ld,
                                                        int n0, int k0, int lane) {
  const int m = lane >> 3;
  return tile + (n0 + (lane & 7) + (m >> 1) * 8) * ld + k0 + (m & 1) * 8;
}

// Row addresses for ldmatrix_x4_trans of the B fragments of two n-tiles
// when B is stored as it is (B[k][n] = T[k][n], T row-major): depth
// k0..k0+15, columns n0..n0+15.  Registers as bt_rows'.
__device__ __forceinline__ const __nv_bfloat16* b_rows(const __nv_bfloat16* tile, int ld,
                                                       int k0, int n0, int lane) {
  const int m = lane >> 3;
  return tile + (k0 + (lane & 7) + (m & 1) * 8) * ld + n0 + (m >> 1) * 8;
}

// Row addresses for ldmatrix_x4_trans of the A fragment of T^T (T
// row-major, stored as it is): rows of T^T (columns of T) n0..n0+15,
// depth (rows of T) k0..k0+15.
__device__ __forceinline__ const __nv_bfloat16* at_rows(const __nv_bfloat16* tile, int ld,
                                                        int k0, int n0, int lane) {
  const int m = lane >> 3;
  return tile + (k0 + (lane & 7) + (m >> 1) * 8) * ld + n0 + (m & 1) * 8;
}

}  // namespace mma
