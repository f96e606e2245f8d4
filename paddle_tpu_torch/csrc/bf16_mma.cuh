// bf16 products on Hopper's tensor cores for the flash kernels' bf16
// instantiations (flash_attention.cu): the mma, the fragments read from
// staged bf16 tiles with ldmatrix, and the two-term split of an fp32
// operand held in registers.
//
// Products: mma.sync.m16n8k16 with bf16 operands and fp32 accumulators.
// A product of two bf16 values is exact in fp32, so where both operands
// are bf16 tensors (Q K^T, dO V^T and their transposes) one mma per
// 16-deep k-step computes what the JAX kernel's upcast-then-fp32 dot does.
// Where one operand is an fp32 value in registers (P or dS, against V, K,
// dO or Q), it is split into hi = bf16(x) and lo = bf16(x - hi), and the
// k-step is two mma, lo first: hi + lo is x within ~2^-17 |x|, so the
// products keep the JAX kernel's fp32 P to well below the bf16 rounding
// of the outputs. Each k-step's products are summed from zero and added to
// the accumulator in fp32, as the tf32 kernels do (tf32_mma.cuh): the
// tensor cores' own accumulation does not round to nearest.
//
// Fragments (lane = 4 g + t): A (16 x 16, row major) holds rows g and
// g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9 (registers a0: row g, a1:
// row g + 8, a2: row g, columns + 8, a3: row g + 8, columns + 8); B (16 x
// 8, column major) holds rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of
// column g; C (16 x 8) rows g and g + 8 at columns 2t, 2t + 1. So the C
// fragments of two neighbouring 8-column tiles are, as they are, the A
// fragment of a 16-deep k-step over those columns: P and dS feed their
// products from registers, with no trip through shared memory.
//
// Staged tiles: rows of bf_ld(d) = d rounded up to 16, plus 8 elements,
// so consecutive rows start 16 bytes apart in the banks and the eight
// 16-byte rows an ldmatrix phase reads fall in distinct banks. A tile is
// read with ldmatrix along its rows (an operand contracted over its
// columns) and with ldmatrix.trans down its rows (contracted over rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// Row stride, in bf16 elements, of a staged tile.
__host__ __device__ __forceinline__ int bf_ld(int d) {
  return ((d + 15) & ~15) + 8;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b for one k-step, the product summed from zero and added in fp32.
__device__ __forceinline__ void mma_step(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p, a, b);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += p[r];
}

// c += (hi + lo) b for one k-step, from a split A operand: lo b first,
// then hi b on top of it, the two summed from zero and added in fp32.
__device__ __forceinline__ void mma_step2(float (&c)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const uint32_t (&b)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p, lo, b);
  mma_bf16(p, hi, b);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += p[r];
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows m0 .. m0 + 16, columns kc .. kc + 16 of a tile X
// (row stride ld): lanes 0-15 address the rows at column kc, lanes 16-31
// the same rows at kc + 8.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* X,
                                       int m0, int kc, int ld, int lane) {
  ldsm_x4(a, X + (m0 + (lane & 15)) * ld + kc + ((lane >> 4) << 3));
}

// The B fragments of a k-step kc .. kc + 16 for the 8-column tiles n0 and
// n0 + 8 of a product with Y^T, Y stored [n][k] (a tile contracted over
// its columns: K for Q K^T, V for dO V^T, Q and dO for the transposed
// scores of dk/dv). Matrices in order (n0, kc), (n0, kc + 8), (n0 + 8,
// kc), (n0 + 8, kc + 8).
__device__ __forceinline__ void frag_b_rows(uint32_t (&b0)[2],
                                            uint32_t (&b1)[2],
                                            const uint16_t* Y, int n0,
                                            int kc, int ld, int lane) {
  const int mi = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, Y + (n0 + (lane & 7) + ((mi >> 1) << 3)) * ld + kc +
                 ((mi & 1) << 3));
  b0[0] = r[0]; b0[1] = r[1];
  b1[0] = r[2]; b1[1] = r[3];
}

// The B fragments of a k-step k0 .. k0 + 16 for the 8-column tiles n0 and
// n0 + 8 of a product with Z, Z stored [k][n] (a tile contracted over its
// rows: V for P V, K for dS K, dO and Q for dk/dv), read transposed.
// Matrices in order (k0, n0), (k0 + 8, n0), (k0, n0 + 8), (k0 + 8, n0 + 8).
__device__ __forceinline__ void frag_b_cols(uint32_t (&b0)[2],
                                            uint32_t (&b1)[2],
                                            const uint16_t* Z, int k0,
                                            int n0, int ld, int lane) {
  const int mi = lane >> 3;
  uint32_t r[4];
  ldsm_x4_trans(r, Z + (k0 + (lane & 7) + ((mi & 1) << 3)) * ld + n0 +
                       ((mi >> 1) << 3));
  b0[0] = r[0]; b0[1] = r[1];
  b1[0] = r[2]; b1[1] = r[3];
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values rounded to nearest as a bf16 pair (x0 in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// The two-term split of a pair: hi = bf16(x), lo = bf16(x - hi) (x - hi
// is exact in fp32).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The split A fragments of the k-step over columns 16 m .. 16 m + 16 of a
// warp's C fragments c (n-tiles 2m and 2m + 1: P or dS in registers).
template <int NT>
__device__ __forceinline__ void split_frag_a(const float (&c)[NT][4], int m,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_bf16(c[2 * m][0], c[2 * m][1], hi[0], lo[0]);
  split_bf16(c[2 * m][2], c[2 * m][3], hi[1], lo[1]);
  split_bf16(c[2 * m + 1][0], c[2 * m + 1][1], hi[2], lo[2]);
  split_bf16(c[2 * m + 1][2], c[2 * m + 1][3], hi[3], lo[3]);
}

// c[i] = X[m0 .. m0 + 16) Y[8 i .. 8 i + 8)^T over the first d columns
// (both tiles zero past d up to a multiple of 16), X and Y bf16 tiles
// contracted over their columns: one mma per k-step.
template <int NT, int MAXD>
__device__ __forceinline__ void mma_xyt_bf16(float (&c)[NT][4],
                                             const uint16_t* X, int m0,
                                             const uint16_t* Y, int ld,
                                             int d, int lane) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < MAXD; kc += 16) {
    if (kc < d) {
      uint32_t a[4];
      frag_a(a, X, m0, kc, ld, lane);
#pragma unroll
      for (int i = 0; i < NT; i += 2) {
        uint32_t b0[2], b1[2];
        frag_b_rows(b0, b1, Y, 8 * i, kc, ld, lane);
        mma_step(c[i], a, b0);
        mma_step(c[i + 1], a, b1);
      }
    }
  }
}

// acc[j] += C Z[:, c0 + 8 j .. + 8) over the 8 NT columns of a warp's C
// fragments c (fp32, split in two terms), Z a bf16 tile of 8 NT rows
// contracted over its rows, for the output columns below d.
template <int NT, int NTO>
__device__ __forceinline__ void mma_cz_bf16(float (&acc)[NTO][4],
                                            const float (&c)[NT][4],
                                            const uint16_t* Z, int c0,
                                            int ld, int d, int lane) {
  static_assert(NT % 2 == 0 && NTO % 2 == 0, "tiles in pairs");
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    uint32_t hi[4], lo[4];
    split_frag_a(c, m, hi, lo);
#pragma unroll
    for (int j = 0; j < NTO; j += 2) {
      if (c0 + 8 * j < d) {
        uint32_t b0[2], b1[2];
        frag_b_cols(b0, b1, Z, 16 * m, c0 + 8 * j, ld, lane);
        mma_step2(acc[j], hi, lo, b0);
        mma_step2(acc[j + 1], hi, lo, b1);
      }
    }
  }
}

}  // namespace
