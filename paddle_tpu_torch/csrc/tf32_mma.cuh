// fp32-accurate products on Hopper's tensor cores (3xTF32), the staged
// tile layout they read and the cp.async copies that fill it: the pieces
// shared by the flash-attention kernels (flash_attention.cu) and the
// ragged paged-attention span form (ragged_paged_attention.cu).
//
// Products: mma.sync.m16n8k8 with tf32 operands and fp32 accumulators.
// Each fp32 operand x splits into big = tf32(x) (rounded to nearest, ties
// away) and small = tf32(x - big); a product is small*big + big*small +
// big*big, the small terms first. The dropped small*small and the rounding
// of small are ~2^-22 relative, so the results stay fp32-class (checked
// against fp64 on the card); one TF32 product would keep ~3 decimal digits.
// The split is integer arithmetic on the bits. An operand that is exact in
// tf32 (an int8 code, an e4m3 value) has small = 0, and its products need
// only two mma (mma_chunk2). Each k-step's products are summed from zero
// and added to the accumulator in fp32 (mma_chunk): the tensor cores' own
// accumulation does not round to nearest, and summed there over thousands
// of terms a long contraction would fall far outside its fp64 gate.
//
// Fragments (lane = 4 g + t, g < 8, t < 4): A (16 x 8, row major) holds
// rows g and g + 8 at columns t and t + 4; B (8 x 8, column major) holds
// rows (the contraction index) t and t + 4 at column g; C (16 x 8) holds
// row g, then g + 8, each at columns 2 t and 2 t + 1. The C fragment is
// not the A fragment, so a result that feeds another product (P, dS) goes
// through a warp-private shared buffer. Inside each 16-wide chunk of the
// contraction the index is permuted (fragment column t of step s is column
// 4 t + 2 s, column t + 4 is 4 t + 2 s + 1), so that a lane's A fragments
// of two k-steps are one float4; the B fragments follow the same
// permutation, which leaves the sum unchanged.
//
// Staged tiles: rows of ld = d rounded up to 32 floats (tile_ld), 16-byte
// granules XOR-swizzled with row bits (swz), so both reads the products
// make are free of bank conflicts: a float4 of 4 columns (an operand
// contracted over its columns) and a column read down rows 4 t + j (an
// operand contracted over its rows). A tile of operands split once holds
// two such planes of uint32 (big, small) in the same layout.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// scores at or below this are hard-masked: p = 0 exactly
constexpr float kMaskedBelow = -5e29f;

// Row stride of a staged tile: d rounded up to a 32-float (128-byte) line,
// the period of the swizzle below.
__host__ __device__ __forceinline__ int tile_ld(int d) {
  return (d + 31) & ~31;
}

// Float offset of (r, c) in a tile of row stride ld. The 16-byte granule
// c / 4 is XOR-ed with bits of r (within its 128-byte line) so that both
// reads the products make are free of bank conflicts: a float4 of 4
// consecutive columns at rows {2j, 2j + 1} (an operand contracted over
// the columns: rows 2j and 2j + 1 fill the two halves of the banks), and
// one float at column c0 + g of rows k0 + 4t + j for g < 8, t < 4 (an
// operand contracted over its rows: t spreads the granules over all eight).
__device__ __forceinline__ int swz(int r, int c, int ld) {
  const int f = (((r >> 2) & 3) << 1) ^ ((r & 1) << 2);
  return r * ld + ((((c >> 2) ^ f)) << 2) + (c & 3);
}

// Round to nearest (ties away from zero) at tf32's 10 mantissa bits: the
// bit pattern of the tf32 value, its low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split: x = big + small + O(2^-22 |x|), both tf32. (Veltkamp's
// split in fp32 operations was no faster on the card and, with small left
// unrounded, twice as far from fp64 in dq.)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at fp32 accuracy from split operands: the two small products
// first, then big * big; small * small (~2^-22 relative) is dropped.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// c += a 16-deep chunk's product (two k-steps) at fp32 accuracy: each
// k-step's three products are summed on the tensor cores from zero and
// added to c by an fp32 add, so a long sum is rounded to nearest every 8
// terms rather than accumulated inside the tensor cores throughout, and
// the two k-steps are independent chains of three mma.
__device__ __forceinline__ void mma_chunk(float (&c)[4],
                                          const uint32_t (&ab)[2][4],
                                          const uint32_t (&as)[2][4],
                                          const uint32_t (&bb)[2][2],
                                          const uint32_t (&bs)[2][2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(p, ab[s], as[s], bb[s], bs[s]);
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] += p[r];
  }
}

// The ragged span form's chunk product: as mma_chunk, but each of a
// k-step's products is formed from zero and the three are summed in fp32,
// rounded to nearest. The tensor cores cut a sum toward zero where it outgrows
// their precision; chained there, the cut lands on the running sum and
// shrinks a softmax-weighted average by a few 1e-8 of its size more than
// fp32 rounding does (chip_smoke.py reports the mean signed error), which
// a model's next int8 or fp8 page write turns into code flips of one sign.
// Unchained, the products of 1-byte values are exact sums and carry no cut.
__device__ __forceinline__ void mma_chunk_rn(float (&c)[4],
                                             const uint32_t (&ab)[2][4],
                                             const uint32_t (&as)[2][4],
                                             const uint32_t (&bb)[2][2],
                                             const uint32_t (&bs)[2][2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
    float p2[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(p0, as[s], bb[s]);
    mma_tf32(p1, ab[s], bs[s]);
    mma_tf32(p2, ab[s], bb[s]);
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] += p2[r] + (p0[r] + p1[r]);
  }
}

// mma_chunk_rn for a B operand that is exact in tf32 (its small half is
// 0): small_a b + big_a b, two mma a k-step.
__device__ __forceinline__ void mma_chunk2(float (&c)[4],
                                           const uint32_t (&ab)[2][4],
                                           const uint32_t (&as)[2][4],
                                           const uint32_t (&b)[2][2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(p0, as[s], b[s]);
    mma_tf32(p1, ab[s], b[s]);
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] += p1[r] + p0[r];
  }
}

// The A fragments of two k-steps from a float4 of rows g and g + 8 (the
// permuted contraction index: a lane's four columns are one float4).
__device__ __forceinline__ void split_a(const float4& lo, const float4& hi,
                                        uint32_t (&ab)[2][4],
                                        uint32_t (&as)[2][4]) {
  split(lo.x, ab[0][0], as[0][0]);
  split(hi.x, ab[0][1], as[0][1]);
  split(lo.y, ab[0][2], as[0][2]);
  split(hi.y, ab[0][3], as[0][3]);
  split(lo.z, ab[1][0], as[1][0]);
  split(hi.z, ab[1][1], as[1][1]);
  split(lo.w, ab[1][2], as[1][2]);
  split(hi.w, ab[1][3], as[1][3]);
}

// One plane's A fragments of two k-steps from a uint4 of rows g and g + 8.
__device__ __forceinline__ void frag_a(const uint4& lo, const uint4& hi,
                                       uint32_t (&a)[2][4]) {
  a[0][0] = lo.x; a[0][1] = hi.x; a[0][2] = lo.y; a[0][3] = hi.y;
  a[1][0] = lo.z; a[1][1] = hi.z; a[1][2] = lo.w; a[1][3] = hi.w;
}

// The A fragments of rows m0 + g and m0 + g + 8, columns kc + 4 t .. + 3,
// from a tile split once into planes big and small (row stride ld).
__device__ __forceinline__ void planes_a(const uint32_t* big,
                                         const uint32_t* small, int m0,
                                         int kc, int ld, int g, int t,
                                         uint32_t (&ab)[2][4],
                                         uint32_t (&as)[2][4]) {
  const int lo = swz(m0 + g, kc + 4 * t, ld);
  const int hi = swz(m0 + g + 8, kc + 4 * t, ld);
  frag_a(*reinterpret_cast<const uint4*>(big + lo),
         *reinterpret_cast<const uint4*>(big + hi), ab);
  frag_a(*reinterpret_cast<const uint4*>(small + lo),
         *reinterpret_cast<const uint4*>(small + hi), as);
}

// Split a float4 of columns c .. c + 3 of row r into the planes.
__device__ __forceinline__ void store_split4(uint32_t* big, uint32_t* small,
                                             int r, int c, int ld,
                                             const float4& v) {
  uint4 b, s;
  split(v.x, b.x, s.x);
  split(v.y, b.y, s.y);
  split(v.z, b.z, s.z);
  split(v.w, b.w, s.w);
  const int o = swz(r, c, ld);
  *reinterpret_cast<uint4*>(big + o) = b;
  *reinterpret_cast<uint4*>(small + o) = s;
}

// ----------------------------------------- streamed tiles split once

// The forward kernels (flash_fwd_kernel, the ragged span form) split each
// streamed K / V tile once, with the whole block, into planes: K in its
// own layout ([BN][ld], swizzled), V transposed ([ld][vld]: its rows are
// d's columns, its columns the keys, permuted by vt_col). Every warp then
// reads its B fragments as float4s of the planes, with no split in the
// products. Operands exact in tf32 (1-byte codes) fill the big plane only.
// P stays in registers: a warp's S C fragment of one 8-key n-tile is the
// A fragment of those keys under the contraction permutation vt_col
// encodes.

// Column of key k of a tile in a transposed plane: in each 16-key chunk,
// key 8 h + 2 t + e goes to 4 t + 2 h + e, so a lane's B fragments of the
// chunk's two k-steps (h = 0, 1: C n-tiles 2 m and 2 m + 1) are one float4.
__device__ __forceinline__ int vt_col(int k) {
  return (k & ~15) | ((k & 6) << 1) | ((k & 8) >> 2) | (k & 1);
}

// Offset of (r, c) in a transposed plane of row stride vld: 32, swizzled
// as swz; 16, two rows to a 128-byte line, whose float4 reads of rows
// {2j, 2j + 1} are free of conflicts as they are.
__device__ __forceinline__ int vt_off(int r, int c, int vld) {
  return vld >= 32 ? swz(r, c, vld) : r * vld + c;
}

// Rows [0, R) x columns [0, w) of a staged tile into K planes (row stride
// ld, swizzled), by the NTHR threads numbered tid: src(r, c) is the float4
// of columns c .. c + 3 of row r; SPLIT splits it, otherwise it is exact
// in tf32 and fills the big plane.
template <int NTHR, bool SPLIT, typename Src>
__device__ __forceinline__ void planes_k(uint32_t* big, uint32_t* small,
                                         int R, int w, int ld, int tid,
                                         Src src) {
  const int gpr = w >> 2;
  for (int idx = tid; idx < R * gpr; idx += NTHR) {
    const int r = idx / gpr, c = 4 * (idx - r * gpr);
    const float4 v = src(r, c);
    if constexpr (SPLIT) {
      store_split4(big, small, r, c, ld, v);
    } else {
      *reinterpret_cast<float4*>(big + swz(r, c, ld)) = v;
    }
  }
}

// The same into transposed planes (row stride vld): row r's columns c ..
// c + 3 go to rows c .. c + 3 at column vt_col(r). Consecutive threads take
// consecutive rows, so a warp's stores fall in distinct banks.
template <int NTHR, bool SPLIT, typename Src>
__device__ __forceinline__ void planes_vt(uint32_t* big, uint32_t* small,
                                          int R, int w, int vld, int tid,
                                          Src src) {
  for (int idx = tid; idx < R * (w >> 2); idx += NTHR) {
    const int cg = idx / R, r = idx - cg * R, c = 4 * cg;
    const float4 v = src(r, c);
    const float e[4] = {v.x, v.y, v.z, v.w};
    const int col = vt_col(r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = vt_off(c + i, col, vld);
      if constexpr (SPLIT) {
        split(e[i], big[o], small[o]);
      } else {
        big[o] = __float_as_uint(e[i]);
      }
    }
  }
}

// c[i] = Q[m0 .. m0 + 16) K[8 i .. 8 i + 8)^T over the first d columns
// (the planes zero past d up to a multiple of 16), for a warp's lane (g,
// t): Q and K from planes (K's small plane read when SPLIT_K); RN sums a
// k-step's three products in fp32 (mma_chunk_rn), else in the tensor
// cores (mma_chunk). The chunk loop is unrolled by two, not whole: the
// registers a whole unroll takes cost more than its scheduling freedom
// gains.
template <int NT, int MAXD, bool SPLIT_K, bool RN>
__device__ __forceinline__ void mma_qk(float (&c)[NT][4], const uint32_t* qb,
                                       const uint32_t* qs, int m0,
                                       const uint32_t* kb,
                                       const uint32_t* ks, int ld, int d,
                                       int g, int t) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < MAXD; kc += 16) {
    if (kc < d) {
      uint32_t ab[2][4], as[2][4];
      planes_a(qb, qs, m0, kc, ld, g, t, ab, as);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int o = swz(8 * i + g, kc + 4 * t, ld);
        const uint4 yb = *reinterpret_cast<const uint4*>(kb + o);
        const uint32_t bb[2][2] = {{yb.x, yb.y}, {yb.z, yb.w}};
        if constexpr (SPLIT_K) {
          const uint4 ys = *reinterpret_cast<const uint4*>(ks + o);
          const uint32_t bs[2][2] = {{ys.x, ys.y}, {ys.z, ys.w}};
          if constexpr (RN) {
            mma_chunk_rn(c[i], ab, as, bb, bs);
          } else {
            mma_chunk(c[i], ab, as, bb, bs);
          }
        } else {
          mma_chunk2(c[i], ab, as, bb);
        }
      }
    }
  }
}

// acc[j] += P V[:, c0 + 8 j .. + 8) over the tile's 8 NT keys, for the
// output columns below d: P in the warp's C fragments p (rows g, g + 8;
// n-tile i holds keys 8 i + 2 t, + 1), split here; V from transposed
// planes (its small plane read when SPLIT_V); RN as for mma_qk.
template <int NT, int NTO, bool SPLIT_V, bool RN>
__device__ __forceinline__ void mma_pv(float (&acc)[NTO][4],
                                       const float (&p)[NT][4],
                                       const uint32_t* vb,
                                       const uint32_t* vs, int c0, int vld,
                                       int d, int g, int t) {
  static_assert(NT % 2 == 0, "whole 16-key chunks");
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // key 2 t is fragment column t, key 2 t + 1 column t + 4
      split(p[2 * m + h][0], ab[h][0], as[h][0]);
      split(p[2 * m + h][2], ab[h][1], as[h][1]);
      split(p[2 * m + h][1], ab[h][2], as[h][2]);
      split(p[2 * m + h][3], ab[h][3], as[h][3]);
    }
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
      if (c0 + 8 * j < d) {
        const int o = vt_off(c0 + 8 * j + g, 16 * m + 4 * t, vld);
        const uint4 yb = *reinterpret_cast<const uint4*>(vb + o);
        const uint32_t bb[2][2] = {{yb.x, yb.y}, {yb.z, yb.w}};
        if constexpr (SPLIT_V) {
          const uint4 ys = *reinterpret_cast<const uint4*>(vs + o);
          const uint32_t bs[2][2] = {{ys.x, ys.y}, {ys.z, ys.w}};
          if constexpr (RN) {
            mma_chunk_rn(acc[j], ab, as, bb, bs);
          } else {
            mma_chunk(acc[j], ab, as, bb, bs);
          }
        } else {
          mma_chunk2(acc[j], ab, as, bb);
        }
      }
    }
  }
}

// One tile of the online softmax on a warp's scores s (rows g: h = 0, and
// g + 8: h = 1; hard-masked scores give p = 0 exactly): m[h] is the
// running max, l[h] this lane's partial sum (reduced across the quad at
// the end); s becomes p and acc is rescaled to the new max.
template <int NT, int NTO>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[NTO][4]) {
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      mx = fmaxf(mx, fmaxf(s[i][2 * h], s[i][2 * h + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    corr[h] = expf(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sv = s[i][r];
      const float p = sv <= kMaskedBelow ? 0.f : expf(sv - m[r >> 1]);
      s[i][r] = p;
      l[r >> 1] += p;
    }
  }
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] *= corr[r >> 1];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies global -> shared of 16, 8 or 4 bytes; a copy that
// is not valid reads nothing and zero-fills its destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
