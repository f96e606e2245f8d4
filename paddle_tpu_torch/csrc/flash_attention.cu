// Flash attention forward and backward (fp32) for Hopper, sm_90a.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py ::
//   _flash_forward (kernel _flash_fwd_kernel)          -> flash_fwd_kernel
//   _flash_backward (kernel _flash_bwd_dq_kernel)      -> flash_bwd_dq_kernel
//   _flash_backward (kernel _flash_bwd_dkv_kernel)     -> flash_bwd_dkv_kernel
// in every form: dense, and with the masking inputs of _extra_inputs_specs
// (an additive mask, a per-key bias, segment ids, a block mask), each
// optional and composable with causal.
//
// Layout: q [B, Sq, H, d], k and v [B, Sk, H, d], read and written in place
// with a row stride of H * d floats; lse and delta [B, H, Sq] fp32. Causal
// masking is bottom-right aligned: query row i sees keys j <= i + (Sk - Sq),
// so with Sq > Sk the first rows see no key at all. Any Sq, Sk >= 1 works:
// the tails of the last tiles are bounds-checked, nothing is padded.
//
// Masking (what _tile_scores computes, per (row, key) of a head):
//   s = q.k * scale + mask[b, mh == 1 ? 0 : head, row, key] + kbias[b, key]
// with mask fp32 [B, mh, Sq, Sk] (mh 1 or H) and kbias fp32 [B, Sk], each
// added where given; s = -1e30 where qseg[b, row] != kseg[b, key] (int32
// [B, Sq] and [B, Sk]) or where the causal mask hides the key. The block
// mask, int32 [Sq / bq, Sk / bk], names dead (query, key) blocks at the
// JAX kernel's granularity (bq = min(128, Sq), bk = min(128, Sk)); a tile
// of these kernels (16 to 128 rows, each dividing 128) lies inside one such
// block, so a tile whose block is 0 is skipped whole: its loads and
// products never run, as on the TPU. A null pointer means "absent".
//
// What the three compute (scale applied to the q.k products):
//   forward  o = softmax(s) v with an fp32 online softmax (m, l, acc) over
//            key tiles, lse = m + log(max(l, 1e-30)), o = acc / max(l, 1e-30)
//   dq       dq = scale * sum_k dS K, dS = P * (dO V^T - delta)
//   dk, dv   dv = P^T dO, dk = scale * dS^T Q
// with P recomputed from the lse in both backward kernels. A hard-masked
// score (s <= -5e29) gives p = 0 exactly (the masked-row guard of the
// Pallas kernels): on a row that sees no key, m stays -1e30 and exp(s - m)
// would be 1, so the guard is what makes such rows come out as exact
// zeros, with zero gradient.
//
// What bounds them on the H100: 4 d (forward), 6 d (dq) and 8 d (dk/dv)
// FLOPs per computed (query, key) pair against one read of q, k, v, do,
// the masks, and one write of each output, so at the training shapes
// (s = 512..4096, d = 64..128) the FLOPs are the bound by one to two
// orders of magnitude. The backward kernels form every product at fp32
// accuracy on the tensor cores (3xTF32, below), so their bound is 495 / 3
// = 165 TFLOP/s; they reach 15-20 % of it at the training shapes, held
// back by the operand split's integer instructions and by the latency
// of 8 warps per SM (below), not by the tensor cores. The forward
// still multiplies on the CUDA cores (67 TFLOP/s). The masks add a few
// loads per score (the per-key bias and segment ids stay in L1; a dense
// mask is read once per tile that uses it).
//
// Design: FlashAttention-2's split. The forward and dq kernels run one
// thread block per (batch * head, tile of query rows) and walk the key
// tiles; dk/dv runs one block per (batch * head, tile of keys) and walks
// the query tiles. Every block owns its outputs, so there are no atomics
// and the gradients are deterministic. Causal blocks skip the key (query)
// tiles past their last visible pair and are launched heaviest first;
// block-masked tiles are skipped the same way, loads included. The masks
// are runtime operands of the same instantiations: a tile's scores take
// the masked loop only when a mask, bias or segment ids are given (a
// branch uniform across the block), so the dense forms pay nothing.
//
// Forward: 256 threads as a 16 x 16 grid; each computes a (BR / 16) x
// (BC / 16) piece of the score tile as a register-blocked product (float4
// reads of shared memory, FMAs on CUDA cores) and owns float4 column
// chunks 4 tx + 64 c of its rows' accumulators. BR = BC = 64 for d <= 128
// and 32 for d <= 256; K and V share one buffer, in turn, so two blocks
// fit on an SM. Rows are staged with a padded stride (d + 4 floats).
//
// Backward (dq, and dk/dv), on the tensor cores:
// - Products: mma.sync.m16n8k8 with tf32 operands and fp32 accumulators.
//   Each fp32 operand x splits into big = tf32(x) (rounded to nearest,
//   ties away) and small = tf32(x - big); a product is small*big +
//   big*small + big*big, the small terms first. The dropped small*small
//   and the rounding of small are ~2^-22 relative, so the gradients stay
//   fp32-class (checked against fp64 on the card); one TF32 product would
//   keep ~3 decimal digits. The split is integer arithmetic on the bits.
//   Each k-step's three products are summed from zero and added to the
//   accumulator in fp32 (mma_chunk): the tensor cores' own accumulation
//   does not round to nearest, and summed there over thousands of keys dq
//   would fall far outside its fp64 gate.
// - Warps: 8 warps of 16 rows of the block's own side (BM = 128 query rows
//   for dq, 128 keys for dk/dv; 64 at d <= 256, where WN = 2 warps share
//   16 rows and split the output columns, each computing the scores).
//   A warp's scores are its own: S = Q K^T and dP = dO V^T for dq, S^T =
//   K Q^T and dP^T = V dO^T for dk/dv, in C fragments; the masks, the
//   hard-mask guard (s <= -5e29 -> p = 0) and P = exp(s - lse), dS = P (dP
//   - delta) are applied at each fragment element's own (row, key): row g
//   or g + 8, column 2t or 2t + 1 of each 8-column tile (g = lane / 4,
//   t = lane % 4). The tf32 C fragment is not the A fragment, so P and dS
//   go through a warp-private [16][32] buffer in shared memory (no block
//   barrier) and feed dQ += dS K, dV += P^T dO, dK += dS^T Q.
// - Pipeline: the streamed side (K, V for dq; Q, dO, lse, delta for dk/dv)
//   comes in tiles of BN = 32 rows (16 at d <= 256), double-buffered with
//   cp.async (16-byte copies, zero-filled past Sq / Sk and past d): the
//   next live tile's copy runs under this tile's products. The block's
//   own side is loaded once.
// - Shared memory: rows of ld = d rounded up to 32 floats, 16-byte
//   granules XOR-swizzled with row bits (swz), so both reads are free of
//   bank conflicts: a float4 of 4 columns (operands contracted over d,
//   the contraction index permuted inside each 16-wide chunk to make a
//   lane's A fragments of two k-steps one float4) and a column read down
//   4t + j rows (K in dq; Q and dO in dk/dv, contracted over rows).
//   Budget, (2 BM + 4 BN) ld + 8 x 512 floats (+ 4 BN for lse and delta
//   in dk/dv): 208 KB at d = 128 (one block per SM), 112 KB at d = 64 (two
//   blocks per SM), 208 KB at d = 256.
// - Registers: accumulators of 16 rows x d / WN columns (dq: one set, 64
//   a thread at d = 128; dk/dv: two, 128), plus 2 x 4 BN / 8 for the
//   scores. __launch_bounds__ asks for two blocks per SM (128 registers)
//   at d <= 64 and one above. ptxas (CUDA 12.8): dq 128 / 214 / 176 and
//   dk/dv 128 / 255 / 233 registers at d = 64 / 128 / 256; at d = 64 the
//   cap spills (dk/dv 480 bytes, dq 12), and one block per SM there, with
//   no spill, is slower.
// - What holds them back: every warp splits every operand element it
//   reads (5 integer/FP operations each), the streamed tile once per warp,
//   so a tile's split work is several times its mma count; with 8 warps
//   per SM (registers and shared memory allow no more at d = 128) the
//   latency of load -> split -> mma chains is poorly hidden. Splitting
//   once into big / small planes in shared memory, which wgmma would need
//   too, doubles the tiles and does not fit at d = 128.
// wgmma and TMA are not used: mma.sync keeps the fragments in registers,
// where the masks and the softmax recompute apply element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // forward: a 16 x 16 grid; backward: 8 warps
constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = -5e29f;

template <int MAXD>
struct Tile;
template <>
struct Tile<128> {
  static constexpr int R = 64;  // query rows (BR) and keys (BC) per tile
};
template <>
struct Tile<256> {
  static constexpr int R = 32;
};

// Problem sizes and the optional masking operands, shared by the three
// kernels (a null pointer: that operand is absent).
struct Dims {
  int H, Sq, Sk, d;
  float scale;
  int causal;
  const float* mask;        // [B, mh, Sq, Sk] additive
  int mh;                   // the mask's heads: 1 (shared) or H
  const float* kbias;       // [B, Sk] additive, per key
  const int* qseg;          // [B, Sq]; with kseg [B, Sk]: attend iff equal
  const int* kseg;
  const int* block_mask;    // [Sq / bq, Sk / bk], 0 = dead block
  int bq, bk;               // the block mask's rows and keys per block
};

// Rows [row0, row0 + R) of a [B, S, H, d] tensor (base already at (b, 0,
// head, 0)) into shared memory with row stride ld; rows at or past
// n_valid are zero.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          int row0, int n_valid, int d,
                                          int ld, int64_t row_stride) {
  const int d4 = d >> 2;
  for (int idx = threadIdx.x; idx < R * d4; idx += kThreads) {
    const int r = idx / d4, c = idx - r * d4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      val = reinterpret_cast<const float4*>(
          base + (int64_t)(row0 + r) * row_stride)[c];
    }
    reinterpret_cast<float4*>(dst + r * ld)[c] = val;
  }
}

// acc[i][j] = sum_c A[ty + 16 i][c] * B[tx + 16 j][c], A and B in shared
// memory with row stride ld.
template <int RM, int RN>
__device__ __forceinline__ void gemm_nt(float (&acc)[RM][RN], const float* A,
                                        const float* B, int ld, int d,
                                        int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }
  for (int c = 0; c < d; c += 4) {
    float4 a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + c);
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + c);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][c] += sum_k P[ty + 16 i][k] * X[k][4 tx + 64 c .. + 3] over k < n
// (n a multiple of 4), P with row stride ldp, X with row stride ld; the
// column chunks at or past d are left alone.
template <int RM, int NC>
__device__ __forceinline__ void gemm_nn(float4 (&acc)[RM][NC], const float* P,
                                        int ldp, const float* X, int ld,
                                        int n, int d, int ty, int tx) {
  for (int k = 0; k < n; k += 4) {
    float4 p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * ldp + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < d) {
          const float4 x =
              *reinterpret_cast<const float4*>(X + (k + kk) * ld + col);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float pk = kk == 0 ? p[i].x
                           : kk == 1 ? p[i].y
                           : kk == 2 ? p[i].z : p[i].w;
            acc[i][c].x = fmaf(pk, x.x, acc[i][c].x);
            acc[i][c].y = fmaf(pk, x.y, acc[i][c].y);
            acc[i][c].z = fmaf(pk, x.z, acc[i][c].z);
            acc[i][c].w = fmaf(pk, x.w, acc[i][c].w);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float max16(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v;
}

__device__ __forceinline__ bool visible(int row, int key, const Dims& dm) {
  return row < dm.Sq && key < dm.Sk &&
         (!dm.causal || key <= row + (dm.Sk - dm.Sq));
}

// The score of (row, key) of batch b, head `head` from its raw q.k product,
// as _tile_scores computes it: s * scale, plus the mask and the per-key bias
// where given; kNegInf where the pair is out of range, hidden by the causal
// mask or crosses segments. Out-of-range pairs read no mask.
__device__ __forceinline__ float masked_score(float s, int b, int head,
                                              int row, int key,
                                              const Dims& dm) {
  if (!visible(row, key, dm)) return kNegInf;
  float v = s * dm.scale;
  if (dm.mask) {
    const int mhead = dm.mh == 1 ? 0 : head;
    v += __ldg(dm.mask + (((int64_t)b * dm.mh + mhead) * dm.Sq + row) *
                             dm.Sk + key);
  }
  if (dm.kbias) v += __ldg(dm.kbias + (int64_t)b * dm.Sk + key);
  if (dm.qseg && __ldg(dm.qseg + (int64_t)b * dm.Sq + row) !=
                     __ldg(dm.kseg + (int64_t)b * dm.Sk + key)) {
    v = kNegInf;
  }
  return v;
}

// A thread's RM x RM scores in place, from their raw q.k products: s[i][j]
// is (row0 + 16 i, key0 + 16 j). MASKED reads the masks (masked_score);
// otherwise only the causal and range checks apply.
template <bool MASKED, int RM>
__device__ __forceinline__ void scores_of(float (&s)[RM][RM], int b,
                                          int head, int row0, int key0,
                                          const Dims& dm) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int row = row0 + 16 * i, key = key0 + 16 * j;
      s[i][j] = MASKED ? masked_score(s[i][j], b, head, row, key, dm)
                       : visible(row, key, dm) ? s[i][j] * dm.scale
                                               : kNegInf;
    }
  }
}

// scores_of on a branch uniform across the block, so the dense forms run
// the unmasked loop and pay nothing for the masks.
template <int RM>
__device__ __forceinline__ void tile_scores(float (&s)[RM][RM], int b,
                                            int head, int row0, int key0,
                                            const Dims& dm) {
  if (dm.mask || dm.kbias || dm.qseg) {
    scores_of<true>(s, b, head, row0, key0, dm);
  } else {
    scores_of<false>(s, b, head, row0, key0, dm);
  }
}

// Whether the tile of rows from q0 and keys from k0 lies in a live block of
// the block mask (always, without one). The tile lies inside one block.
__device__ __forceinline__ bool tile_live(int q0, int k0, const Dims& dm) {
  if (!dm.block_mask) return true;
  const int nbk = dm.Sk / dm.bk;
  return __ldg(dm.block_mask + (q0 / dm.bq) * nbk + k0 / dm.bk) != 0;
}

// Keys a query tile [q0, q0 + R) needs: all of them, or under the causal
// mask those up to its last live row's last visible key.
__device__ __forceinline__ int key_end(int q0, int R, const Dims& dm) {
  if (!dm.causal) return dm.Sk;
  const int last_row = min(q0 + R, dm.Sq) - 1;
  return max(0, min(dm.Sk, last_row + (dm.Sk - dm.Sq) + 1));
}

__device__ __forceinline__ void scale4(float4& a, float s) {
  a.x *= s; a.y *= s; a.z *= s; a.w *= s;
}

// Write row `row` of a [B, S, H, d] output from this thread's column
// chunks, each multiplied by mul.
template <int NC>
__device__ __forceinline__ void store_row(float* base, int64_t row_stride,
                                          int row, const float4 (&acc)[NC],
                                          float mul, int d, int tx) {
  float4* dst = reinterpret_cast<float4*>(base + (int64_t)row * row_stride);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = 4 * tx + 64 * c;
    if (col < d) {
      float4 v = acc[c];
      scale4(v, mul);
      dst[col >> 2] = v;
    }
  }
}

// ------------------------------------------------------------ forward

template <int MAXD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Dims dm) {
  constexpr int R = Tile<MAXD>::R, RM = R / 16, NC = MAXD / 64;
  constexpr int ldp = R + 16;   // rows of a warp's two halves: other banks
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = dm.d, ld = d + 4;
  float* qs = smem;             // [R][ld]
  float* kvs = qs + R * ld;     // [R][ld], K then V of each key tile
  float* ps = kvs + R * ld;     // [R][ldp]

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;   // heaviest tile first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t rs = (int64_t)dm.H * d;
  const float* qb = q + ((int64_t)b * dm.Sq * dm.H + head) * d;
  const float* kb = k + ((int64_t)b * dm.Sk * dm.H + head) * d;
  const float* vb = v + ((int64_t)b * dm.Sk * dm.H + head) * d;

  load_rows<R>(qs, qb, q0, dm.Sq - q0, d, ld, rs);
  float m[RM], l[RM];
  float4 acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int kend = key_end(q0, R, dm);
  for (int k0 = 0; k0 < kend; k0 += R) {
    if (!tile_live(q0, k0, dm)) continue;   // uniform across the block
    __syncthreads();   // V and P of the previous tile are consumed
    load_rows<R>(kvs, kb, k0, dm.Sk - k0, d, ld, rs);
    __syncthreads();
    float s[RM][RM];
    gemm_nt<RM, RM>(s, qs, kvs, ld, d, ty, tx);
    __syncthreads();   // K is consumed: V takes its place
    load_rows<R>(kvs, vb, k0, dm.Sk - k0, d, ld, rs);
    tile_scores(s, b, head, q0 + ty, k0 + tx, dm);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RM; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], max16(mx));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const float p = s[i][j] <= kMaskedBelow ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        rsum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) scale4(acc[i][c], corr);
    }
    __syncthreads();
    gemm_nn<RM, NC>(acc, ps, ldp, kvs, ld, R, d, ty, tx);
  }

  float* ob = o + ((int64_t)b * dm.Sq * dm.H + head) * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < dm.Sq) {
      const float den = fmaxf(l[i], 1e-30f);
      store_row<NC>(ob, rs, row, acc[i], 1.f / den, d, tx);
      if (tx == 0) lse[(int64_t)bh * dm.Sq + row] = m[i] + logf(den);
    }
  }
}

// ------------------------------------------- backward: tensor-core pieces

// The backward kernels' tiles: BM rows of the block's own side (query rows
// for dq, keys for dk/dv) in warps of 16 rows, BN rows of the streamed side
// per pipeline stage, and WN warps sharing each 16 rows, each owning
// MAXD / WN output columns. Every length divides 128, so a tile lies
// inside one block of the JAX kernel's grid (tile_live).
template <int MAXD>
struct Bwd;
template <>
struct Bwd<64> {
  static constexpr int BM = 128, BN = 32, WN = 1, kMinBlocks = 2;
};
template <>
struct Bwd<128> {
  static constexpr int BM = 128, BN = 32, WN = 1, kMinBlocks = 1;
};
template <>
struct Bwd<256> {
  static constexpr int BM = 64, BN = 16, WN = 2, kMinBlocks = 1;
};
// Row stride of a warp's P / dS buffer [16][BN] (a multiple of 32, for
// the swizzle)
template <int BN>
struct Pw {
  static constexpr int ld = BN < 32 ? 32 : BN;
};

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
// added to c by an fp32 add, so a long sum (dQ over every key, dK and dV
// over every query row) is rounded to nearest every 8 terms rather than
// accumulated inside the tensor cores throughout, and the two k-steps are
// independent chains of three mma.
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

// The A fragments of two k-steps from a float4 of rows g and g + 8. The
// contraction index is permuted inside each 16-wide chunk (fragment
// column t of step s is column 4t + 2s, column t + 4 is 4t + 2s + 1), so a
// lane's four columns are one float4; the B fragments follow the same
// permutation, which leaves the sum unchanged.
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

// c[i] = X[m0 .. m0 + 16) Y[n0 + 8 i .. + 8)^T over the first d columns
// (the tiles zero past d up to a multiple of 16), for a warp's lane (g, t).
// The chunk loop is unrolled by two, not whole: the registers a whole
// unroll takes cost more than its scheduling freedom gains.
template <int NT, int MAXD>
__device__ __forceinline__ void mma_xyt(float (&c)[NT][4], const float* X,
                                        int m0, const float* Y, int n0,
                                        int ld, int d, int g, int t) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < MAXD; kc += 16) {
    if (kc < d) {
      uint32_t ab[2][4], as[2][4];
      split_a(*reinterpret_cast<const float4*>(X + swz(m0 + g, kc + 4 * t, ld)),
              *reinterpret_cast<const float4*>(
                  X + swz(m0 + g + 8, kc + 4 * t, ld)),
              ab, as);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float4 y = *reinterpret_cast<const float4*>(
            Y + swz(n0 + 8 * i + g, kc + 4 * t, ld));
        uint32_t bb[2][2], bs[2][2];
        split(y.x, bb[0][0], bs[0][0]);
        split(y.y, bb[0][1], bs[0][1]);
        split(y.z, bb[1][0], bs[1][0]);
        split(y.w, bb[1][1], bs[1][1]);
        mma_chunk(c[i], ab, as, bb, bs);
      }
    }
  }
}

// acc[j] += pw Y[:, c0 + 8 j .. + 8) for the output columns below d: pw is
// a warp's [16][BN] buffer (row stride Pw<BN>::ld, swizzled), Y a tile of
// BN rows contracted over its rows.
template <int NTO, int BN>
__device__ __forceinline__ void mma_py(float (&acc)[NTO][4], const float* pw,
                                       const float* Y, int c0, int ld, int d,
                                       int g, int t) {
#pragma unroll
  for (int kc = 0; kc < BN; kc += 16) {
    uint32_t ab[2][4], as[2][4];
    constexpr int pld = Pw<BN>::ld;
    split_a(*reinterpret_cast<const float4*>(pw + swz(g, kc + 4 * t, pld)),
            *reinterpret_cast<const float4*>(
                pw + swz(g + 8, kc + 4 * t, pld)),
            ab, as);
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
      if (c0 + 8 * j < d) {
        const int col = c0 + 8 * j + g;
        uint32_t bb[2][2], bs[2][2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          split(Y[swz(kc + 4 * t + 2 * s, col, ld)], bb[s][0], bs[s][0]);
          split(Y[swz(kc + 4 * t + 2 * s + 1, col, ld)], bb[s][1], bs[s][1]);
        }
        mma_chunk(acc[j], ab, as, bb, bs);
      }
    }
  }
}

// A warp's 16 x 8 NT accumulators into its buffer pw: c[i][r] is (row
// g + 8 (r >> 1), column 8 i + 2 t + (r & 1)).
template <int NT>
__device__ __forceinline__ void store_pw(float* pw, const float (&c)[NT][4],
                                         int g, int t) {
  constexpr int pld = Pw<8 * NT>::ld;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    *reinterpret_cast<float2*>(pw + swz(g, 8 * i + 2 * t, pld)) =
        make_float2(c[i][0], c[i][1]);
    *reinterpret_cast<float2*>(pw + swz(g + 8, 8 * i + 2 * t, pld)) =
        make_float2(c[i][2], c[i][3]);
  }
}

// Scores in fragment coordinates, in place from the raw products:
// c[i][r] is (m, n) = (mb + 8 (r >> 1), nb + 8 i + (r & 1)) with mb =
// m0 + g, nb = n0 + 2 t; (row, key) = (m, n), or (n, m) when TRANSPOSED.
template <bool MASKED, bool TRANSPOSED, int NT>
__device__ __forceinline__ void frag_scores_of(float (&c)[NT][4], int b,
                                               int head, int mb, int nb,
                                               const Dims& dm) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = mb + 8 * (r >> 1), n = nb + 8 * i + (r & 1);
      const int row = TRANSPOSED ? n : m, key = TRANSPOSED ? m : n;
      c[i][r] = MASKED ? masked_score(c[i][r], b, head, row, key, dm)
                : visible(row, key, dm) ? c[i][r] * dm.scale
                                        : kNegInf;
    }
  }
}

// frag_scores_of on a branch uniform across the block, so the dense forms
// pay nothing for the masks.
template <bool TRANSPOSED, int NT>
__device__ __forceinline__ void frag_scores(float (&c)[NT][4], int b,
                                            int head, int mb, int nb,
                                            const Dims& dm) {
  if (dm.mask || dm.kbias || dm.qseg) {
    frag_scores_of<true, TRANSPOSED>(c, b, head, mb, nb, dm);
  } else {
    frag_scores_of<false, TRANSPOSED>(c, b, head, mb, nb, dm);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + R) of a [B, S, H, d] tensor (base at
// (b, 0, head, 0)) into a swizzled tile: columns up to d rounded to 16, the
// ones past d and rows at or past n_valid zero-filled.
template <int R, int NTHR>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int row0, int n_valid, int d,
                                          int ld, int64_t row_stride) {
  const int gpr = ((d + 15) & ~15) >> 2;   // granules per row
  for (int idx = threadIdx.x; idx < R * gpr; idx += NTHR) {
    const int r = idx / gpr, c = 4 * (idx - r * gpr);
    const bool valid = r < n_valid && c < d;
    cp_async16(dst + swz(r, c, ld),
               valid ? base + (int64_t)(row0 + r) * row_stride + c : base,
               valid);
  }
}

// The first key tile at or after k0 (a multiple of BN) below kend whose
// block is live for the query rows from q0.
template <int BN>
__device__ __forceinline__ int live_key_tile(int q0, int k0, int kend,
                                             const Dims& dm) {
  while (k0 < kend && !tile_live(q0, k0, dm)) k0 += BN;
  return k0;
}

// The first query tile at or after q0 whose block is live for the keys
// from k0.
template <int BN>
__device__ __forceinline__ int live_query_tile(int q0, int k0,
                                               const Dims& dm) {
  while (q0 < dm.Sq && !tile_live(q0, k0, dm)) q0 += BN;
  return q0;
}

// A warp's accumulators of rows row0 + g, + 8 and columns c0 + 8 j + 2 t
// into a [B, S, H, d] output (base at (b, 0, head, 0)), rows below n_rows.
template <int NTO>
__device__ __forceinline__ void store_frags(float* base, int64_t row_stride,
                                            const float (&acc)[NTO][4],
                                            int row0, int n_rows, int c0,
                                            int d, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < n_rows) {
      float* dst = base + (int64_t)row * row_stride;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        if (col < d) {
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- dq

template <int MAXD>
__global__ void __launch_bounds__(kThreads, Bwd<MAXD>::kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Dims dm) {
  constexpr int BM = Bwd<MAXD>::BM, BN = Bwd<MAXD>::BN, WN = Bwd<MAXD>::WN;
  constexpr int NTHR = kThreads, WM = BM / 16;
  static_assert(32 * WM * WN == NTHR, "a warp for each 16 rows and WN");
  constexpr int NT = BN / 8, NTO = MAXD / WN / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = dm.d, ld = tile_ld(d);
  float* qs = smem;              // [BM][ld]
  float* dos = qs + BM * ld;     // [BM][ld]
  float* ks = dos + BM * ld;     // [2][BN][ld], stages
  float* vs = ks + 2 * BN * ld;  // [2][BN][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM);
  const int c0 = WN == 1 ? 0 : (warp / WM) * (MAXD / WN);
  // this warp's dS [16][BN]
  float* pw = vs + 2 * BN * ld + warp * 16 * Pw<BN>::ld;

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tile first
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;

  const int kend = key_end(q0, BM, dm);
  int k0 = live_key_tile<BN>(q0, 0, kend, dm);
  load_tile<BM, NTHR>(qs, q + qoff, q0, dm.Sq - q0, d, ld, rs);
  load_tile<BM, NTHR>(dos, dout + qoff, q0, dm.Sq - q0, d, ld, rs);
  if (k0 < kend) {
    load_tile<BN, NTHR>(ks, k + koff, k0, dm.Sk - k0, d, ld, rs);
    load_tile<BN, NTHR>(vs, v + koff, k0, dm.Sk - k0, d, ld, rs);
  }
  cp_async_commit();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    row_lse[h] = row < dm.Sq ? lse[(int64_t)bh * dm.Sq + row] : 0.f;
    row_delta[h] = row < dm.Sq ? delta[(int64_t)bh * dm.Sq + row] : 0.f;
  }
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int stage = 0; k0 < kend; stage ^= 1) {
    // start the next live tile's copy into the other stage, then wait for
    // this one's
    const int kn = live_key_tile<BN>(q0, k0 + BN, kend, dm);
    if (kn < kend) {
      const int o = (stage ^ 1) * BN * ld;
      load_tile<BN, NTHR>(ks + o, k + koff, kn, dm.Sk - kn, d, ld, rs);
      load_tile<BN, NTHR>(vs + o, v + koff, kn, dm.Sk - kn, d, ld, rs);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + stage * BN * ld;
    const float* vt = vs + stage * BN * ld;
    float s[NT][4], dp[NT][4];
    mma_xyt<NT, MAXD>(s, qs, m0, kt, 0, ld, d, g, t);
    mma_xyt<NT, MAXD>(dp, dos, m0, vt, 0, ld, d, g, t);
    frag_scores<false>(s, b, head, q0 + m0 + g, k0 + 2 * t, dm);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sv = s[i][r];
        const float p = sv <= kMaskedBelow ? 0.f : expf(sv - row_lse[r >> 1]);
        dp[i][r] = dm.scale * (p * (dp[i][r] - row_delta[r >> 1]));
      }
    }
    store_pw<NT>(pw, dp, g, t);
    __syncwarp();
    mma_py<NTO, BN>(acc, pw, kt, c0, ld, d, g, t);
    __syncthreads();   // this stage is consumed before it is refilled
    k0 = kn;
  }
  cp_async_wait<0>();
  store_frags<NTO>(dq + qoff, rs, acc, q0 + m0, dm.Sq, c0, d, g, t);
}

// ------------------------------------------------------------- dk, dv

template <int MAXD>
__global__ void __launch_bounds__(kThreads, Bwd<MAXD>::kMinBlocks)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     Dims dm) {
  constexpr int BM = Bwd<MAXD>::BM, BN = Bwd<MAXD>::BN, WN = Bwd<MAXD>::WN;
  constexpr int NTHR = kThreads, WM = BM / 16;
  static_assert(32 * WM * WN == NTHR, "a warp for each 16 rows and WN");
  constexpr int NT = BN / 8, NTO = MAXD / WN / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = dm.d, ld = tile_ld(d);
  float* ks = smem;                // [BM][ld], this block's keys
  float* vs = ks + BM * ld;        // [BM][ld]
  float* qs = vs + BM * ld;        // [2][BN][ld], stages of query rows
  float* dos = qs + 2 * BN * ld;   // [2][BN][ld]
  float* pws = dos + 2 * BN * ld;  // [warps][16][BN]: P^T, then dS^T
  float* lse_s = pws + (NTHR / 32) * 16 * Pw<BN>::ld;   // [2][BN]
  float* delta_s = lse_s + 2 * BN;          // [2][BN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM);
  const int c0 = WN == 1 ? 0 : (warp / WM) * (MAXD / WN);
  float* pw = pws + warp * 16 * Pw<BN>::ld;

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int k0 = blockIdx.y * BM;   // the first key tiles see the most rows
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;
  const float* lse_b = lse + (int64_t)bh * dm.Sq;
  const float* delta_b = delta + (int64_t)bh * dm.Sq;

  // under the causal mask, rows before k0 - (Sk - Sq) see none of these
  // keys (the other masks only hide more)
  int qstart = 0;
  if (dm.causal) qstart = max(0, k0 - (dm.Sk - dm.Sq)) / BN * BN;
  int q0 = live_query_tile<BN>(qstart, k0, dm);

  // the query rows of tile q1 into stage st: Q, dO, lse and delta
  auto load_rows_of = [&](int q1, int st) {
    const int o = st * BN * ld;
    load_tile<BN, NTHR>(qs + o, q + qoff, q1, dm.Sq - q1, d, ld, rs);
    load_tile<BN, NTHR>(dos + o, dout + qoff, q1, dm.Sq - q1, d, ld, rs);
    for (int r = threadIdx.x; r < BN; r += NTHR) {
      const bool valid = q1 + r < dm.Sq;
      cp_async4(lse_s + st * BN + r, valid ? lse_b + q1 + r : lse_b, valid);
      cp_async4(delta_s + st * BN + r, valid ? delta_b + q1 + r : delta_b,
                valid);
    }
  };
  load_tile<BM, NTHR>(ks, k + koff, k0, dm.Sk - k0, d, ld, rs);
  load_tile<BM, NTHR>(vs, v + koff, k0, dm.Sk - k0, d, ld, rs);
  if (q0 < dm.Sq) load_rows_of(q0, 0);
  cp_async_commit();

  float dk_acc[NTO][4], dv_acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[j][r] = dv_acc[j][r] = 0.f;
  }

  for (int stage = 0; q0 < dm.Sq; stage ^= 1) {
    const int qn = live_query_tile<BN>(q0 + BN, k0, dm);
    if (qn < dm.Sq) load_rows_of(qn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qt = qs + stage * BN * ld;
    const float* dot = dos + stage * BN * ld;
    const float* lse_t = lse_s + stage * BN;
    const float* delta_t = delta_s + stage * BN;
    // transposed scores: rows are this block's keys, columns the queries
    float st[NT][4], dpt[NT][4];
    mma_xyt<NT, MAXD>(st, ks, m0, qt, 0, ld, d, g, t);
    mma_xyt<NT, MAXD>(dpt, vs, m0, dot, 0, ld, d, g, t);
    frag_scores<true>(st, b, head, k0 + m0 + g, q0 + 2 * t, dm);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 8 * i + 2 * t + (r & 1);
        const float sv = st[i][r];
        const float p = sv <= kMaskedBelow ? 0.f : expf(sv - lse_t[n]);
        st[i][r] = p;
        dpt[i][r] = dm.scale * (p * (dpt[i][r] - delta_t[n]));
      }
    }
    store_pw<NT>(pw, st, g, t);
    __syncwarp();
    mma_py<NTO, BN>(dv_acc, pw, dot, c0, ld, d, g, t);
    __syncwarp();   // P^T is consumed: dS^T takes its place
    store_pw<NT>(pw, dpt, g, t);
    __syncwarp();
    mma_py<NTO, BN>(dk_acc, pw, qt, c0, ld, d, g, t);
    __syncthreads();   // this stage is consumed before it is refilled
    q0 = qn;
  }
  cp_async_wait<0>();
  store_frags<NTO>(dk + koff, rs, dk_acc, k0 + m0, dm.Sk, c0, d, g, t);
  store_frags<NTO>(dv + koff, rs, dv_acc, k0 + m0, dm.Sk, c0, d, g, t);
}

// ----------------------------------------------------------- launches

// Above 48 KiB a kernel needs the opt-in attribute; it is set on the
// instantiation being launched, on the current device, before each launch
// that needs it.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MAXD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int B, const Dims& dm,
                       cudaStream_t st) {
  constexpr int R = Tile<MAXD>::R;
  // the Q and K/V tiles (row stride d + 4) and P (row stride R + 16)
  const size_t smem =
      sizeof(float) * ((size_t)2 * R * (dm.d + 4) + (size_t)R * (R + 16));
  cudaError_t err = opt_in(flash_fwd_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + R - 1) / R);
  flash_fwd_kernel<MAXD><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, dm);
  return cudaGetLastError();
}

// Shared memory of a backward kernel: two tiles of BM rows, two stages of
// two BN-row tiles, the warps' P / dS buffers and `extra` floats.
template <int MAXD>
size_t bwd_bytes(int d, int extra) {
  constexpr int BM = Bwd<MAXD>::BM, BN = Bwd<MAXD>::BN;
  return sizeof(float) * ((size_t)(2 * BM + 4 * BN) * tile_ld(d) +
                          (size_t)(kThreads / 32) * 16 * Pw<BN>::ld + extra);
}

template <int MAXD>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int B, const Dims& dm, cudaStream_t st) {
  constexpr int BM = Bwd<MAXD>::BM;
  const size_t smem = bwd_bytes<MAXD>(dm.d, 0);
  cudaError_t err = opt_in(flash_bwd_dq_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + BM - 1) / BM);
  flash_bwd_dq_kernel<MAXD><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, dm);
  return cudaGetLastError();
}

template <int MAXD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int B,
                       const Dims& dm, cudaStream_t st) {
  constexpr int BM = Bwd<MAXD>::BM;
  const size_t smem = bwd_bytes<MAXD>(dm.d, 4 * Bwd<MAXD>::BN);
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sk + BM - 1) / BM);
  flash_bwd_dkv_kernel<MAXD><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, dm);
  return cudaGetLastError();
}

// The shapes every entry point takes (the grid's y extent is at most
// 65535 tiles), and the masking operands' sizes: mh is 1 or H with a mask;
// with a block mask the blocks tile both lengths and each is 128 long or
// the whole length (so every kernel tile lies inside one block); segment
// ids come in pairs.
bool shapes_ok(const Dims& dm, int B) {
  const int d = dm.d;
  if (B < 0 || dm.H <= 0 || dm.Sq < 0 || dm.Sk < 0) return false;
  if (d <= 0 || d % 8 != 0 || d > 256) return false;
  const int R = d <= 128 ? Tile<128>::R : Tile<256>::R;
  const int64_t tiles = ((int64_t)(dm.Sq > dm.Sk ? dm.Sq : dm.Sk) + R - 1) / R;
  if (tiles > 65535 || (int64_t)B * dm.H > 0x7fffffff) return false;
  if (dm.mask && dm.mh != 1 && dm.mh != dm.H) return false;
  if ((dm.qseg == nullptr) != (dm.kseg == nullptr)) return false;
  if (dm.block_mask) {
    if (dm.bq <= 0 || dm.bk <= 0 || dm.Sq % dm.bq || dm.Sk % dm.bk)
      return false;
    if ((dm.bq != 128 && dm.bq != dm.Sq) || (dm.bk != 128 && dm.bk != dm.Sk))
      return false;
  }
  return true;
}

Dims make_dims(int H, int Sq, int Sk, int d, float scale, int causal,
               const void* mask, int mh, const void* kbias, const void* qseg,
               const void* kseg, const void* block_mask, int bq, int bk) {
  return Dims{H, Sq, Sk, d, scale, causal,
              static_cast<const float*>(mask), mh,
              static_cast<const float*>(kbias),
              static_cast<const int*>(qseg), static_cast<const int*>(kseg),
              static_cast<const int*>(block_mask), bq, bk};
}

}  // namespace

// Every entry point takes the five masking operands (null = absent) after
// its tensors, then the sizes: mh is the mask's head count (1 or H), bq and
// bk the block mask's block lengths.

extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* mask, const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  const Dims dm = make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias,
                            qseg, kseg, block_mask, bq, bk);
  if (!shapes_ok(dm, B)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (Sk == 0) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 128) return (int)launch_fwd<128>(qf, kf, vf, of, lf, B, dm, st);
  return (int)launch_fwd<256>(qf, kf, vf, of, lf, B, dm, st);
}

extern "C" int flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* mask,
    const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  const Dims dm = make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias,
                            qseg, kseg, block_mask, bq, bk);
  if (!shapes_ok(dm, B)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (Sk == 0) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* ef = static_cast<const float*>(delta);
  float* gf = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64) {
    return (int)launch_dq<64>(qf, kf, vf, df, lf, ef, gf, B, dm, st);
  }
  if (d <= 128) {
    return (int)launch_dq<128>(qf, kf, vf, df, lf, ef, gf, B, dm, st);
  }
  return (int)launch_dq<256>(qf, kf, vf, df, lf, ef, gf, B, dm, st);
}

extern "C" int flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* mask,
    const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  const Dims dm = make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias,
                            qseg, kseg, block_mask, bq, bk);
  if (!shapes_ok(dm, B)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sk == 0) return (int)cudaSuccess;
  if (Sq == 0) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* ef = static_cast<const float*>(delta);
  float* kg = static_cast<float*>(dk);
  float* vg = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64) {
    return (int)launch_dkv<64>(qf, kf, vf, df, lf, ef, kg, vg, B, dm, st);
  }
  if (d <= 128) {
    return (int)launch_dkv<128>(qf, kf, vf, df, lf, ef, kg, vg, B, dm, st);
  }
  return (int)launch_dkv<256>(qf, kf, vf, df, lf, ef, kg, vg, B, dm, st);
}
