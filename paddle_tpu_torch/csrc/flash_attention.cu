// Flash attention forward and backward (fp32, and bf16 and fp16 for AMP)
// for Hopper, sm_90a.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py ::
//   _flash_forward (kernel _flash_fwd_kernel)          -> flash_fwd_kernel
//   _flash_backward (kernel _flash_bwd_dq_kernel)      -> flash_bwd_dq_kernel
//   _flash_backward (kernel _flash_bwd_dkv_kernel)     -> flash_bwd_dkv_kernel
// in every form: dense, and with the masking inputs of _extra_inputs_specs
// (an additive mask, a per-key bias, segment ids, a block mask), each
// optional and composable with causal. At bf16 and fp16 (AMP) all three
// kernels for d <= 128 run on wgmma with TMA rings
// (flash_attention_wgmma.cu); the 16-bit entry points at the end of this
// file choose between those kernels and this file's by d. What both
// sources share (Dims, the masks at each fragment element, the causal and
// block-mask walks, the 16-bit store, fp16's range) is flash_common.cuh.
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
//            (the fp32 kernel sums lse's l a second time in fp64, below)
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
// orders of magnitude. All three kernels form every product at fp32
// accuracy on the tensor cores (3xTF32, tf32_mma.cuh), so their bound is
// 495 / 3 = 165 TFLOP/s, which assumes wgmma's rate; they reach 12-21 %
// of it at the training shapes, held back by mma.sync's tf32 rate and the
// latency of 8 warps per SM (below) more than by the operand split.
// The masks add a few loads per score (the per-key bias and segment ids
// stay in L1; a dense mask is read once per tile that uses it).
//
// Design: FlashAttention-2's split. The forward and dq kernels run one
// thread block per (batch * head, tile of query rows) and walk the key
// tiles; dk/dv runs one block per (batch * head, tile of keys) and walks
// the query tiles. Every block owns its outputs, so there are no atomics
// and the gradients are deterministic. Causal blocks skip the key (query)
// tiles past their last visible pair and are launched heaviest first;
// block-masked tiles are skipped the same way, loads included. The masks
// are runtime operands of the same instantiations: a tile's scores take
// the masked path only when a mask, bias or segment ids are given (a
// branch uniform across the block), so the dense forms pay nothing.
//
// All three kernels, on the tensor cores (products, fragments and the
// swizzled tile layout: tf32_mma.cuh):
// - Warps: 8 warps of 16 rows of the block's own side (BM = 128 query rows
//   for the forward and dq, 128 keys for dk/dv; 64 at d <= 256, where
//   WN = 2 warps share 16 rows and split the output columns, each
//   computing the scores). A warp's scores are its own: S = Q K^T (and
//   dP = dO V^T for dq), S^T = K Q^T and dP^T = V dO^T for dk/dv, in C
//   fragments; the masks, the hard-mask guard (s <= -5e29 -> p = 0), the
//   forward's online softmax and the backward's P = exp(s - lse), dS =
//   P (dP - delta) are applied at each fragment element's own (row, key):
//   row g or g + 8, column 2t or 2t + 1 of each 8-column tile (g = lane /
//   4, t = lane % 4).
// - Forward: Q, its only own-side tile, is split once into big / small
//   planes. Each K / V tile is copied with cp.async into a staging buffer
//   while the block multiplies the tile before, then split once by the
//   whole block into K planes and transposed V planes, so the products
//   read every operand as float4s of planes and split nothing. P stays in
//   registers: the S C fragment is P's A fragment for O += P V. The online
//   softmax keeps the max and the sum of rows g and g + 8 in the fragment
//   rows, the tile's max reduced across the four lanes of a quad, the sum
//   a per-lane partial until the end. Shared memory, (2 BM + 6 BN) ld
//   floats: 224 KB at d = 128 and 256 (one block per SM), 112 KB at d = 64
//   (two).
// - Backward: P and dS go through a warp-private [16][32] buffer in shared
//   memory (no block barrier) and feed dQ += dS K, dV += P^T dO, dK +=
//   dS^T Q. The streamed side (K, V for dq; Q, dO, lse, delta for dk/dv)
//   comes in tiles of BN = 32 rows (16 at d <= 256), double-buffered with
//   cp.async (16-byte copies, zero-filled past Sq / Sk and past d): the
//   next live tile's copy runs under this tile's products. The block's own
//   side is loaded once. Shared memory, rows of ld = d rounded up to 32
//   floats, swizzled (swz), read as a float4 of 4 columns (operands
//   contracted over d) and as a column down 4t + j rows (K in dq; Q and dO
//   in dk/dv, contracted over rows): (2 BM + 4 BN) ld + 8 x 512 floats
//   (+ 4 BN for lse and delta in dk/dv), 208 KB at d = 128 (one block per
//   SM), 112 KB at d = 64 (two blocks per SM), 208 KB at d = 256.
// - Registers: accumulators of 16 rows x d / WN columns (forward and dq:
//   one set, 64 a thread at d = 128; dk/dv: two, 128), plus 2 x 4 BN / 8
//   for the scores. __launch_bounds__ asks for two blocks per SM (128
//   registers) at d <= 64 and one above. ptxas (CUDA 12.8), backward: dq
//   128 / 214 / 176 and dk/dv 128 / 255 / 233 registers at d = 64 / 128 /
//   256; at d = 64 the cap spills (dk/dv 480 bytes, dq 12), and one block
//   per SM there, with no spill, is slower.
// - What holds them back: the forward at the Llama shape took 5.15-5.34
//   ms whether K and V were split in every warp or once in the block, and
//   with a k-step's products summed in the tensor cores or in fp32
//   (tools/torch_kernel_ab.py on each variant), so its split is not what
//   bounds it; mma.sync's tf32 rate and the latency of 8 warps per SM
//   are. The backward's every warp splits every operand element it
//   reads; splitting its own-side tiles once, as the forward does, needs
//   two planes for each of two tiles and does not fit at d = 128.
// - bf16 and fp16 operands (AMP): the 16-bit instantiations at the end of
//   this file, the same walk with 16-bit tiles and mma (bf16_mma.cuh), for
//   128 < d <= 256 (below, the wgmma kernels of
//   flash_attention_wgmma.cu).
// This file uses neither wgmma nor TMA: mma.sync keeps the fragments in
// registers, where the masks and the softmax apply element by element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "flash_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel

// The tiles of all three kernels: BM rows of the block's own side (query
// rows for the forward and dq, keys for dk/dv) in warps of 16 rows, BN
// rows of the streamed side per pipeline stage, and WN warps sharing each
// 16 rows, each owning MAXD / WN output columns. Every length divides 128,
// so a tile lies inside one block of the JAX kernel's grid (tile_live).
template <int MAXD>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int BM = 128, BN = 32, WN = 1, kMinBlocks = 2;
};
template <>
struct Tiles<128> {
  static constexpr int BM = 128, BN = 32, WN = 1, kMinBlocks = 1;
};
template <>
struct Tiles<256> {
  static constexpr int BM = 64, BN = 16, WN = 2, kMinBlocks = 1;
};

// Row stride of a warp's P / dS buffer [16][BN] (a multiple of 32, for
// the swizzle)
template <int BN>
struct Pw {
  static constexpr int ld = BN < 32 ? 32 : BN;
};

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

// ------------------------------------------------------------ forward

// Rows [row0, row0 + R) of a [B, S, H, d] tensor (base at (b, 0, head,
// 0)) split into the planes big and small of a swizzled tile: columns up
// to d rounded to 16, the ones past d and rows at or past n_valid zero.
template <int R, int NTHR>
__device__ __forceinline__ void split_rows(uint32_t* big, uint32_t* small,
                                           const float* base, int row0,
                                           int n_valid, int d, int ld,
                                           int64_t row_stride) {
  const int gpr = ((d + 15) & ~15) >> 2;   // granules per row
  for (int idx = threadIdx.x; idx < R * gpr; idx += NTHR) {
    const int r = idx / gpr, c = 4 * (idx - r * gpr);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && c < d) {
      val = __ldg(reinterpret_cast<const float4*>(
          base + (int64_t)(row0 + r) * row_stride + c));
    }
    store_split4(big, small, r, c, ld, val);
  }
}

// The fp32 forward's lse denominator, summed in fp64 beside the fp32 l that
// divides o: each tile's p (the fp32 values online_softmax made of s) is
// added to l64 after l64 is rescaled by exp(m_old - m) in fp64. The fp32 l
// takes a rounding at every add and an expf rounding at every rescale, a
// few fp32 ulp of lse over 4096 keys (the plain version sums its row in a
// tree, 1-2 ulp); l64 takes none that reach fp32, so lse = m + log(l64)
// rounds once. o keeps the fp32 l, which shares acc's rescales exactly.
template <int NT>
__device__ __forceinline__ void lse_sum(const float (&p)[NT][4],
                                        const float (&m_old)[2],
                                        const float (&m)[2],
                                        double (&l64)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (m_old[h] != m[h]) l64[h] *= exp((double)m_old[h] - (double)m[h]);
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) l64[r >> 1] += (double)p[i][r];
  }
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, Tiles<MAXD>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Dims dm) {
  constexpr int BM = Tiles<MAXD>::BM, BN = Tiles<MAXD>::BN;
  constexpr int WN = Tiles<MAXD>::WN;
  constexpr int NTHR = kThreads, WM = BM / 16;
  static_assert(32 * WM * WN == NTHR, "a warp for each 16 rows and WN");
  constexpr int NT = BN / 8, NTO = MAXD / WN / 8, VLD = BN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = dm.d, ld = tile_ld(d), w = (d + 15) & ~15;
  uint32_t* qbig = reinterpret_cast<uint32_t*>(smem);   // [BM][ld]
  uint32_t* qsmall = qbig + BM * ld;                    // [BM][ld]
  float* kraw = smem + 2 * BM * ld;   // [BN][ld], the staged tiles
  float* vraw = kraw + BN * ld;       // [BN][ld]
  uint32_t* kbig = reinterpret_cast<uint32_t*>(vraw + BN * ld);  // [BN][ld]
  uint32_t* ksmall = kbig + BN * ld;                             // [BN][ld]
  uint32_t* vbig = ksmall + BN * ld;    // [ld][VLD], V transposed
  uint32_t* vsmall = vbig + ld * VLD;   // [ld][VLD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM);
  const int c0 = WN == 1 ? 0 : (warp / WM) * (MAXD / WN);

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tile first
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;

  const int kend = key_end(q0, BM, dm);
  int k0 = live_key_tile<BN>(q0, 0, kend, dm);
  if (k0 < kend) {
    load_tile<BN, NTHR>(kraw, k + koff, k0, dm.Sk - k0, d, ld, rs);
    load_tile<BN, NTHR>(vraw, v + koff, k0, dm.Sk - k0, d, ld, rs);
  }
  cp_async_commit();
  // Q is split once, under the first tile's copy
  split_rows<BM, NTHR>(qbig, qsmall, q + qoff, q0, dm.Sq - q0, d, ld, rs);

  // rows g (h = 0) and g + 8 (h = 1): running max, this lane's partial sum
  // (and lse's, in fp64: lse_sum)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  double l64[2] = {0.0, 0.0};
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  while (k0 < kend) {
    cp_async_wait<0>();
    __syncthreads();   // the tile is staged; every warp is done with planes
    planes_k<NTHR, true>(kbig, ksmall, BN, w, ld, threadIdx.x,
                         [&](int r, int c) {
      return *reinterpret_cast<const float4*>(kraw + swz(r, c, ld));
    });
    planes_vt<NTHR, true>(vbig, vsmall, BN, w, VLD, threadIdx.x,
                          [&](int r, int c) {
      return *reinterpret_cast<const float4*>(vraw + swz(r, c, ld));
    });
    __syncthreads();   // the planes are ready, the staging buffer is free
    // the next live tile's copy runs under this tile's products
    const int kn = live_key_tile<BN>(q0, k0 + BN, kend, dm);
    if (kn < kend) {
      load_tile<BN, NTHR>(kraw, k + koff, kn, dm.Sk - kn, d, ld, rs);
      load_tile<BN, NTHR>(vraw, v + koff, kn, dm.Sk - kn, d, ld, rs);
    }
    cp_async_commit();
    float s[NT][4];
    // products summed in the tensor cores, as the backward kernels sum them
    // (the span form of the ragged kernel sums them in fp32: its outputs
    // feed quantized page writes; these feed training)
    mma_qk<NT, MAXD, true, false>(s, qbig, qsmall, m0, kbig, ksmall, ld, d,
                                  g, t);
    frag_scores<false>(s, b, head, q0 + m0 + g, k0 + 2 * t, dm);
    const float m_old[2] = {m[0], m[1]};
    online_softmax(s, m, l, acc);
    lse_sum(s, m_old, m, l64);
    mma_pv<NT, NTO, true, false>(acc, s, vbig, vsmall, c0, VLD, d, g, t);
    k0 = kn;
  }
  cp_async_wait<0>();

  float* ob = o + qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l64[h] += __shfl_xor_sync(0xffffffffu, l64[h], 1);
    l64[h] += __shfl_xor_sync(0xffffffffu, l64[h], 2);
    const int row = q0 + m0 + g + 8 * h;
    if (row < dm.Sq) {
      const float den = fmaxf(l[h], 1e-30f), inv = 1.f / den;
      float* dst = ob + (int64_t)row * rs;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        if (col < d) {
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
        }
      }
      if (t == 0 && c0 == 0) {
        lse[(int64_t)bh * dm.Sq + row] =
            (float)((double)m[h] + log(fmax(l64[h], 1e-30)));
      }
    }
  }
}

// ---------------------------------------------------------------- dq

template <int MAXD>
__global__ void __launch_bounds__(kThreads, Tiles<MAXD>::kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Dims dm) {
  constexpr int BM = Tiles<MAXD>::BM, BN = Tiles<MAXD>::BN, WN = Tiles<MAXD>::WN;
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
__global__ void __launch_bounds__(kThreads, Tiles<MAXD>::kMinBlocks)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     Dims dm) {
  constexpr int BM = Tiles<MAXD>::BM, BN = Tiles<MAXD>::BN, WN = Tiles<MAXD>::WN;
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

// Shared memory of a backward kernel: two tiles of BM rows (dq's Q and
// dO, dk/dv's K and V), two stages of two BN-row tiles, the warps' P / dS
// buffers and `extra` floats.
template <int MAXD>
size_t bwd_bytes(int d, int extra) {
  constexpr int BM = Tiles<MAXD>::BM, BN = Tiles<MAXD>::BN;
  return sizeof(float) * ((size_t)(2 * BM + 4 * BN) * tile_ld(d) +
                          (size_t)(kThreads / 32) * 16 * Pw<BN>::ld + extra);
}

template <int MAXD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int B, const Dims& dm,
                       cudaStream_t st) {
  constexpr int BM = Tiles<MAXD>::BM, BN = Tiles<MAXD>::BN;
  // the Q planes, the staged K and V tiles, K's planes and V's transposed
  // planes (ld x BN each)
  const size_t smem =
      sizeof(float) * (size_t)(2 * BM + 6 * BN) * tile_ld(dm.d);
  cudaError_t err = opt_in(flash_fwd_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + BM - 1) / BM);
  flash_fwd_kernel<MAXD><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, dm);
  return cudaGetLastError();
}

template <int MAXD>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int B, const Dims& dm, cudaStream_t st) {
  constexpr int BM = Tiles<MAXD>::BM;
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
  constexpr int BM = Tiles<MAXD>::BM;
  const size_t smem = bwd_bytes<MAXD>(dm.d, 4 * Tiles<MAXD>::BN);
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
  const int R = d <= 128 ? Tiles<128>::BM : Tiles<256>::BM;
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

// ============================================ bf16 and fp16 instantiations
//
// The same three kernels for bf16 (or fp16) q, k, v, o, do, dq, dk, dv
// (AMP), one body each templated on the 16-bit type H with a kernel of
// its own name per type (fwd16 -> flash_fwd_bf16_kernel /
// flash_fwd_f16_kernel, and so on; fp16's range pieces in
// flash_common.cuh): the same grid, tile walk (causal skip, block-mask
// skip, heaviest tiles first), masks and fp32 softmax as the fp32 kernels
// above, with lse, delta and the masks fp32, only for 128 < d <= 256
// (instantiation 256; for d <= 128 the entry points take the wgmma kernels
// of flash_attention_wgmma.cu). They replace the same Pallas kernels at
// bf16 and fp16, which upcast each tile to fp32, compute in fp32 and write
// o, dq, dk and dv in the input dtype: here the products run on 16-bit
// tensor cores with fp32 accumulators (bf16_mma.cuh; P and dS, fp32 in
// registers, split in two 16-bit terms), and the outputs are rounded to
// the input dtype once, at the end.
//
// Tiles hold bf16 rows (bf_ld), half the bytes of the fp32 kernels' rows,
// so every operand tile is staged whole and double-buffered with
// cp.async, the forward's K and V too (no planes: nothing is split), and
// P and dS never leave registers: a C fragment pair is an A fragment
// (bf16_mma.cuh). Fragments come through ldmatrix (.trans for the operands
// contracted over their rows). What bounds them is still mma.sync's rate
// and 8 warps per SM; the operand split of P and dS doubles the products
// of P V, dS K, P^T dO and dS^T Q (not counted in the bound, which is the
// JAX kernel's FLOPs at the dense bf16 rate).

// BM rows of the block's own side, BN (forward) and BNB (backward) rows
// of the streamed side per stage, WN warps sharing each 16 rows.
template <int MAXD>
struct TilesBf;
template <>
struct TilesBf<256> {
  static constexpr int BM = 64, BN = 32, BNB = 16, WN = 2, kMinBlocks = 1;
};

// Start copying rows [row0, row0 + R) of a bf16 [B, S, H, d] tensor (base
// at (b, 0, head, 0)) into a tile of row stride ld: columns up to d
// rounded to 16, the ones past d and rows at or past n_valid zero-filled.
template <int R, int NTHR>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* base,
                                               int row0, int n_valid, int d,
                                               int ld, int64_t row_stride) {
  const int gpr = ((d + 15) & ~15) >> 3;   // 16-byte granules per row
  for (int idx = threadIdx.x; idx < R * gpr; idx += NTHR) {
    const int r = idx / gpr, c = 8 * (idx - r * gpr);
    const bool valid = r < n_valid && c < d;
    cp_async16(dst + r * ld + c,
               valid ? base + (int64_t)(row0 + r) * row_stride + c : base,
               valid);
  }
}

// The forward's body for 16-bit operands of type H; the kernels below
// instantiate it for bf16 and fp16.
template <int MAXD, int H>
__device__ __forceinline__ void fwd16(const uint16_t* __restrict__ q,
                                      const uint16_t* __restrict__ k,
                                      const uint16_t* __restrict__ v,
                                      uint16_t* __restrict__ o,
                                      float* __restrict__ lse,
                                      const Dims& dm) {
  constexpr int BM = TilesBf<MAXD>::BM, BN = TilesBf<MAXD>::BN;
  constexpr int WN = TilesBf<MAXD>::WN;
  constexpr int NTHR = kThreads, WM = BM / 16;
  static_assert(32 * WM * WN == NTHR, "a warp for each 16 rows and WN");
  constexpr int NT = BN / 8, NTO = MAXD / WN / 8;
  extern __shared__ float4 smem4[];
  const int d = dm.d, ld = bf_ld(d);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem4);   // [BM][ld]
  uint16_t* ks = qs + BM * ld;                          // [2][BN][ld]
  uint16_t* vs = ks + 2 * BN * ld;                      // [2][BN][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM);
  const int c0 = WN == 1 ? 0 : (warp / WM) * (MAXD / WN);

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tile first
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;

  const int kend = key_end(q0, BM, dm);
  int k0 = live_key_tile<BN>(q0, 0, kend, dm);
  load_tile_bf16<BM, NTHR>(qs, q + qoff, q0, dm.Sq - q0, d, ld, rs);
  if (k0 < kend) {
    load_tile_bf16<BN, NTHR>(ks, k + koff, k0, dm.Sk - k0, d, ld, rs);
    load_tile_bf16<BN, NTHR>(vs, v + koff, k0, dm.Sk - k0, d, ld, rs);
  }
  cp_async_commit();

  // rows g (h = 0) and g + 8 (h = 1): running max, this lane's partial sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int stage = 0; k0 < kend; stage ^= 1) {
    // the next live tile's copy into the other stage runs under this
    // tile's products
    const int kn = live_key_tile<BN>(q0, k0 + BN, kend, dm);
    if (kn < kend) {
      const int so = (stage ^ 1) * BN * ld;
      load_tile_bf16<BN, NTHR>(ks + so, k + koff, kn, dm.Sk - kn, d, ld, rs);
      load_tile_bf16<BN, NTHR>(vs + so, v + koff, kn, dm.Sk - kn, d, ld, rs);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* kt = ks + stage * BN * ld;
    const uint16_t* vt = vs + stage * BN * ld;
    float s[NT][4];
    mma_xyt16<NT, MAXD, H>(s, qs, m0, kt, ld, d, lane);
    frag_scores<false>(s, b, head, q0 + m0 + g, k0 + 2 * t, dm);
    online_softmax(s, m, l, acc);
    if constexpr (H == kF16) scale_frags(s, kPScale);   // flash_common.cuh
    mma_cz16<NT, NTO, H>(acc, s, vt, c0, ld, d, lane);
    __syncthreads();   // this stage is consumed before it is refilled
    k0 = kn;
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float den = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / den;
    const int row = q0 + m0 + g + 8 * h;
    if (row < dm.Sq && t == 0 && c0 == 0) {
      lse[(int64_t)bh * dm.Sq + row] = m[h] + logf(den);
    }
    if constexpr (H == kF16) inv[h] *= 1.f / kPScale;
  }
  store_frags16<NTO, H>(o + qoff, rs, acc, inv, q0 + m0, dm.Sq, c0, d, g,
                        t);
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, TilesBf<MAXD>::kMinBlocks)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      uint16_t* __restrict__ o, float* __restrict__ lse,
                      Dims dm) {
  fwd16<MAXD, kBf16>(q, k, v, o, lse, dm);
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, TilesBf<MAXD>::kMinBlocks)
flash_fwd_f16_kernel(const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v,
                     uint16_t* __restrict__ o, float* __restrict__ lse,
                     Dims dm) {
  fwd16<MAXD, kF16>(q, k, v, o, lse, dm);
}

// dq's body for 16-bit operands of type H (the kernels below).
template <int MAXD, int H>
__device__ __forceinline__ void dq16(const uint16_t* __restrict__ q,
                                     const uint16_t* __restrict__ k,
                                     const uint16_t* __restrict__ v,
                                     const uint16_t* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     uint16_t* __restrict__ dq,
                                     const Dims& dm) {
  constexpr int BM = TilesBf<MAXD>::BM, BN = TilesBf<MAXD>::BNB;
  constexpr int WN = TilesBf<MAXD>::WN;
  constexpr int NTHR = kThreads, WM = BM / 16;
  static_assert(32 * WM * WN == NTHR, "a warp for each 16 rows and WN");
  constexpr int NT = BN / 8, NTO = MAXD / WN / 8;
  extern __shared__ float4 smem4[];
  const int d = dm.d, ld = bf_ld(d);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem4);   // [BM][ld]
  uint16_t* dos = qs + BM * ld;                         // [BM][ld]
  uint16_t* ks = dos + BM * ld;                         // [2][BN][ld]
  uint16_t* vs = ks + 2 * BN * ld;                      // [2][BN][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM);
  const int c0 = WN == 1 ? 0 : (warp / WM) * (MAXD / WN);

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tile first
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;

  const int kend = key_end(q0, BM, dm);
  int k0 = live_key_tile<BN>(q0, 0, kend, dm);
  load_tile_bf16<BM, NTHR>(qs, q + qoff, q0, dm.Sq - q0, d, ld, rs);
  load_tile_bf16<BM, NTHR>(dos, dout + qoff, q0, dm.Sq - q0, d, ld, rs);
  if (k0 < kend) {
    load_tile_bf16<BN, NTHR>(ks, k + koff, k0, dm.Sk - k0, d, ld, rs);
    load_tile_bf16<BN, NTHR>(vs, v + koff, k0, dm.Sk - k0, d, ld, rs);
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
  // dS's multipliers of rows g and g + 8 (at fp16 with their ds_scale,
  // flash_common.cuh)
  float ds_mul[2];
  ds_row_multipliers<H>(dm, bh, q0 + m0, dm.Sq, g, ds_mul);

  for (int stage = 0; k0 < kend; stage ^= 1) {
    const int kn = live_key_tile<BN>(q0, k0 + BN, kend, dm);
    if (kn < kend) {
      const int so = (stage ^ 1) * BN * ld;
      load_tile_bf16<BN, NTHR>(ks + so, k + koff, kn, dm.Sk - kn, d, ld, rs);
      load_tile_bf16<BN, NTHR>(vs + so, v + koff, kn, dm.Sk - kn, d, ld, rs);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* kt = ks + stage * BN * ld;
    const uint16_t* vt = vs + stage * BN * ld;
    float s[NT][4], dp[NT][4];
    mma_xyt16<NT, MAXD, H>(s, qs, m0, kt, ld, d, lane);
    mma_xyt16<NT, MAXD, H>(dp, dos, m0, vt, ld, d, lane);
    frag_scores<false>(s, b, head, q0 + m0 + g, k0 + 2 * t, dm);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sv = s[i][r];
        const float p = sv <= kMaskedBelow ? 0.f : expf(sv - row_lse[r >> 1]);
        dp[i][r] = ds_mul[r >> 1] * (p * (dp[i][r] - row_delta[r >> 1]));
      }
    }
    mma_cz16<NT, NTO, H>(acc, dp, kt, c0, ld, d, lane);
    __syncthreads();   // this stage is consumed before it is refilled
    k0 = kn;
  }
  cp_async_wait<0>();
  float unf[2];   // dq's rows: 1 / their ds_scale at fp16
  ds_row_inverses<H>(dm, ds_mul, unf);
  store_frags16<NTO, H>(dq + qoff, rs, acc, unf, q0 + m0, dm.Sq, c0, d, g,
                        t);
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, TilesBf<MAXD>::kMinBlocks)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, Dims dm) {
  dq16<MAXD, kBf16>(q, k, v, dout, lse, delta, dq, dm);
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, TilesBf<MAXD>::kMinBlocks)
flash_bwd_dq_f16_kernel(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v,
                        const uint16_t* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        uint16_t* __restrict__ dq, Dims dm) {
  dq16<MAXD, kF16>(q, k, v, dout, lse, delta, dq, dm);
}

// dk/dv's body for 16-bit operands of type H (the kernels below).
template <int MAXD, int H>
__device__ __forceinline__ void dkv16(const uint16_t* __restrict__ q,
                                      const uint16_t* __restrict__ k,
                                      const uint16_t* __restrict__ v,
                                      const uint16_t* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      uint16_t* __restrict__ dk,
                                      uint16_t* __restrict__ dv,
                                      const Dims& dm) {
  constexpr int BM = TilesBf<MAXD>::BM, BN = TilesBf<MAXD>::BNB;
  constexpr int WN = TilesBf<MAXD>::WN;
  constexpr int NTHR = kThreads, WM = BM / 16;
  static_assert(32 * WM * WN == NTHR, "a warp for each 16 rows and WN");
  constexpr int NT = BN / 8, NTO = MAXD / WN / 8;
  extern __shared__ float4 smem4[];
  const int d = dm.d, ld = bf_ld(d);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem4);   // [BM][ld], keys
  uint16_t* vs = ks + BM * ld;                          // [BM][ld]
  uint16_t* qs = vs + BM * ld;        // [2][BN][ld], stages of query rows
  uint16_t* dos = qs + 2 * BN * ld;   // [2][BN][ld]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BN * ld);   // [2][BN]
  float* delta_s = lse_s + 2 * BN;                              // [2][BN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM);
  const int c0 = WN == 1 ? 0 : (warp / WM) * (MAXD / WN);

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int k0 = blockIdx.y * BM;   // the first key tiles see the most rows
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;
  const float* lse_b = lse + (int64_t)bh * dm.Sq;
  const float* delta_b = delta + (int64_t)bh * dm.Sq;

  int qstart = 0;
  if (dm.causal) qstart = max(0, k0 - (dm.Sk - dm.Sq)) / BN * BN;
  int q0 = live_query_tile<BN>(qstart, k0, dm);

  auto load_rows_of = [&](int q1, int st) {
    const int so = st * BN * ld;
    load_tile_bf16<BN, NTHR>(qs + so, q + qoff, q1, dm.Sq - q1, d, ld, rs);
    load_tile_bf16<BN, NTHR>(dos + so, dout + qoff, q1, dm.Sq - q1, d, ld,
                             rs);
    for (int r = threadIdx.x; r < BN; r += NTHR) {
      const bool valid = q1 + r < dm.Sq;
      cp_async4(lse_s + st * BN + r, valid ? lse_b + q1 + r : lse_b, valid);
      cp_async4(delta_s + st * BN + r, valid ? delta_b + q1 + r : delta_b,
                valid);
    }
  };
  load_tile_bf16<BM, NTHR>(ks, k + koff, k0, dm.Sk - k0, d, ld, rs);
  load_tile_bf16<BM, NTHR>(vs, v + koff, k0, dm.Sk - k0, d, ld, rs);
  if (q0 < dm.Sq) load_rows_of(q0, 0);
  cp_async_commit();

  float dk_acc[NTO][4], dv_acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[j][r] = dv_acc[j][r] = 0.f;
  }
  // dS^T's multipliers of rows g and g + 8 (this warp's keys; at fp16
  // with their ds_scale)
  float ds_mul[2];
  ds_row_multipliers<H>(dm, bh, k0 + m0, dm.Sk, g, ds_mul);

  for (int stage = 0; q0 < dm.Sq; stage ^= 1) {
    const int qn = live_query_tile<BN>(q0 + BN, k0, dm);
    if (qn < dm.Sq) load_rows_of(qn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* qt = qs + stage * BN * ld;
    const uint16_t* dot = dos + stage * BN * ld;
    const float* lse_t = lse_s + stage * BN;
    const float* delta_t = delta_s + stage * BN;
    // transposed scores: rows are this block's keys, columns the queries
    float st[NT][4], dpt[NT][4];
    mma_xyt16<NT, MAXD, H>(st, ks, m0, qt, ld, d, lane);
    mma_xyt16<NT, MAXD, H>(dpt, vs, m0, dot, ld, d, lane);
    frag_scores<true>(st, b, head, k0 + m0 + g, q0 + 2 * t, dm);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 8 * i + 2 * t + (r & 1);
        const float sv = st[i][r];
        const float p = sv <= kMaskedBelow ? 0.f : expf(sv - lse_t[n]);
        st[i][r] = p;
        dpt[i][r] = ds_mul[r >> 1] * (p * (dpt[i][r] - delta_t[n]));
      }
    }
    if constexpr (H == kF16) scale_frags(st, kPScale);
    mma_cz16<NT, NTO, H>(dv_acc, st, dot, c0, ld, d, lane);
    mma_cz16<NT, NTO, H>(dk_acc, dpt, qt, c0, ld, d, lane);
    __syncthreads();   // this stage is consumed before it is refilled
    q0 = qn;
  }
  cp_async_wait<0>();
  float unp[2] = {1.f, 1.f};   // at fp16 dv's rows times 1 / kPScale
  if constexpr (H == kF16) unp[0] = unp[1] = 1.f / kPScale;
  float unf[2];   // dk's rows: 1 / their ds_scale at fp16
  ds_row_inverses<H>(dm, ds_mul, unf);
  store_frags16<NTO, H>(dk + koff, rs, dk_acc, unf, k0 + m0, dm.Sk, c0, d, g,
                        t);
  store_frags16<NTO, H>(dv + koff, rs, dv_acc, unp, k0 + m0, dm.Sk, c0, d, g,
                        t);
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, TilesBf<MAXD>::kMinBlocks)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk,
                          uint16_t* __restrict__ dv, Dims dm) {
  dkv16<MAXD, kBf16>(q, k, v, dout, lse, delta, dk, dv, dm);
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, TilesBf<MAXD>::kMinBlocks)
flash_bwd_dkv_f16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dk,
                         uint16_t* __restrict__ dv, Dims dm) {
  dkv16<MAXD, kF16>(q, k, v, dout, lse, delta, dk, dv, dm);
}

// Shared memory of the bf16 kernels, in bytes.
template <int MAXD>
size_t fwd_bf16_bytes(int d) {
  constexpr int BM = TilesBf<MAXD>::BM, BN = TilesBf<MAXD>::BN;
  return 2 * (size_t)(BM + 4 * BN) * bf_ld(d);
}

template <int MAXD>
size_t bwd_bf16_bytes(int d, int extra_floats) {
  constexpr int BM = TilesBf<MAXD>::BM, BN = TilesBf<MAXD>::BNB;
  return 2 * (size_t)(2 * BM + 4 * BN) * bf_ld(d) +
         sizeof(float) * (size_t)extra_floats;
}

template <int MAXD, int H>
cudaError_t launch_fwd16(const uint16_t* q, const uint16_t* k,
                         const uint16_t* v, uint16_t* o, float* lse, int B,
                         const Dims& dm, cudaStream_t st) {
  constexpr int BM = TilesBf<MAXD>::BM;
  const auto kernel = H == kF16 ? flash_fwd_f16_kernel<MAXD>
                                : flash_fwd_bf16_kernel<MAXD>;
  const size_t smem = fwd_bf16_bytes<MAXD>(dm.d);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, o, lse, dm);
  return cudaGetLastError();
}

template <int MAXD, int H>
cudaError_t launch_dq16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const uint16_t* dout,
                        const float* lse, const float* delta, uint16_t* dq,
                        int B, const Dims& dm, cudaStream_t st) {
  constexpr int BM = TilesBf<MAXD>::BM;
  const auto kernel = H == kF16 ? flash_bwd_dq_f16_kernel<MAXD>
                                : flash_bwd_dq_bf16_kernel<MAXD>;
  const size_t smem = bwd_bf16_bytes<MAXD>(dm.d, 0);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dq, dm);
  return cudaGetLastError();
}

template <int MAXD, int H>
cudaError_t launch_dkv16(const uint16_t* q, const uint16_t* k,
                         const uint16_t* v, const uint16_t* dout,
                         const float* lse, const float* delta, uint16_t* dk,
                         uint16_t* dv, int B, const Dims& dm,
                         cudaStream_t st) {
  constexpr int BM = TilesBf<MAXD>::BM;
  const auto kernel = H == kF16 ? flash_bwd_dkv_f16_kernel<MAXD>
                                : flash_bwd_dkv_bf16_kernel<MAXD>;
  const size_t smem = bwd_bf16_bytes<MAXD>(dm.d, 4 * TilesBf<MAXD>::BNB);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sk + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dk, dv,
                                       dm);
  return cudaGetLastError();
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
  if (d <= 64) return (int)launch_fwd<64>(qf, kf, vf, of, lf, B, dm, st);
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

// The bf16 and fp16 instantiations: the same arguments, with q, k, v, o /
// dout, dq, dk and dv 16-bit (lse, delta and the masks fp32); the fp16
// backward entry points take one more, after delta: ds_scale, the power
// of two dS is multiplied by per query row ([B, H, Sq], dq) or per key
// ([B, H, Sk], dk/dv), fp32 (flash_common.cuh). For d <= 128 they take the
// wgmma kernels (flash_attention_wgmma.cu); above, the mma.sync kernels of
// this file.

namespace {

template <int H>
int fwd_entry16(const void* q, const void* k, const void* v, void* o,
                void* lse, const Dims& dm, int B, void* stream) {
  if (!shapes_ok(dm, B)) return (int)cudaErrorInvalidValue;
  if (B == 0 || dm.Sq == 0) return (int)cudaSuccess;
  if (dm.Sk == 0) return (int)cudaErrorInvalidValue;
  const uint16_t* qh = static_cast<const uint16_t*>(q);
  const uint16_t* kh = static_cast<const uint16_t*>(k);
  const uint16_t* vh = static_cast<const uint16_t*>(v);
  uint16_t* oh = static_cast<uint16_t*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dm.d <= 128) {
    return (int)(H == kF16
                     ? flash::launch_fwd_f16_wgmma(qh, kh, vh, oh, lf, B, dm,
                                                   st)
                     : flash::launch_fwd_bf16_wgmma(qh, kh, vh, oh, lf, B,
                                                    dm, st));
  }
  return (int)launch_fwd16<256, H>(qh, kh, vh, oh, lf, B, dm, st);
}

template <int H>
int dq_entry16(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, Dims dm, int B,
               void* stream) {
  if (!shapes_ok(dm, B)) return (int)cudaErrorInvalidValue;
  if (B == 0 || dm.Sq == 0) return (int)cudaSuccess;
  if (dm.Sk == 0) return (int)cudaErrorInvalidValue;
  const uint16_t* qh = static_cast<const uint16_t*>(q);
  const uint16_t* kh = static_cast<const uint16_t*>(k);
  const uint16_t* vh = static_cast<const uint16_t*>(v);
  const uint16_t* dh = static_cast<const uint16_t*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* ef = static_cast<const float*>(delta);
  uint16_t* gh = static_cast<uint16_t*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dm.d <= 128) {
    return (int)(H == kF16
                     ? flash::launch_dq_f16_wgmma(qh, kh, vh, dh, lf, ef, gh,
                                                  B, dm, st)
                     : flash::launch_dq_bf16_wgmma(qh, kh, vh, dh, lf, ef,
                                                   gh, B, dm, st));
  }
  return (int)launch_dq16<256, H>(qh, kh, vh, dh, lf, ef, gh, B, dm, st);
}

template <int H>
int dkv_entry16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, Dims dm, int B, void* stream) {
  if (!shapes_ok(dm, B)) return (int)cudaErrorInvalidValue;
  if (B == 0 || dm.Sk == 0) return (int)cudaSuccess;
  if (dm.Sq == 0) return (int)cudaErrorInvalidValue;
  const uint16_t* qh = static_cast<const uint16_t*>(q);
  const uint16_t* kh = static_cast<const uint16_t*>(k);
  const uint16_t* vh = static_cast<const uint16_t*>(v);
  const uint16_t* dh = static_cast<const uint16_t*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* ef = static_cast<const float*>(delta);
  uint16_t* kg = static_cast<uint16_t*>(dk);
  uint16_t* vg = static_cast<uint16_t*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dm.d <= 128) {
    return (int)(H == kF16
                     ? flash::launch_dkv_f16_wgmma(qh, kh, vh, dh, lf, ef,
                                                   kg, vg, B, dm, st)
                     : flash::launch_dkv_bf16_wgmma(qh, kh, vh, dh, lf, ef,
                                                    kg, vg, B, dm, st));
  }
  return (int)launch_dkv16<256, H>(qh, kh, vh, dh, lf, ef, kg, vg, B, dm,
                                   st);
}

}  // namespace

extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* mask, const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  return fwd_entry16<kBf16>(
      q, k, v, o, lse,
      make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias, qseg, kseg,
                block_mask, bq, bk),
      B, stream);
}

extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* mask,
    const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  return dq_entry16<kBf16>(
      q, k, v, dout, lse, delta, dq,
      make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias, qseg, kseg,
                block_mask, bq, bk),
      B, stream);
}

extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* mask,
    const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  return dkv_entry16<kBf16>(
      q, k, v, dout, lse, delta, dk, dv,
      make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias, qseg, kseg,
                block_mask, bq, bk),
      B, stream);
}

extern "C" int flash_attention_fwd_f16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* mask, const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  return fwd_entry16<kF16>(
      q, k, v, o, lse,
      make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias, qseg, kseg,
                block_mask, bq, bk),
      B, stream);
}

extern "C" int flash_attention_bwd_dq_f16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* ds_scale, void* dq,
    const void* mask, const void* kbias, const void* qseg, const void* kseg,
    const void* block_mask, int B, int H, int Sq, int Sk, int d, int mh,
    int bq, int bk, float scale, int causal, void* stream) {
  Dims dm = make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias, qseg,
                      kseg, block_mask, bq, bk);
  dm.ds_scale = static_cast<const float*>(ds_scale);
  if (dm.ds_scale == nullptr) return (int)cudaErrorInvalidValue;
  return dq_entry16<kF16>(q, k, v, dout, lse, delta, dq, dm, B, stream);
}

extern "C" int flash_attention_bwd_dkv_f16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* ds_scale, void* dk,
    void* dv, const void* mask, const void* kbias, const void* qseg,
    const void* kseg, const void* block_mask, int B, int H, int Sq, int Sk,
    int d, int mh, int bq, int bk, float scale, int causal, void* stream) {
  Dims dm = make_dims(H, Sq, Sk, d, scale, causal, mask, mh, kbias, qseg,
                      kseg, block_mask, bq, bk);
  dm.ds_scale = static_cast<const float*>(ds_scale);
  if (dm.ds_scale == nullptr) return (int)cudaErrorInvalidValue;
  return dkv_entry16<kF16>(q, k, v, dout, lse, delta, dk, dv, dm, B,
                           stream);
}
