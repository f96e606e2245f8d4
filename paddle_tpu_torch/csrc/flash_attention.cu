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
// of this kernel (64 or 32 rows, both dividing 128) lies inside one such
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
// fp32 FLOPs per computed (query, key) pair against one read of q, k, v,
// do, the masks, and one write of each output, so at the training shapes
// (s = 512..4096, d = 64..128) the fp32 FLOPs (67 TFLOP/s outside the
// tensor cores) are the bound by one to two orders of magnitude. The
// masks add a few loads per score (the per-key bias and segment ids stay
// in L1; a dense mask is read once per tile that uses it).
//
// Design: FlashAttention-2's split. The forward and dq kernels run one
// thread block per (batch * head, tile of BR query rows) and walk the key
// tiles; dk/dv runs one block per (batch * head, tile of BC keys) and walks
// the query tiles. Every block owns its outputs, so there are no atomics
// and the gradients are deterministic. Tiles are staged in shared memory
// with a padded row stride (d + 4 floats) so that the float4 reads of
// eight different rows fall in distinct banks. The 256 threads of a block
// form a 16 x 16 grid; each computes a (BR / 16) x (BC / 16) piece of the
// score tile as a register-blocked product (float4 reads, FMAs on CUDA
// cores), reduces rows across its 16 lanes with shuffles, and owns float4
// column chunks 4 tx + 64 c of its rows' accumulators. Causal blocks skip
// the key (query) tiles past their last visible pair and are launched
// heaviest first; block-masked tiles are skipped the same way. The masks
// are runtime operands of the same instantiations: a tile's scores take
// the masked loop only when a mask, bias or segment ids are given (a
// branch uniform across the block), so the dense forms run the unmasked
// loop as before. BR = BC = 64 for d <= 128 and 32 for d <= 256, which
// keeps each kernel's shared memory under the 227 KB a block may use. The
// forward keeps K and V in one buffer, in turn, so two of its blocks fit
// on an SM. wgmma tiles (TF32 or bf16 operands), cp.async or TMA double
// buffering and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
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
// is (row0 + 16 i, key0 + 16 j), or with TRANSPOSED (key0 + 16 i, row0 +
// 16 j). MASKED reads the masks (masked_score); otherwise only the causal
// and range checks apply.
template <bool MASKED, bool TRANSPOSED, int RM>
__device__ __forceinline__ void scores_of(float (&s)[RM][RM], int b,
                                          int head, int row0, int key0,
                                          const Dims& dm) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int row = row0 + 16 * (TRANSPOSED ? j : i);
      const int key = key0 + 16 * (TRANSPOSED ? i : j);
      s[i][j] = MASKED ? masked_score(s[i][j], b, head, row, key, dm)
                       : visible(row, key, dm) ? s[i][j] * dm.scale
                                               : kNegInf;
    }
  }
}

// scores_of on a branch uniform across the block, so the dense forms run
// the unmasked loop and pay nothing for the masks.
template <bool TRANSPOSED, int RM>
__device__ __forceinline__ void tile_scores(float (&s)[RM][RM], int b,
                                            int head, int row0, int key0,
                                            const Dims& dm) {
  if (dm.mask || dm.kbias || dm.qseg) {
    scores_of<true, TRANSPOSED>(s, b, head, row0, key0, dm);
  } else {
    scores_of<false, TRANSPOSED>(s, b, head, row0, key0, dm);
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
    tile_scores<false>(s, b, head, q0 + ty, k0 + tx, dm);
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

// ---------------------------------------------------------------- dq

template <int MAXD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Dims dm) {
  constexpr int R = Tile<MAXD>::R, RM = R / 16, NC = MAXD / 64;
  constexpr int ldp = R + 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = dm.d, ld = d + 4;
  float* qs = smem;             // [R][ld]
  float* dos = qs + R * ld;     // [R][ld]
  float* ks = dos + R * ld;     // [R][ld]
  float* vs = ks + R * ld;      // [R][ld]
  float* dss = vs + R * ld;     // [R][ldp]

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;

  load_rows<R>(qs, q + qoff, q0, dm.Sq - q0, d, ld, rs);
  load_rows<R>(dos, dout + qoff, q0, dm.Sq - q0, d, ld, rs);
  float row_lse[RM], row_delta[RM];
  float4 acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < dm.Sq ? lse[(int64_t)bh * dm.Sq + row] : 0.f;
    row_delta[i] = row < dm.Sq ? delta[(int64_t)bh * dm.Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int kend = key_end(q0, R, dm);
  for (int k0 = 0; k0 < kend; k0 += R) {
    if (!tile_live(q0, k0, dm)) continue;
    __syncthreads();   // K and dS of the previous tile are consumed
    load_rows<R>(ks, k + koff, k0, dm.Sk - k0, d, ld, rs);
    load_rows<R>(vs, v + koff, k0, dm.Sk - k0, d, ld, rs);
    __syncthreads();
    float s[RM][RM], dp[RM][RM];
    gemm_nt<RM, RM>(s, qs, ks, ld, d, ty, tx);
    gemm_nt<RM, RM>(dp, dos, vs, ld, d, ty, tx);
    tile_scores<false>(s, b, head, q0 + ty, k0 + tx, dm);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const float sv = s[i][j];
        const float p = sv <= kMaskedBelow ? 0.f : expf(sv - row_lse[i]);
        dss[(ty + 16 * i) * ldp + tx + 16 * j] =
            dm.scale * (p * (dp[i][j] - row_delta[i]));
      }
    }
    __syncthreads();
    gemm_nn<RM, NC>(acc, dss, ldp, ks, ld, R, d, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < dm.Sq) store_row<NC>(dq + qoff, rs, row, acc[i], 1.f, d, tx);
  }
}

// ------------------------------------------------------------- dk, dv

template <int MAXD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     Dims dm) {
  constexpr int R = Tile<MAXD>::R, RM = R / 16, NC = MAXD / 64;
  constexpr int ldp = R + 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = dm.d, ld = d + 4;
  float* ks = smem;             // [R][ld]
  float* vs = ks + R * ld;      // [R][ld]
  float* qs = vs + R * ld;      // [R][ld]
  float* dos = qs + R * ld;     // [R][ld]
  float* pts = dos + R * ld;    // [R keys][ldp] P^T
  float* dsts = pts + R * ldp;  // [R keys][ldp] scale * dS^T
  float* lse_s = dsts + R * ldp;   // [R]
  float* delta_s = lse_s + R;      // [R]

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int k0 = blockIdx.y * R;   // the first key tiles see the most rows
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t rs = (int64_t)dm.H * d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * d;

  load_rows<R>(ks, k + koff, k0, dm.Sk - k0, d, ld, rs);
  load_rows<R>(vs, v + koff, k0, dm.Sk - k0, d, ld, rs);
  float4 dk_acc[RM][NC], dv_acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // under the causal mask, rows before k0 - (Sk - Sq) see none of these
  // keys (the other masks only hide more)
  int qstart = 0;
  if (dm.causal) qstart = max(0, k0 - (dm.Sk - dm.Sq)) / R * R;
  for (int q0 = qstart; q0 < dm.Sq; q0 += R) {
    if (!tile_live(q0, k0, dm)) continue;
    __syncthreads();   // Q, dO, P^T and dS^T of the previous tile are consumed
    load_rows<R>(qs, q + qoff, q0, dm.Sq - q0, d, ld, rs);
    load_rows<R>(dos, dout + qoff, q0, dm.Sq - q0, d, ld, rs);
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const int row = q0 + r;
      lse_s[r] = row < dm.Sq ? lse[(int64_t)bh * dm.Sq + row] : 0.f;
      delta_s[r] = row < dm.Sq ? delta[(int64_t)bh * dm.Sq + row] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this block's keys, columns the queries
    float st[RM][RM], dpt[RM][RM];
    gemm_nt<RM, RM>(st, ks, qs, ld, d, ty, tx);
    gemm_nt<RM, RM>(dpt, vs, dos, ld, d, ty, tx);
    tile_scores<true>(st, b, head, q0 + tx, k0 + ty, dm);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int r = tx + 16 * j;
        const float sv = st[i][j];
        const float p = sv <= kMaskedBelow ? 0.f : expf(sv - lse_s[r]);
        pts[(ty + 16 * i) * ldp + r] = p;
        dsts[(ty + 16 * i) * ldp + r] =
            dm.scale * (p * (dpt[i][j] - delta_s[r]));
      }
    }
    __syncthreads();
    gemm_nn<RM, NC>(dv_acc, pts, ldp, dos, ld, R, d, ty, tx);
    gemm_nn<RM, NC>(dk_acc, dsts, ldp, qs, ld, R, d, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < dm.Sk) {
      store_row<NC>(dk + koff, rs, key, dk_acc[i], 1.f, d, tx);
      store_row<NC>(dv + koff, rs, key, dv_acc[i], 1.f, d, tx);
    }
  }
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
size_t rows_bytes(int d, int n_row_tiles, int n_p_tiles, int extra) {
  constexpr int R = Tile<MAXD>::R;
  return sizeof(float) * ((size_t)n_row_tiles * R * (d + 4) +
                          (size_t)n_p_tiles * R * (R + 16) + extra);
}

template <int MAXD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int B, const Dims& dm,
                       cudaStream_t st) {
  constexpr int R = Tile<MAXD>::R;
  const size_t smem = rows_bytes<MAXD>(dm.d, 2, 1, 0);
  cudaError_t err = opt_in(flash_fwd_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + R - 1) / R);
  flash_fwd_kernel<MAXD><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, dm);
  return cudaGetLastError();
}

template <int MAXD>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int B, const Dims& dm, cudaStream_t st) {
  constexpr int R = Tile<MAXD>::R;
  const size_t smem = rows_bytes<MAXD>(dm.d, 4, 1, 0);
  cudaError_t err = opt_in(flash_bwd_dq_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + R - 1) / R);
  flash_bwd_dq_kernel<MAXD><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, dm);
  return cudaGetLastError();
}

template <int MAXD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int B,
                       const Dims& dm, cudaStream_t st) {
  constexpr int R = Tile<MAXD>::R;
  const size_t smem = rows_bytes<MAXD>(dm.d, 4, 2, 2 * R);
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sk + R - 1) / R);
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
  if (d <= 128) {
    return (int)launch_dkv<128>(qf, kf, vf, df, lf, ef, kg, vg, B, dm, st);
  }
  return (int)launch_dkv<256>(qf, kf, vf, df, lf, ef, kg, vg, B, dm, st);
}
