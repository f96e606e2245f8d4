// What the flash kernels of both sources share (flash_attention.cu, and
// flash_attention_wgmma.cu with the bf16 forward, dq and dk/dv kernels for
// d <= 128): the problem sizes and masking operands (Dims), the masks at
// each fragment element (_tile_scores of the JAX kernel), the causal and
// block-mask walks, the bf16 output store and the shared-memory opt-in,
// and the three launchers the bf16 entry points of flash_attention.cu
// call in flash_attention_wgmma.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace flash {

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

}  // namespace flash

namespace {

using flash::Dims;

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

// A warp's accumulators of rows row0 + g, + 8 and columns c0 + 8 j + 2 t,
// times `mul` and rounded to bf16, into a bf16 [B, S, H, d] output (base at
// (b, 0, head, 0)), rows below n_rows.
template <int NTO>
__device__ __forceinline__ void store_frags_bf16(uint16_t* base,
                                                 int64_t row_stride,
                                                 const float (&acc)[NTO][4],
                                                 const float (&mul)[2],
                                                 int row0, int n_rows,
                                                 int c0, int d, int g,
                                                 int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < n_rows) {
      uint16_t* dst = base + (int64_t)row * row_stride;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        if (col < d) {
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(
              acc[j][2 * h] * mul[h], acc[j][2 * h + 1] * mul[h]);
        }
      }
    }
  }
}

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

}  // namespace

namespace flash {

// The bf16 forward, dq and dk/dv kernels on wgmma
// (flash_attention_wgmma.cu), for d <= 128; the same operands as
// launch_fwd_bf16 / launch_dq_bf16 / launch_dkv_bf16.
cudaError_t launch_fwd_bf16_wgmma(const uint16_t* q, const uint16_t* k,
                                  const uint16_t* v, uint16_t* o,
                                  float* lse, int B, const Dims& dm,
                                  cudaStream_t st);
cudaError_t launch_dq_bf16_wgmma(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, const uint16_t* dout,
                                 const float* lse, const float* delta,
                                 uint16_t* dq, int B, const Dims& dm,
                                 cudaStream_t st);
cudaError_t launch_dkv_bf16_wgmma(const uint16_t* q, const uint16_t* k,
                                  const uint16_t* v, const uint16_t* dout,
                                  const float* lse, const float* delta,
                                  uint16_t* dk, uint16_t* dv, int B,
                                  const Dims& dm, cudaStream_t st);

}  // namespace flash
