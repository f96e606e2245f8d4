// Ragged paged attention for Hopper, sm_90a: fp32 pools (K1), bf16 pools
// (K1-bf16), fp16 pools (K1-fp16) and quantized pools (K1-q: int8 codes
// with per-page, per-kv-head scales, or float8_e4m3fn), with fp32, bf16 or
// fp16 queries.
//
// Replaces: paddle_tpu/ops/pallas/ragged_paged_attention.py ::
//   ragged_paged_attention (kernel body _ragged_kernel, with its
//   kscale_ref / vscale_ref dequantize for int8 pools).
//
// Computes causal attention for a ragged batch of query spans straight off
// the paged K/V pools. q [B, T, n_q, d]; pools [N, page_size, n_kv, d];
// block_table [B, P]; start_pos, q_len [B] (int32). Query row t of sequence
// b sees the keys at positions <= start_pos[b] + t; rows t >= q_len[b] (and
// dead slots, q_len = 0) come out exactly 0.0. GQA groups the n_rep = n_q /
// n_kv query heads of one kv head into G = n_rep * T rows, row r = (rep, t)
// flattened with t = r % T, as the Pallas kernel does. Any page_size, d a
// multiple of 8 up to 256; the output is in q's type.
//
// Types (the QT and KV template arguments): fp32 q over fp32, int8 and
// fp8 pools; bf16 q (a bf16 serving runner's) over bf16, int8 and fp8
// pools; fp16 q (an fp16 runner's) over fp16, int8 and fp8 pools. As in
// the Pallas kernel, which casts each tile to fp32
// (ragged_paged_attention.py:98-100), every value is widened to fp32
// where it is read (elem_io.cuh), the softmax and the sums stay fp32 and
// the output is rounded to q's type where it is written (:139).
//
// Two forms, chosen by the wrapper from G (ops/ragged_paged_attention.py
// ragged_form): the span form for G > kDecodeRows, the decode form below.
// This file holds both forms of fp32 q and both forms of 16-bit q (bf16,
// fp16) for d > 128 (the tf32 span form, the unsplit decode form); 16-bit
// q's span form for d <= 128 (wgmma from a cp.async ring) and its decode
// form there (the split walk) are in ragged_paged_attention_bf16.cu, whose
// launchers the 16-bit entry points below call (ragged_common.cuh).
//
// Span form (prefill chunks, GQA spans), ragged_span_kernel. What bounds it:
// a chunk does 4 d FLOPs per visible (row, key) pair against one read of
// the visible pages, so at T >= 64 rows per kv head the FLOPs are the
// bound, at fp32-accurate tensor-core rates (3xTF32: 495 / 3 TFLOP/s).
// Design, on the pieces of tf32_mma.cuh that the flash forward uses:
// - one block per (sequence, kv head, BM = 64 grouped rows), with two key
//   groups of four warps (16 rows each) at d <= 128: the groups walk
//   alternate key tiles, each with its own staging buffers and planes, and
//   merge their softmax states at the end. At the serving chunk (B n_kv =
//   32, G = 256) that is 128 blocks of eight warps, one to an SM; one
//   group of four warps measured 1.5x slower there, 32-row blocks of two
//   warps 2.4x slower (tools/torch_kernel_ab.py on those variants);
// - the block's query rows are gathered and split once into big / small
//   planes; K and V come in tiles of BN = 32 positions (16 where two
//   planes of 32 would not fit), each position resolved through the block
//   table, so the walk does not depend on the page size. A tile is copied
//   with cp.async into a staging buffer while the block multiplies the one
//   before; each thread copies one row of every tile and reads that row's
//   table entry a tile ahead, so no copy waits on a table read. Positions
//   past the block's last visible key are zero-filled, and tiles wholly
//   past it are neither loaded nor multiplied;
// - the block splits each staged tile once into K planes and transposed V
//   planes; S = Q K^T and O += P V are mma.sync.m16n8k8 tf32 products with
//   every operand read from planes and P kept in registers (the S C
//   fragment is the P A fragment, tf32_mma.cuh); visibility (t = r % T <
//   q_len, key <= start + t) applies at each C-fragment element's own
//   (row, key), a hidden key gives p = 0 exactly, so a row with no
//   visible key ends with l = 0 and writes zeros; the online softmax runs
//   on the fragment rows;
// - 1-byte pools are staged as bytes (a quarter of the fp32 tile, rows of
//   d rounded to 16 plus 16 bytes) and dequantized in the split pass. An
//   e4m3 value is exact in tf32 (small half 0), so fp8 products take two
//   mma, not three. An int8 code is exact too, but its page scale is
//   applied where the tile is dequantized, code * scale rounded in fp32 as
//   the plain version rounds it, and the result split: an int8 pool's
//   values equal the plain version's bit for bit (a score-side scale
//   rounds otherwise, and through a model's next int8 page write that
//   flips codes). 16-byte copies where the rows are 16-byte aligned, else
//   8-byte ones (1-byte rows of d = 8 mod 16) or 4-byte ones (a pool 4
//   bytes off). bf16 and fp16 pools (16-bit q at d > 128) take the fp8
//   pools' path: a bf16 or fp16 value is exact in tf32 (fp16's 11
//   significant bits, its subnormals normal in tf32's exponent range),
//   staged as it is, one plane, two products a k-step.
//
// Decode form (G <= kDecodeRows: decode steps, short GQA spans),
// ragged_decode_kernel, on the CUDA cores. What bounds it: the page bytes
// (3.35 TB/s; 1-byte pools read a quarter, int8 adds 8 bytes of scales per
// page and kv head), at 2 G d FLOPs per key. Design: one block of four
// warps per (sequence, kv head); the warps own interleaved key tiles of KT
// positions (16 of 1-byte rows at d = 128, 8 of fp32: at most 4 KB of K
// rows), copied into warp-private double-buffered stages with
// cp.async, the next tile's copy issued before this tile's math and its
// rows' table entries read a tile earlier, so every warp keeps a tile of
// loads in flight. A key is scored by 32 / KT lanes (each a strided part
// of d) against the G query rows held in shared memory; int8 values are
// code * scale in fp32, as in the plain version; each warp keeps its own
// (m, l, acc) for the G rows, each lane owning float4 column chunks of
// acc; the warps' states are merged in shared memory at the end. At the
// engine's decode step (B n_kv = 256 blocks) no split across blocks is
// needed. 16-bit q at d <= 128 takes the split walk instead
// (ragged_paged_attention_bf16.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ragged_common.cuh"

namespace {

// ------------------------------------------------------------ span form

template <int MAXD, int KV>
struct Span {
  static constexpr int BM = 64;   // grouped query rows per block
  // key groups: at d <= 128 two sets of four warps walk alternate key
  // tiles, each with its own staging buffers and planes, and merge their
  // softmax states at the end (eight warps to an SM where one set of four
  // left the tensor cores waiting); at d <= 256 one set fits
  static constexpr int KG = MAXD <= 128 ? 2 : 1;
  // key positions per tile: 32, or 16 where two planes of 32 do not fit
  static constexpr int BN =
      KV == kF8 || KV == kBF16 || KV == kFP16 || (KV == kI8 && KG == 2)
          ? 32 : 16;
  static constexpr int GTHR = 2 * BM;   // a warp for each 16 rows, a group
  static constexpr int NTHR = KG * GTHR;
  // fp32 values and int8 values dequantized with their page scale are
  // split (three products); e4m3, bf16 and fp16 values are exact in tf32
  // (two)
  static constexpr bool SPLIT = KV == kF32 || KV == kI8;
};

// Bytes of one staged K (or V) tile: fp32 rows of tile_ld(d) floats
// (swizzled), or rows of code_ld(d) bytes.
template <int KV>
__host__ __device__ __forceinline__ int span_tile_bytes(int BN, int d) {
  return KV == kF32 ? BN * tile_ld(d) * 4 : BN * code_ld<KV>(d);
}

// Bytes of one key group's region: the staged K and V tiles and their
// int8 page scales, K's planes and V's transposed planes (two each where
// the values are split, else one).
template <int MAXD, int KV>
__host__ __device__ __forceinline__ int span_group_bytes(int d) {
  using S = Span<MAXD, KV>;
  const int np = S::SPLIT ? 2 : 1;
  return 2 * span_tile_bytes<KV>(S::BN, d) + 2 * S::BN * 4 +
         2 * np * S::BN * tile_ld(d) * 4;
}

// Shared memory of the span form: the Q planes and each key group's
// region (the merge of the groups' states reuses the second's).
template <int MAXD, int KV>
__host__ __device__ __forceinline__ size_t span_smem_bytes(int d) {
  using S = Span<MAXD, KV>;
  return (size_t)2 * S::BM * tile_ld(d) * 4 +
         (size_t)S::KG * span_group_bytes<MAXD, KV>(d);
}

// (page, element offset of the kv head's row) of key position kpos of
// sequence b: the block table resolves the page.
__device__ __forceinline__ int64_t key_row(const Ragged& a, int b, int kvh,
                                           int kpos, int& page) {
  page = __ldg(a.table + (int64_t)b * a.pages_per_seq + kpos / a.page_size);
  return (((int64_t)page * a.page_size + kpos % a.page_size) * a.n_kv +
          kvh) * a.d;
}

// The element offset of one key row in a pool, and its page, resolved
// through the block table; -1 past kend. Each thread of the span form
// owns one row of every tile and resolves it a tile ahead, so the table
// read's latency passes under a tile's products.
struct RowRef {
  int64_t off;
  int page;
};

__device__ __forceinline__ RowRef resolve_row(const Ragged& a, int b,
                                              int kvh, int kpos, int kend) {
  RowRef ref{-1, 0};
  if (kpos < kend) ref.off = key_row(a, b, kvh, kpos, ref.page);
  return ref;
}

// Start copying this thread's part of one staged tile row (row `row`,
// chunks part, part + parts, ...; zero-filled past d, up to d rounded to
// 16, and wholly for a row past kend) and, for int8, its page scale.
template <int KV>
__device__ __forceinline__ void load_span_row(void* dst, float* sc,
                                              const void* pool,
                                              const float* scale,
                                              const Ragged& a, int kvh,
                                              int row, int part, int parts,
                                              const RowRef& ref) {
  const int d = a.d, w = (d + 15) & ~15;
  const bool live = ref.off >= 0;
  if constexpr (KV == kF32) {
    const int ld = tile_ld(d);
    const float* src = static_cast<const float*>(pool) + (live ? ref.off : 0);
    for (int c = 4 * part; c < w; c += 4 * parts) {
      const bool valid = live && c < d;
      cp_async16(static_cast<float*>(dst) + swz(row, c, ld),
                 valid ? src + c : src, valid);
    }
  } else {
    // bytes of the row: d elements, zero-filled up to w
    constexpr int EB = Elem<KV>::bytes;
    const int cb = a.cpy, db = d * EB;
    const uint8_t* src = static_cast<const uint8_t*>(pool) +
                         (live ? ref.off * EB : 0);
    uint8_t* out = static_cast<uint8_t*>(dst) + row * code_ld<KV>(d);
    for (int c = cb * part; c < w * EB; c += cb * parts) {
      const bool valid = live && c < db;
      cp_async_n(out + c, valid ? src + c : src, valid, cb);
    }
    if constexpr (KV == kI8) {
      if (part == 0) {
        cp_async4(sc + row,
                  scale + (live ? (int64_t)ref.page * a.n_kv + kvh : 0),
                  live);
      }
    }
  }
}

template <int MAXD, int KV, typename QT>
__global__ void __launch_bounds__(Span<MAXD, KV>::NTHR)
ragged_span_kernel(Ragged a) {
  using S = Span<MAXD, KV>;
  constexpr int BM = S::BM, BN = S::BN, KG = S::KG, GTHR = S::GTHR;
  constexpr int NTHR = S::NTHR, NT = BN / 8, NTO = MAXD / 8, VLD = BN;
  constexpr bool SPLIT = S::SPLIT;
  static_assert(GTHR % BN == 0, "every thread owns one row of a tile");
  extern __shared__ float4 smem4[];
  const int d = a.d, ld = tile_ld(d), w = (d + 15) & ~15;
  const int tb = span_tile_bytes<KV>(BN, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // warps 16-row slices of the block's rows, in KG groups of key tiles
  const int m0 = 16 * (warp % (BM / 16)), kg = warp / (BM / 16);
  const int gtid = threadIdx.x - kg * GTHR;   // the thread within its group
  uint32_t* qbig = reinterpret_cast<uint32_t*>(smem4);   // [BM][ld]
  uint32_t* qsmall = qbig + BM * ld;                     // [BM][ld]
  uint8_t* region = reinterpret_cast<uint8_t*>(qsmall + BM * ld) +
                    kg * span_group_bytes<MAXD, KV>(d);
  uint8_t* kraw = region;                               // staged tiles
  uint8_t* vraw = kraw + tb;
  float* ksraw = reinterpret_cast<float*>(vraw + tb);   // [BN], int8
  float* vsraw = ksraw + BN;                            // [BN], int8
  uint32_t* kbig = reinterpret_cast<uint32_t*>(vsraw + BN);   // [BN][ld]
  uint32_t* ksmall = kbig + BN * ld;                          // SPLIT only
  uint32_t* vbig = kbig + (SPLIT ? 2 : 1) * BN * ld;   // [ld][VLD]
  uint32_t* vsmall = vbig + ld * VLD;                  // SPLIT only
  // the row of every staged tile this thread copies, and its part of it
  const int lrow = gtid % BN, lpart = gtid / BN;
  constexpr int PARTS = GTHR / BN;

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest first
  const int n_rep = a.n_q / a.n_kv, G = n_rep * a.T;
  const int start = __ldg(a.start_pos + b), qlen = __ldg(a.q_len + b);
  const int kend = rows_key_end(a, row0, BM, G, start, qlen);
  constexpr int STEP = KG * BN;   // a group's stride over the key tiles

  auto load_row = [&](const RowRef& ref) {
    load_span_row<KV>(kraw, ksraw, a.k_pool, a.k_scale, a, kvh, lrow, lpart,
                      PARTS, ref);
    load_span_row<KV>(vraw, vsraw, a.v_pool, a.v_scale, a, kvh, lrow, lpart,
                      PARTS, ref);
  };
  int k0 = kg * BN;   // this group's first tile
  if (k0 < kend) load_row(resolve_row(a, b, kvh, k0 + lrow, kend));
  cp_async_commit();
  RowRef next = resolve_row(a, b, kvh, k0 + STEP + lrow, kend);
  // the block's query rows, gathered from q [B, T, n_q, d] and split once
  // (rows past G and columns past d zero), under the first tiles' copies
  {
    const int gpr = w >> 2;
    for (int idx = threadIdx.x; idx < BM * gpr; idx += NTHR) {
      const int r = idx / gpr, c = 4 * (idx - r * gpr);
      const int row = row0 + r;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < G && c < d && kend > 0) {
        const int tt = row % a.T, head = kvh * n_rep + row / a.T;
        val = ldg4(static_cast<const QT*>(a.q) +
                   ((int64_t)(b * a.T + tt) * a.n_q + head) * d + c);
      }
      store_split4(qbig, qsmall, r, c, ld, val);
    }
  }
  __syncthreads();   // the Q planes are the block's

  // this lane's rows: g (h = 0) and g + 8 (h = 1)
  int last[2];   // the last visible key of each row, -1 for none
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + m0 + g + 8 * h, tt = row % a.T;
    last[h] = row < G && tt < qlen ? min(start + tt, kend - 1) : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (; k0 < kend; k0 += STEP) {
    cp_async_wait<0>();
    group_sync<KG, GTHR>(kg);   // the tile is staged; the planes are free
    if constexpr (KV == kF32) {
      const float* kf = reinterpret_cast<const float*>(kraw);
      const float* vf = reinterpret_cast<const float*>(vraw);
      planes_k<GTHR, true>(kbig, ksmall, BN, w, ld, gtid, [&](int r, int c) {
        return *reinterpret_cast<const float4*>(kf + swz(r, c, ld));
      });
      planes_vt<GTHR, true>(vbig, vsmall, BN, w, VLD, gtid,
                            [&](int r, int c) {
        return *reinterpret_cast<const float4*>(vf + swz(r, c, ld));
      });
    } else {
      // dequantize the codes: int8 times its page scale, rounded in fp32
      // as the plain version rounds it (then split); e4m3 and bf16 values
      // exact
      const int cld = code_ld<KV>(d);
      auto deq = [&](const uint8_t* raw, const float* sc, int r, int c) {
        float4 v = load4<KV>(raw + r * cld, c);
        if constexpr (KV == kI8) {
          const float s = sc[r];
          v = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
        }
        return v;
      };
      planes_k<GTHR, SPLIT>(kbig, ksmall, BN, w, ld, gtid, [&](int r, int c) {
        return deq(kraw, ksraw, r, c);
      });
      planes_vt<GTHR, SPLIT>(vbig, vsmall, BN, w, VLD, gtid,
                             [&](int r, int c) {
        return deq(vraw, vsraw, r, c);
      });
    }
    group_sync<KG, GTHR>(kg);   // the planes are ready, the staging free
    // the group's next tile's copy runs under this tile's products, and
    // the one after it has its table entry read meanwhile
    if (k0 + STEP < kend) load_row(next);
    cp_async_commit();
    next = resolve_row(a, b, kvh, k0 + 2 * STEP + lrow, kend);
    float s[NT][4];
    mma_qk<NT, MAXD, SPLIT, true>(s, qbig, qsmall, m0, kbig, ksmall, ld, d,
                                  g, t);
    // visibility and scale at each fragment element's (row, key)
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + 8 * i + 2 * t + (r & 1);
        s[i][r] = key <= last[r >> 1] ? s[i][r] * a.scale : kNegInf;
      }
    }
    online_softmax(s, m, l, acc);
    mma_pv<NT, NTO, SPLIT, true>(acc, s, vbig, vsmall, 0, VLD, d, g, t);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  if constexpr (KG == 2) {
    // merge: the second group's (m, l, acc) of each row through shared
    // memory (its region: [BM][ld] of acc, then [BM] of m and of l), into
    // the first group's
    float* macc = reinterpret_cast<float*>(
        reinterpret_cast<uint8_t*>(qsmall + BM * ld) +
        span_group_bytes<MAXD, KV>(d));
    float* mm = macc + BM * ld;
    float* ml = mm + BM;
    __syncthreads();   // every group is done with its region
    if (kg == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < NTO; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < d) {
            *reinterpret_cast<float2*>(macc + r * ld + col) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          }
        }
        if (t == 0) {
          mm[r] = m[h];
          ml[r] = l[h];
        }
      }
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      const float m1 = mm[r], mx = fmaxf(m[h], m1);
      const float f0 = expf(m[h] - mx), f1 = expf(m1 - mx);
      l[h] = l[h] * f0 + ml[r] * f1;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < d) {
          const float2 o = *reinterpret_cast<const float2*>(macc + r * ld +
                                                            col);
          acc[j][2 * h] = acc[j][2 * h] * f0 + o.x * f1;
          acc[j][2 * h + 1] = acc[j][2 * h + 1] * f0 + o.y * f1;
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + m0 + g + 8 * h;
    if (row < G) {
      const int tt = row % a.T, head = kvh * n_rep + row / a.T;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      QT* dst = static_cast<QT*>(a.out) +
                ((int64_t)(b * a.T + tt) * a.n_q + head) * d;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < d) {
          st2(dst + col, acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------- decode form

template <int MAXD, int KV>
struct Dec {
  static constexpr int NW = 4;   // warps, each on its own key tiles
  // key positions per warp tile: 4 KB of a tile's K rows at MAXD, at
  // most 16 (32 measured slower: fewer tiles to spread over the warps)
  static constexpr int KT_ = 4096 / (MAXD * Elem<KV>::bytes);
  static constexpr int KT = KT_ > 16 ? 16 : KT_;
  static constexpr int LPK = 32 / KT;   // lanes scoring one key
  static constexpr int NC = MAXD / 128 > 0 ? MAXD / 128 : 1;  // acc chunks
};

// Row stride (bytes) of a decode stage: the row plus 16 bytes for each
// lane that reads it, so the lanes' 16-byte reads fall in distinct banks.
template <int MAXD, int KV>
__host__ __device__ __forceinline__ int dec_row_bytes(int d) {
  return d * Elem<KV>::bytes + 16 * Dec<MAXD, KV>::LPK;
}

template <int MAXD, int KV>
__host__ __device__ __forceinline__ int dec_stage_bytes(int d) {
  return 2 * Dec<MAXD, KV>::KT * dec_row_bytes<MAXD, KV>(d) +
         (KV == kI8 ? 8 * Dec<MAXD, KV>::KT : 0);
}

template <int MAXD, int KV>
size_t dec_smem_bytes(int d) {
  constexpr int NW = Dec<MAXD, KV>::NW;
  const size_t stages = (size_t)NW * 2 * dec_stage_bytes<MAXD, KV>(d);
  const size_t merge = (size_t)NW * (kDecodeRows * d + 2 * kDecodeRows) * 4;
  return (size_t)kDecodeRows * d * 4 + (stages > merge ? stages : merge);
}

// CB: the bytes of one read of a key row from a stage (16, or 8 for 1-byte
// rows of d = 8 mod 16); the copies into the stage take a.cpy bytes.
template <int MAXD, int KV, int CB, typename QT>
__global__ void __launch_bounds__(32 * Dec<MAXD, KV>::NW)
ragged_decode_kernel(Ragged a) {
  using D = Dec<MAXD, KV>;
  constexpr int NW = D::NW, KT = D::KT, LPK = D::LPK, NC = D::NC;
  constexpr int EB = Elem<KV>::bytes, EPC = CB / EB;   // elements a read
  extern __shared__ float4 smem4[];
  const int d = a.d;
  float* qs = reinterpret_cast<float*>(smem4);   // [kDecodeRows][d]
  uint8_t* wbase = reinterpret_cast<uint8_t*>(qs + kDecodeRows * d);
  const int rsb = dec_row_bytes<MAXD, KV>(d);
  const int sb = dec_stage_bytes<MAXD, KV>(d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* mine = wbase + warp * 2 * sb;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int n_rep = a.n_q / a.n_kv, G = n_rep * a.T;
  const int start = __ldg(a.start_pos + b), qlen = __ldg(a.q_len + b);
  const int kend = rows_key_end(a, 0, G, G, start, qlen);
  const int ntiles = (kend + KT - 1) / KT;

  // warp tile j into stage st: K rows, V rows (and int8 page scales)
  // each lane copies one row of every warp tile (its part of it), the
  // row's table entry read a tile ahead
  const int lrow = lane % KT, lpart = lane / KT;
  auto resolve = [&](int j) {
    return resolve_row(a, b, kvh, j * KT + lrow, kend);
  };
  // warp tile j into stage st: K rows, V rows (and int8 page scales)
  auto load = [&](int st, const RowRef& ref) {
    uint8_t* kd = mine + st * sb;
    uint8_t* vd = kd + KT * rsb;
    const int cb = a.cpy;
    const bool live = ref.off >= 0;
    const int64_t off = live ? ref.off * EB : 0;
    const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool) + off;
    const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool) + off;
    for (int c = cb * lpart; c < d * EB; c += cb * LPK) {
      cp_async_n(kd + lrow * rsb + c, live ? kp + c : kp, live, cb);
      cp_async_n(vd + lrow * rsb + c, live ? vp + c : vp, live, cb);
    }
    if constexpr (KV == kI8) {
      if (lpart == 0) {
        float* sc = reinterpret_cast<float*>(vd + KT * rsb);   // [2][KT]
        const int64_t so = live ? (int64_t)ref.page * a.n_kv + kvh : 0;
        cp_async4(sc + lrow, a.k_scale + so, live);
        cp_async4(sc + KT + lrow, a.v_scale + so, live);
      }
    }
  };

  int j = warp, st = 0;
  if (j < ntiles) load(0, resolve(j));
  cp_async_commit();
  RowRef next = resolve(j + NW);
  // the G query rows (rows past G stay unread)
  for (int idx = threadIdx.x; idx < G * (d / 4); idx += 32 * NW) {
    const int r = idx / (d / 4), c = 4 * (idx - r * (d / 4));
    const int tt = r % a.T, head = kvh * n_rep + r / a.T;
    *reinterpret_cast<float4*>(qs + r * d + c) =
        ldg4(static_cast<const QT*>(a.q) +
             ((int64_t)(b * a.T + tt) * a.n_q + head) * d + c);
  }
  __syncthreads();

  int last[kDecodeRows];   // each row's last visible key, -1 for none
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) {
    const int tt = r % a.T;
    last[r] = r < G && tt < qlen ? min(start + tt, kend - 1) : -1;
  }
  float m[kDecodeRows], l[kDecodeRows];
  float4 acc[kDecodeRows][NC];
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int kk = lane / LPK, part = lane % LPK;   // this lane's key, part

  for (; j < ntiles; j += NW, st ^= 1) {
    if (j + NW < ntiles) load(st ^ 1, next);
    cp_async_commit();
    next = resolve(j + 2 * NW);
    cp_async_wait<1>();
    __syncwarp();
    const uint8_t* kt = mine + st * sb;
    const uint8_t* vt = kt + KT * rsb;
    const int key = j * KT + kk;

    // int8: the page scales of this lane's key and of every key's V
    const float* sc = reinterpret_cast<const float*>(vt + KT * rsb);
    // q . k of this lane's key for every row, over its parts of d
    float sg[kDecodeRows];
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) sg[r] = 0.f;
    for (int c = part * CB; c < d * EB; c += LPK * CB) {
      const int e0 = c / EB;   // the first element of this read
      float kv[EPC];
#pragma unroll
      for (int w = 0; w < EPC / 4; ++w) {
        const float4 v4 = load4<KV>(kt + kk * rsb, e0 + 4 * w);
        kv[4 * w] = v4.x; kv[4 * w + 1] = v4.y;
        kv[4 * w + 2] = v4.z; kv[4 * w + 3] = v4.w;
      }
      if constexpr (KV == kI8) {
        // code * scale, rounded in fp32 as the plain version rounds it
#pragma unroll
        for (int e = 0; e < EPC; ++e) kv[e] *= sc[kk];
      }
#pragma unroll
      for (int r = 0; r < kDecodeRows; ++r) {
        if (r < G) {
#pragma unroll
          for (int w = 0; w < EPC / 4; ++w) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + r * d + e0 + 4 * w);
            sg[r] += qv.x * kv[4 * w] + qv.y * kv[4 * w + 1] +
                     qv.z * kv[4 * w + 2] + qv.w * kv[4 * w + 3];
          }
        }
      }
    }
    float p[kDecodeRows];
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) {
      p[r] = 0.f;
      if (r >= G) continue;   // uniform across the block
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1) {
        sg[r] += __shfl_xor_sync(0xffffffffu, sg[r], o);
      }
      const float s = key <= last[r] ? sg[r] * a.scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      const float pr = s <= kMaskedBelow ? 0.f : expf(s - m_new);
      float ps = pr;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      }
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[r][i].x *= corr; acc[r][i].y *= corr;
        acc[r][i].z *= corr; acc[r][i].w *= corr;
      }
      p[r] = pr;
    }
    // acc += P V over the tile's keys; each lane owns float4 column chunks
#pragma unroll 4
    for (int k2 = 0; k2 < KT; ++k2) {
      float4 vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = 4 * (lane + 32 * i);
        vv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < d) {
          vv[i] = load4<KV>(vt + k2 * rsb, col);
          if constexpr (KV == kI8) {
            const float vs = sc[KT + k2];
            vv[i] = make_float4(vv[i].x * vs, vv[i].y * vs, vv[i].z * vs,
                                vv[i].w * vs);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kDecodeRows; ++r) {
        if (r < G) {
          const float pk = __shfl_sync(0xffffffffu, p[r], k2 * LPK);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            acc[r][i].x += pk * vv[i].x; acc[r][i].y += pk * vv[i].y;
            acc[r][i].z += pk * vv[i].z; acc[r][i].w += pk * vv[i].w;
          }
        }
      }
    }
    __syncwarp();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with its stages

  // merge the warps' (m, l, acc): [NW][kDecodeRows][d] partial outputs,
  // then [NW][kDecodeRows] of m and of l
  float* macc = reinterpret_cast<float*>(wbase);
  float* mm = macc + NW * kDecodeRows * d;
  float* ml = mm + NW * kDecodeRows;
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) {
    if (r < G) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = 4 * (lane + 32 * i);
        if (col < d) {
          *reinterpret_cast<float4*>(macc + (warp * kDecodeRows + r) * d +
                                     col) = acc[r][i];
        }
      }
      if (lane == 0) {
        mm[warp * kDecodeRows + r] = m[r];
        ml[warp * kDecodeRows + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * (d / 4); idx += 32 * NW) {
    const int r = idx / (d / 4), c = 4 * (idx - r * (d / 4));
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, mm[w * kDecodeRows + r]);
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(mm[w * kDecodeRows + r] - mx);
      const float4 v4 = *reinterpret_cast<const float4*>(
          macc + (w * kDecodeRows + r) * d + c);
      den += f * ml[w * kDecodeRows + r];
      num.x += f * v4.x; num.y += f * v4.y;
      num.z += f * v4.z; num.w += f * v4.w;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int tt = r % a.T, head = kvh * n_rep + r / a.T;
    st4(static_cast<QT*>(a.out) +
            ((int64_t)(b * a.T + tt) * a.n_q + head) * d + c,
        make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
  }
}

// ------------------------------------------------------------ launches

template <int MAXD, int KV, typename QT>
cudaError_t launch_span(const Ragged& a, int B, cudaStream_t stream) {
  using S = Span<MAXD, KV>;
  const size_t smem = span_smem_bytes<MAXD, KV>(a.d);
  cudaError_t err = opt_in(ragged_span_kernel<MAXD, KV, QT>, smem);
  if (err != cudaSuccess) return err;
  const int G = (a.n_q / a.n_kv) * a.T;
  const dim3 grid((G + S::BM - 1) / S::BM, a.n_kv, B);
  ragged_span_kernel<MAXD, KV, QT><<<grid, S::NTHR, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MAXD, int KV, int CB, typename QT>
cudaError_t launch_decode_cb(const Ragged& a, int B, cudaStream_t stream) {
  const size_t smem = dec_smem_bytes<MAXD, KV>(a.d);
  cudaError_t err = opt_in(ragged_decode_kernel<MAXD, KV, CB, QT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_kv, B);
  ragged_decode_kernel<MAXD, KV, CB, QT>
      <<<grid, 32 * Dec<MAXD, KV>::NW, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MAXD, int KV, typename QT>
cudaError_t launch_decode(const Ragged& a, int B, cudaStream_t stream) {
  // 8-byte reads only for 1-byte rows of d = 8 mod 16 (fp32 and bf16 rows
  // are whole 16-byte chunks)
  if constexpr (Elem<KV>::bytes == 1) {
    if (a.d % 16 != 0) return launch_decode_cb<MAXD, KV, 8, QT>(a, B, stream);
  }
  return launch_decode_cb<MAXD, KV, 16, QT>(a, B, stream);
}

template <int KV, typename QT>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* table,
             const void* start_pos, const void* q_len, void* out,
             const ragged::Split* split, int B, int T, int n_q, int n_kv,
             int d, int page_size, int pages_per_seq, int form, float scale,
             void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 256 || n_kv <= 0 || n_q % n_kv != 0 ||
      page_size <= 0 || (form != 0 && form != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (KV == kI8 && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // the decode form holds at most kDecodeRows grouped rows
  if (form == 1 && (n_q / n_kv) * T > kDecodeRows) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-bit q's split walk (the decode form at d <= 128): splits of a whole
  // number of its warp tiles, enough of them for the table's longest
  // walk, and the workspace and tickets wherever a walk can take two
  if (split != nullptr && form == 1 && d <= 128 &&
      (split->keys_per_split <= 0 || split->keys_per_split % 16 != 0 ||
       split->n_splits < 1 ||
       (int64_t)split->n_splits * split->keys_per_split <
           (int64_t)pages_per_seq * page_size ||
       (split->n_splits > 1 &&
        (split->part == nullptr || split->tickets == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0) return (int)cudaSuccess;
  // a pool row's copies: 16 bytes where the rows and both pools are 16-byte
  // aligned (fp32 pools always are), else 8 or 4
  int cpy = (d * Elem<KV>::bytes) % 16 == 0 ? 16 : 8;
  while (((uintptr_t)k_pool | (uintptr_t)v_pool) % cpy) cpy /= 2;
  if (cpy < 4) return (int)cudaErrorMisalignedAddress;
  const Ragged a{q, k_pool, v_pool,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int32_t*>(table),
                 static_cast<const int32_t*>(start_pos),
                 static_cast<const int32_t*>(q_len), out,
                 T, n_q, n_kv, d, page_size, pages_per_seq, scale, cpy};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (!std::is_same_v<QT, float>) {
    // bf16 or fp16 q: for d <= 128 the wgmma span form and the split walk
    // (ragged_paged_attention_bf16.cu), above this file's forms
    if (split == nullptr) return (int)cudaErrorInvalidValue;
    if (d > 128) {
      return form == 1 ? (int)launch_decode<256, KV, QT>(a, B, st)
                       : (int)launch_span<256, KV, QT>(a, B, st);
    }
    return form == 1 ? (int)ragged::launch_decode_split<QT>(a, *split, KV,
                                                            B, st)
                     : (int)ragged::launch_span16<QT>(a, KV, B, st);
  } else {
    if (form == 1) {
      return d <= 128 ? (int)launch_decode<128, KV, QT>(a, B, st)
                      : (int)launch_decode<256, KV, QT>(a, B, st);
    }
    return d <= 128 ? (int)launch_span<128, KV, QT>(a, B, st)
                    : (int)launch_span<256, KV, QT>(a, B, st);
  }
}

}  // namespace

// form: 0 = the span form (tensor cores), 1 = the decode form (n_q / n_kv
// * T <= 8); the wrapper chooses (ops/ragged_paged_attention.py
// ragged_form).

// fp32 pools (K1)
extern "C" int ragged_paged_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start_pos, const void* q_len, void* out, int B, int T,
    int n_q, int n_kv, int d, int page_size, int pages_per_seq, int form,
    float scale, void* stream) {
  return dispatch<kF32, float>(q, k_pool, v_pool, nullptr, nullptr, table,
                        start_pos, q_len, out, nullptr, B, T, n_q, n_kv, d,
                        page_size, pages_per_seq, form, scale, stream);
}

// int8 code pools with k_scale / v_scale [N, n_kv] fp32 (K1-q)
extern "C" int ragged_paged_attention_i8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* start_pos, const void* q_len, void* out, int B, int T,
    int n_q, int n_kv, int d, int page_size, int pages_per_seq, int form,
    float scale, void* stream) {
  return dispatch<kI8, float>(q, k_pool, v_pool, k_scale, v_scale, table,
                       start_pos, q_len, out, nullptr, B, T, n_q, n_kv, d,
                       page_size, pages_per_seq, form, scale, stream);
}

// float8_e4m3fn pools (K1-q)
extern "C" int ragged_paged_attention_f8(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start_pos, const void* q_len, void* out, int B, int T,
    int n_q, int n_kv, int d, int page_size, int pages_per_seq, int form,
    float scale, void* stream) {
  return dispatch<kF8, float>(q, k_pool, v_pool, nullptr, nullptr, table,
                       start_pos, q_len, out, nullptr, B, T, n_q, n_kv, d,
                       page_size, pages_per_seq, form, scale, stream);
}

// bf16 q (K1-bf16, K1-q with bf16 q; a bf16 output), with the split
// walk's workspace part (B * n_kv * n_splits * G * (d + 2) floats, written
// before it is read; null where n_splits is 1) and tickets (B * n_kv int32
// zeros, left zero by the kernel; null where n_splits is 1), then
// keys_per_split and n_splits (ops/ragged_paged_attention.py
// decode_splits).

// bf16 q over bf16 pools (K1-bf16)
extern "C" int ragged_paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start_pos, const void* q_len, void* out, void* part,
    void* tickets, int B, int T, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int form, int keys_per_split, int n_splits,
    float scale, void* stream) {
  const ragged::Split split{static_cast<float*>(part),
                            static_cast<int32_t*>(tickets), keys_per_split,
                            n_splits};
  return dispatch<kBF16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, table, start_pos, q_len, out,
      &split, B, T, n_q, n_kv, d, page_size, pages_per_seq, form, scale,
      stream);
}

// bf16 q over int8 code pools with fp32 scales (K1-q)
extern "C" int ragged_paged_attention_bf16_i8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* start_pos, const void* q_len, void* out, void* part,
    void* tickets, int B, int T, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int form, int keys_per_split, int n_splits,
    float scale, void* stream) {
  const ragged::Split split{static_cast<float*>(part),
                            static_cast<int32_t*>(tickets), keys_per_split,
                            n_splits};
  return dispatch<kI8, __nv_bfloat16>(
      q, k_pool, v_pool, k_scale, v_scale, table, start_pos, q_len, out,
      &split, B, T, n_q, n_kv, d, page_size, pages_per_seq, form, scale,
      stream);
}

// bf16 q over float8_e4m3fn pools (K1-q)
extern "C" int ragged_paged_attention_bf16_f8(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start_pos, const void* q_len, void* out, void* part,
    void* tickets, int B, int T, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int form, int keys_per_split, int n_splits,
    float scale, void* stream) {
  const ragged::Split split{static_cast<float*>(part),
                            static_cast<int32_t*>(tickets), keys_per_split,
                            n_splits};
  return dispatch<kF8, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, table, start_pos, q_len, out,
      &split, B, T, n_q, n_kv, d, page_size, pages_per_seq, form, scale,
      stream);
}

// fp16 q (K1-fp16, K1-q with fp16 q; an fp16 output), with the split
// walk's workspace and tickets as bf16 q's

// fp16 q over fp16 pools (K1-fp16)
extern "C" int ragged_paged_attention_f16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start_pos, const void* q_len, void* out, void* part,
    void* tickets, int B, int T, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int form, int keys_per_split, int n_splits,
    float scale, void* stream) {
  const ragged::Split split{static_cast<float*>(part),
                            static_cast<int32_t*>(tickets), keys_per_split,
                            n_splits};
  return dispatch<kFP16, __half>(
      q, k_pool, v_pool, nullptr, nullptr, table, start_pos, q_len, out,
      &split, B, T, n_q, n_kv, d, page_size, pages_per_seq, form, scale,
      stream);
}

// fp16 q over int8 code pools with fp32 scales (K1-q)
extern "C" int ragged_paged_attention_f16_i8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* start_pos, const void* q_len, void* out, void* part,
    void* tickets, int B, int T, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int form, int keys_per_split, int n_splits,
    float scale, void* stream) {
  const ragged::Split split{static_cast<float*>(part),
                            static_cast<int32_t*>(tickets), keys_per_split,
                            n_splits};
  return dispatch<kI8, __half>(
      q, k_pool, v_pool, k_scale, v_scale, table, start_pos, q_len, out,
      &split, B, T, n_q, n_kv, d, page_size, pages_per_seq, form, scale,
      stream);
}

// fp16 q over float8_e4m3fn pools (K1-q)
extern "C" int ragged_paged_attention_f16_f8(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start_pos, const void* q_len, void* out, void* part,
    void* tickets, int B, int T, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int form, int keys_per_split, int n_splits,
    float scale, void* stream) {
  const ragged::Split split{static_cast<float*>(part),
                            static_cast<int32_t*>(tickets), keys_per_split,
                            n_splits};
  return dispatch<kF8, __half>(
      q, k_pool, v_pool, nullptr, nullptr, table, start_pos, q_len, out,
      &split, B, T, n_q, n_kv, d, page_size, pages_per_seq, form, scale,
      stream);
}
