// Ragged paged attention with 16-bit queries for Hopper, sm_90a, head
// dims d <= 128: the span form and the decode form with bf16 q over bf16
// pools (K1-bf16) and int8 / float8_e4m3fn pools (K1-q with bf16 q), and
// with fp16 q over fp16 pools (K1-fp16) and int8 / float8_e4m3fn pools
// (K1-q with fp16 q; the fp16 paragraph at the end). The entry points, and
// both forms for d > 128 (the tf32 span form, the unsplit decode form),
// are in ragged_paged_attention.cu.
//
// Replaces: paddle_tpu/ops/pallas/ragged_paged_attention.py ::
//   ragged_paged_attention (kernel body _ragged_kernel; tiles cast to fp32
//   at :98-100, the int8 page scales at :101-109, the output in q's type
//   at :139).
//
// What they compute is ragged_paged_attention.cu's contract: causal
// attention for a ragged batch of query spans off the paged pools, GQA
// rows r = (rep, t) with t = r % T, rows t >= q_len and dead slots exactly
// 0, softmax and sums in fp32, the output rounded to q's type where it is
// written.
//
// Span form (G = n_rep * T > kDecodeRows: prefill chunks, long GQA spans),
// ragged_span_bf16_kernel, d <= 128. At the serving chunk it does 4 d
// FLOPs per visible (row, key) pair against one read of the pages, so the
// products bound it, at bf16 tensor-core rates. Design:
// - one block per (sequence, kv head, BM = 64 grouped rows), two key
//   groups of one warpgroup each walking alternate tiles of BN = 32 keys
//   and merging their softmax states at the end (SpanB; the grid and ring
//   chosen with tools/k1_bf16_variants.py on the card);
// - each group streams its tiles through a cp.async ring of three stages,
//   each thread copying one row of every tile (four threads a row, on
//   neighbouring 16-byte chunks), the row's table entry read two tiles
//   ahead of its copy; rows past the block's last visible key zero-filled
//   and tiles wholly past it neither loaded nor multiplied. bf16 pools are
//   copied as they are into tiles in the 128-byte swizzle the wgmma
//   descriptors read (sm90_wgmma.cuh); 1-byte pools are staged as bytes
//   and widened once into such bf16 tiles (two, alternating), each thread
//   widening the bytes it copied, the next tile's under this tile's P V
//   (its K under the S product instead measured slower):
//   an e4m3 value and an int8 code are exact in bf16 (codes16x4), an
//   fp8 NaN stays NaN. One group barrier a tile either way, after a proxy
//   fence for the wgmma's reads;
// - the block's Q fragments are read from q once into registers (the
//   wgmma A operand, mma.sync's A layout); S = Q K^T is a chain of
//   wgmma.m64n32k16 (bf16 operands, fp32 sums: a bf16 x bf16 product is
//   exact in fp32) over d with K K-major in shared memory; O += P V is
//   wgmma.m64n128k16 with P split in registers into three bf16 terms
//   (split3: P within ~2^-25) from the S accumulators, the smallest
//   first a 16-key step, V an MN-major operand. d < 128 zero-pads q and K
//   up to d
//   rounded to 16 and leaves the rest of the output columns unstored;
// - int8 pools: the key's page k scale multiplies S's column where the
//   visibility applies; the v scale is folded into P before its split,
//   while l sums the unscaled P. That rounds otherwise than the plain
//   version's fp32 code * scale, within the bf16 gates (chip_smoke.py);
// - visibility per accumulator element (t = r % T < q_len, key <= start +
//   t): a hidden key gives p = 0 exactly, a row with no visible key ends
//   with l = 0 and writes zeros.
//
// Decode form (G <= kDecodeRows: decode steps, verify spans, short GQA
// spans), ragged_decode_split_kernel, d <= 128: the page bytes bound it (4
// G d FLOPs per key against 2 d elements of K and V). Design
// (flash-decoding, K2's split walk: paged_decode_attention.cu):
// - each (sequence, kv head)'s visible keys are cut into splits of
//   keys_per_split keys (the wrapper's constant, 256, never derived from
//   the batch); the work list holds every split of every sequence, n_kv
//   heads each, sequence-major, and each block scans the sequences' split
//   counts from start_pos and q_len on the device, so the host never reads
//   them. A persistent grid of up to two blocks an SM takes items k, k +
//   grid, ...;
// - inside a split, four warps own interleaved tiles of KT = 16 keys, each
//   through a private ring of three cp.async stages, two tiles ahead of
//   the one multiplied; the split's pages are read once into shared memory
//   at the item's start, so no copy waits on a table read, and neighbouring
//   lanes copy neighbouring chunks of a row. The G <= 8 rows are padded to
//   the 16 rows of an mma.sync.m16n8k16 tile (their Q fragments read once
//   an item into registers): S = Q K^T one bf16 mma a 16-deep step, O += P
//   V three, P in three bf16 terms, as the span form; 1-byte
//   pools widened once to a bf16 tile by the lanes that copied them, int8
//   scales as in the span form. A first design on the CUDA cores (four
//   then eight warps scoring keys lane by lane, fp32 q's arithmetic) spent
//   its time on the rows' shared-memory reads and shuffles and lost to
//   SDPA at the verify spans and MHA decode (PERF.md). One row (G = 1:
//   MHA decode) takes ragged_decode_row_kernel instead, K2's walk on the
//   CUDA cores inside each split (a 16-row tile would be 15 rows empty),
//   up to eight blocks an SM;
// - the warps merge their fp32 (m, l, acc) in warp order. A sequence of
//   one split writes its output there. Otherwise each split writes its
//   rows' (acc, m, l) to the workspace, and the block that takes the
//   (sequence, kv head)'s ticket last (atomicAdd after __threadfence)
//   merges the splits in split order and resets the ticket to 0. A split
//   with no visible key (m = -1e30, l = 0) weighs 0 in the merge; a row
//   without keys gets zeros. A fixed merge order and a batch-independent
//   split size: a row's output does not depend on the rest of the batch or
//   on the grid, bit for bit.
//
// Wider heads (d > 128) take the forms of ragged_paged_attention.cu:
// the tf32 span form and the unsplit decode form.
//
// fp16 q (ragged_span_f16_kernel, ragged_decode_split_f16_kernel,
// ragged_decode_row_f16_kernel) runs the same bodies, templated on the
// 16-bit type H of bf16_mma.cuh (kBf16, kF16) as the flash kernels are:
// fp16 operands and products, fp32 sums, and three changes for fp16's
// range (2^-24 .. 65504, where bf16 has fp32's):
// - P times a power of two F before its split (p_factor), so its terms
//   stay normal fp16 where bf16's would: over fp16 and fp8 pools F = 2^14
//   (P <= 1, so P F <= 2^14, the fp16 flash kernels' kPScale); over int8
//   pools, where each key's v scale is folded into P, F is chosen per row
//   from w, the row's largest P vs so far (in units of its running max m,
//   so w shrinks with l and acc), F w in [2^13, 2^14): P vs F <= 2^14
//   whatever the page scales are, and the keys that weigh most in the row
//   keep all three terms normal. A row whose F changes rescales its acc by
//   the ratio (two powers of two: exact), and acc is divided by F at the
//   end of the walk. Without F a page scale of 1e-2 makes every P below
//   ~6e-3 subnormal before its split, and one of 1e-6 flushes a page; with
//   one F a tile, from the tile's largest v scale, a row whose weight lies
//   on a page of scale 1e-6 beside one of 1e2 in the same tile keeps ~12
//   bits of it (tests/test_torch_ragged_f16_numerics.py models all three);
// - P in three fp16 terms, as bf16's three: fp16 carries 11 bits a term,
//   so two terms of P F would hold P within ~2^-22, but the three-term
//   design is kept whole (PERF.md §6: every gate at all three pool kinds
//   holds with it; two terms were not tried on the card);
// - the codes widened to fp16 (codes16x4): an int8 code c as the fp16
//   1024 + 128 + c (its biased byte in the low mantissa bits of 2^10) less
//   1152, exactly; an e4m3 value through the conversion to fp16, exact (an
//   fp8 NaN stays NaN).
// The row kernel multiplies V by its scale in fp32 on the CUDA cores and
// needs none of this.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "ragged_common.cuh"
#include "sm90_wgmma.cuh"

namespace {

// The C++ type of the 16-bit element type H (bf16_mma.cuh's kBf16, kF16),
// which is q's, the output's and the 16-bit pools' type.
template <int H>
using Half = std::conditional_t<H == kF16, __half, __nv_bfloat16>;

// A key row of the walk, resolved through the block table ahead of its
// copy: the table entry is loaded here and first used where the copy is
// issued (key_off), tiles later, so the load's latency passes under the
// tiles' work instead of stalling the thread where it is read.
struct KeyRef {
  int page;   // the table entry (loaded)
  int pos;    // the key position, -1 past the walk
};

__device__ __forceinline__ KeyRef key_ref(const Ragged& a, int b, int kpos,
                                          int kend) {
  KeyRef ref{0, -1};
  if (kpos < kend) {
    ref.page = __ldg(a.table + (int64_t)b * a.pages_per_seq +
                     kpos / a.page_size);
    ref.pos = kpos;
  }
  return ref;
}

// The element offset of a live key's row of kv head kvh in a pool.
__device__ __forceinline__ int64_t key_off(const Ragged& a, int kvh,
                                           const KeyRef& ref) {
  return (((int64_t)ref.page * a.page_size + ref.pos % a.page_size) *
              a.n_kv + kvh) * a.d;
}

// Four codes of a 1-byte pool (little-endian in w) as four values of the
// 16-bit type H, exactly. bf16: an int8 code c is the float with byte c +
// 128 in the low mantissa bits of 2^23, less 2^23 + 128, and with at most
// 8 significant bits its bf16 is its top half; an e4m3 value through
// codes4 (an fp8 NaN stays NaN; on the bits of its half instead, measured
// slower). fp16: an int8 code c is the fp16 with byte c + 128 in the low
// mantissa bits of 2^10 (bits 0x64 above it), less 1152 (an exact fp16
// subtraction); an e4m3 value is converted to fp16, exactly (NaN stays
// NaN).
template <int H, int KV>
__device__ __forceinline__ uint2 codes16x4(uint32_t w) {
  if constexpr (H == kF16) {
    if constexpr (KV == kI8) {
      const uint32_t u = w ^ 0x80808080u;
      uint32_t b[2] = {__byte_perm(u, 0x64646464u, 0x4140u),
                       __byte_perm(u, 0x64646464u, 0x4342u)};
      const __half2 off = __float2half2_rn(1152.f);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const __half2 c = __hsub2(*reinterpret_cast<const __half2*>(&b[k]),
                                  off);
        b[k] = *reinterpret_cast<const uint32_t*>(&c);
      }
      return make_uint2(b[0], b[1]);
    } else {
      const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
      const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
      return make_uint2(lo.x | (uint32_t)lo.y << 16,
                        hi.x | (uint32_t)hi.y << 16);
    }
  } else if constexpr (KV == kI8) {
    const uint32_t u = w ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + k)) -
          8388736.f);
    }
    return make_uint2(__byte_perm(f[0], f[1], 0x7632u),
                      __byte_perm(f[2], f[3], 0x7632u));
  } else {
    const float4 v = codes4<KV>(w);
    return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// P in three terms of the 16-bit type H: hi = H(p), mid = H(p - hi), lo =
// H(p - hi - mid) (each difference exact in fp32), so hi + mid + lo is p
// within ~2^-25 |p| at bf16: with two bf16 terms (~2^-17) the tensor-core
// forms rounded ~10x more outputs to another bf16 than the plain version
// does, enough to part a 2-layer bf16 model from its gather path beyond
// chip_smoke.py's gate. fp16 terms hold 11 bits each, for p scaled into
// fp16's normal range first (p_factor).
template <int H>
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                      uint32_t& mid, uint32_t& lo) {
  if constexpr (H == kF16) {
    const __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    const float r0 = x0 - hf.x, r1 = x1 - hf.y;
    const __half2 m = __floats2half2_rn(r0, r1);
    const float2 mf = __half22float2(m);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    mid = *reinterpret_cast<const uint32_t*>(&m);
    lo = pack_f16(r0 - mf.x, r1 - mf.y);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const float r0 = x0 - hf.x, r1 = x1 - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m);
    hi = bf16x2_bits(h);
    mid = bf16x2_bits(m);
    lo = pack_bf16(r0 - mf.x, r1 - mf.y);
  }
}

// The three-term A fragments of the k-step over columns 16 m .. 16 m + 16
// of a warp's C fragments c (split_frag_a's layout).
template <int H, int NT>
__device__ __forceinline__ void split3_frag_a(const float (&c)[NT][4], int m,
                                              uint32_t (&hi)[4],
                                              uint32_t (&mid)[4],
                                              uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 2 * m + (q >> 1), r = 2 * (q & 1);
    split3<H>(c[i][r], c[i][r + 1], hi[q], mid[q], lo[q]);
  }
}

// fp16 q: P's factor over fp16 and fp8 pools, and the walk's first F
// (2^14, the fp16 flash kernels' kPScale: P <= 1, so P F <= 2^14)
constexpr float kPFactor = 16384.f;

// fp16 q: the power of two F that a row's P is multiplied by before its
// split (the header's fp16 paragraph). w is the row's largest P vs so far
// (int8 pools; the row's lanes agree on it), F its current factor: F w in
// [2^13, 2^14), or F kept where the row has no positive finite weight yet
// (its keys are hidden or zero-filled).
__device__ __forceinline__ float p_factor(float w, float F) {
  if (!(w > 0.f) || !isfinite(w)) return F;
  int e;
  frexpf(w, &e);   // w = m 2^e, m in [0.5, 1)
  return ldexpf(1.f, 14 - e);
}

// The fp16 walk's factors of P, for the fragment rows g (h = 0) and g + 8
// (h = 1): F[h] the row's factor and acc's unit, w[h] its largest P vs so
// far (int8 pools), m_prev[h] its running max before this tile.
struct PFactor {
  float F[2] = {kPFactor, kPFactor};
  float w[2] = {0.f, 0.f};
  float m_prev[2];
};

// P F for fp16 q at the keys' v scales vs (int8 pools; 1 otherwise), after
// online_softmax has made s this tile's P at the running max m: over int8
// pools each row's w is moved to m and raised to the tile's largest P vs,
// its F chosen (p_factor) and its acc moved from the last F to it by the
// two powers of two's ratio, exact. kcol(i, r) is the tile column of
// fragment element (i, r), vs(k) the v scale of column k.
template <int KV, int NT, int NTO, typename Col, typename Scale>
__device__ __forceinline__ void scale_p_f16(float (&s)[NT][4],
                                            float (&acc)[NTO][4],
                                            PFactor& pf, const float (&m)[2],
                                            Col kcol, Scale vs) {
  if constexpr (KV == kI8) {
    float x[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[i][r] *= vs(kcol(i, r));
        x[r >> 1] = fmaxf(x[r >> 1], s[i][r]);
      }
    }
    float ratio[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[h] = fmaxf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 1));
      x[h] = fmaxf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 2));
      pf.w[h] = fmaxf(pf.w[h] * expf(pf.m_prev[h] - m[h]), x[h]);
      const float f = p_factor(pf.w[h], pf.F[h]);
      ratio[h] = f / pf.F[h];
      pf.F[h] = f;
    }
    if (ratio[0] != 1.f || ratio[1] != 1.f) {
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] *= ratio[r >> 1];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) s[i][r] *= pf.F[r >> 1];
  }
}

// acc / F at the end of an fp16 walk (each row's F a power of two: exact).
template <int NTO>
__device__ __forceinline__ void unscale_acc(float (&acc)[NTO][4],
                                            const PFactor& pf) {
  const float u[2] = {1.f / pf.F[0], 1.f / pf.F[1]};
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] *= u[r >> 1];
  }
}

// ------------------------------------------------------------ span form

template <int KV>
struct SpanB {
  static constexpr int MAXD = 128;
  // key groups (a warpgroup each, on alternate tiles), keys a tile, ring
  // stages a group
  static constexpr int KG = 2, BN = 32, STAGES = 3;
  static constexpr int BM = 64;          // grouped query rows per block
  static constexpr int GTHR = 128, NTHR = KG * GTHR;
  static constexpr bool WIDEN = Elem<KV>::bytes == 1;   // 1-byte pools
  // bytes of one 16-bit tile (K or V): MAXD / 64 boxes of BN rows of 128
  // bytes
  static constexpr int TILE = (MAXD / 64) * BN * 128;
};

// Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r of a bf16
// tile of R rows: boxes of 64 columns R * 128 bytes apart, rows of 128
// bytes, chunk c ^ (r mod 8) within its row (the 128-byte swizzle a TMA
// box with CU_TENSOR_MAP_SWIZZLE_128B takes, which the wgmma descriptors
// of sm90_wgmma.cuh read).
template <int R>
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The descriptor of k-step kk (16 columns) of a K-major tile of R rows,
// and of k-step mm (rows 16 mm .. + 16) of an MN-major one
// (flash_attention_wgmma.cu's kmajor_desc and mnmajor_desc).
template <int R>
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}

template <int R>
__device__ __forceinline__ uint64_t mn_desc(uint32_t tile, int mm) {
  return sw128_desc(tile + mm * 16 * 128, R * 128, 1024);
}

// d (+)= a b^T for one 16-deep k-step: a a 64 x 16 register operand of
// the 16-bit type H (a warp's 16 rows in mma.sync's A layout), b 32 rows
// of a K-major tile.
#define WGMMA_RS_K_N32(TY)                                                  \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, "  \
      "p, 1, 1, 0;\n}\n"                                                    \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),         \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),         \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),         \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))
template <int H>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[4][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  if constexpr (H == kF16) {
    WGMMA_RS_K_N32("f16");
  } else {
    WGMMA_RS_K_N32("bf16");
  }
}
#undef WGMMA_RS_K_N32

// Make this thread's writes to shared memory (cp.async copies, stores)
// visible to the wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bytes of one raw stage of a 1-byte pool: the K and V code rows (rows of
// code_ld(d) bytes), then for int8 their page scales [2][BN].
template <int KV>
__host__ __device__ __forceinline__ int sb_raw(int d) {
  return 2 * SpanB<KV>::BN * code_ld<KV>(d) +
         (KV == kI8 ? 8 * SpanB<KV>::BN : 0);
}

// Bytes of one key group's region, a multiple of 1024: 16-bit pools the
// ring of (K, V) tiles; 1-byte pools two (K, V) pairs of widened tiles,
// then the ring of raw stages.
template <int KV>
__host__ __device__ __forceinline__ int sb_group(int d) {
  using S = SpanB<KV>;
  const int bytes = S::WIDEN ? 4 * S::TILE + S::STAGES * sb_raw<KV>(d)
                             : 2 * S::STAGES * S::TILE;
  return (bytes + 1023) & ~1023;
}

// Shared memory: 1024 bytes of alignment slack, the key groups' regions;
// the merge of the groups' states ([BM][d + 4] of acc, [BM] of m and of
// l) reuses them from the start.
template <int KV>
size_t span_bf16_smem(int d) {
  using S = SpanB<KV>;
  const size_t groups = (size_t)S::KG * sb_group<KV>(d);
  const size_t merge = S::KG > 1 ? (size_t)S::BM * (d + 6) * 4 : 0;
  return 1024 + (groups > merge ? groups : merge);
}

// Start the copies of this thread's part of one tile row (row `row`,
// 16-byte chunks part, part + parts, ...): 16-bit pools into the swizzled
// K and V tiles at kt, kt + TILE (d elements, zero-filled up to d rounded
// to 16, and wholly for a row past the walk); 1-byte pools into a raw
// stage (a.cpy-byte copies; for int8 the row's page scales).
template <int KV>
__device__ __forceinline__ void span_load(uint8_t* dst, const Ragged& a,
                                          int kvh, int row, int part,
                                          int parts, const KeyRef& ref) {
  using S = SpanB<KV>;
  constexpr int EB = Elem<KV>::bytes, BN = S::BN;
  const int d = a.d, w = (d + 15) & ~15;
  const bool live = ref.pos >= 0;
  const int64_t off = live ? key_off(a, kvh, ref) * EB : 0;
  const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool) + off;
  const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool) + off;
  if constexpr (!S::WIDEN) {
    for (int c = part; c < w / 8; c += parts) {
      const bool valid = live && 8 * c < d;
      const int o = sw_off<BN>(row, c);
      cp_async16(dst + o, valid ? kp + 16 * c : kp, valid);
      cp_async16(dst + S::TILE + o, valid ? vp + 16 * c : vp, valid);
    }
  } else {
    const int rb = code_ld<KV>(d), cb = a.cpy;
    uint8_t* kd = dst + row * rb;
    uint8_t* vd = kd + BN * rb;
    for (int c = cb * part; c < w; c += cb * parts) {
      const bool valid = live && c < d;
      cp_async_n(kd + c, valid ? kp + c : kp, valid, cb);
      cp_async_n(vd + c, valid ? vp + c : vp, valid, cb);
    }
    if constexpr (KV == kI8) {
      if (part == 0) {
        float* sc = reinterpret_cast<float*>(dst + 2 * BN * rb);
        const int64_t so = live ? (int64_t)ref.page * a.n_kv + kvh : 0;
        cp_async4(sc + row, a.k_scale + so, live);
        cp_async4(sc + BN + row, a.v_scale + so, live);
      }
    }
  }
}

// Widen the bytes this thread copied of a raw 1-byte stage's K and V rows
// (its part of row `row`, landed: cp_async_wait) into the swizzled tiles
// of the 16-bit type H at wk and wk + TILE.
template <int H, int KV>
__device__ __forceinline__ void span_widen(const uint8_t* raw, uint8_t* wk,
                                           int d, int cb, int row, int part,
                                           int parts) {
  using S = SpanB<KV>;
  constexpr int BN = S::BN;
  const int w = (d + 15) & ~15, rb = code_ld<KV>(d);
  const uint8_t* kr = raw + row * rb;
  const uint8_t* vr = kr + BN * rb;
  for (int c = cb * part; c < w; c += cb * parts) {
    for (int e = c; e < c + cb; e += 4) {
      const int o = sw_off<BN>(row, e >> 3) + ((e & 7) << 1);
      *reinterpret_cast<uint2*>(wk + o) =
          codes16x4<H, KV>(*reinterpret_cast<const uint32_t*>(kr + e));
      *reinterpret_cast<uint2*>(wk + S::TILE + o) =
          codes16x4<H, KV>(*reinterpret_cast<const uint32_t*>(vr + e));
    }
  }
}

template <int H, int KV>
__device__ __forceinline__ void span_body(const Ragged& a) {
  using S = SpanB<KV>;
  constexpr int BM = S::BM, BN = S::BN, KG = S::KG, GTHR = S::GTHR;
  constexpr int ST = S::STAGES, NT = BN / 8, NTO = S::MAXD / 8;
  constexpr int KS = S::MAXD / 16, PARTS = GTHR / BN, STEP = KG * BN;
  static_assert(GTHR % BN == 0 && BN == 32, "a thread to a row part");
  static_assert(ST >= 2, "a ring");
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the swizzled tiles' atoms
  uint8_t* smem = smem_raw + ((1024 - (shared_u32(smem_raw) & 1023)) & 1023);
  const int d = a.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // warpgroup kg walks key tiles kg, kg + KG, ...; its warp w holds rows
  // 16 w .. 16 w + 16 of the block's 64 (the accumulators' rows)
  const int kg = warp >> 2, m0 = 16 * (warp & 3);
  const int gtid = threadIdx.x - kg * GTHR;   // the thread within its group
  // the row of every tile this thread copies, and its part of it
  const int lrow = gtid / PARTS, lpart = gtid % PARTS;
  uint8_t* region = smem + kg * sb_group<KV>(d);
  // 16-bit pools: stage s at region + 2 TILE s; 1-byte pools: the widened
  // pairs at region, raw stage s after them
  uint8_t* raw0 = region + 4 * S::TILE;

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest first
  const int n_rep = a.n_q / a.n_kv, G = n_rep * a.T;
  const int start = __ldg(a.start_pos + b), qlen = __ldg(a.q_len + b);
  const int kend = rows_key_end(a, row0, BM, G, start, qlen);

  // this group's tile j (keys kg BN + j STEP ..) in ring stage j % ST
  auto stage = [&](int j) {
    return S::WIDEN ? raw0 + (j % ST) * sb_raw<KV>(d)
                    : region + (j % ST) * 2 * S::TILE;
  };
  // the table entries of this thread's rows of the next two tiles to copy
  // are in flight while a tile is multiplied
  auto ref_of = [&](int j) { return key_ref(a, b, kg * BN + j * STEP + lrow,
                                            kend); };
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (kg * BN + j * STEP < kend) {
      span_load<KV>(stage(j), a, kvh, lrow, lpart, PARTS, ref_of(j));
    }
    cp_async_commit();
  }
  KeyRef next = ref_of(ST - 1), after = ref_of(ST);
  // 1-byte pools: tile j is widened into pair j % 2 before its barrier,
  // the first here, each later one under the tile before's P V
  if constexpr (S::WIDEN) {
    if (kg * BN < kend) {
      cp_async_wait<ST - 2>();
      span_widen<H, KV>(stage(0), region, d, a.cpy, lrow, lpart, PARTS);
    }
  }

  // this lane's rows: m0 + g (h = 0) and m0 + g + 8 (h = 1); their Q
  // fragments (A of each 16-deep k-step: a0 row g, a1 row g + 8, columns
  // 2t, 2t + 1; a2, a3 the same at columns + 8), zero past d and for rows
  // past G, read once from q [B, T, n_q, d] under the first tiles' copies
  uint32_t qf[KS][4];
  int last[2];   // the last visible key of each row, -1 for none
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + m0 + g + 8 * h, tt = row % a.T;
    const bool live = row < G && kend > 0;
    last[h] = row < G && tt < qlen ? min(start + tt, kend - 1) : -1;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        static_cast<const uint16_t*>(a.q) +
        (live ? ((int64_t)(b * a.T + tt) * a.n_q + kvh * n_rep + row / a.T)
                    * d : 0));
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * ks + 8 * half + 2 * t;
        qf[ks][h + 2 * half] = live && c < d ? __ldg(qrow + c / 2) : 0u;
      }
    }
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  [[maybe_unused]] PFactor pf;   // fp16: P's factors, acc's units

  int j = 0;
  for (int k0 = kg * BN; k0 < kend; k0 += STEP, ++j) {
    uint8_t* kt;
    const float* sc = nullptr;   // int8: the tile's [k, v][BN] scales
    if constexpr (S::WIDEN) {
      kt = region + (j & 1) * 2 * S::TILE;   // widened already
      sc = reinterpret_cast<const float*>(stage(j) + 2 * BN * code_ld<KV>(d));
    } else {
      cp_async_wait<ST - 2>();   // this thread's copies of tile j landed
      kt = stage(j);
    }
    fence_proxy_async();
    // tile j is the group's; tile j - 1's stage is free
    group_sync<KG, GTHR>(kg);
    if (k0 + (ST - 1) * STEP < kend) {
      span_load<KV>(stage(j + ST - 1), a, kvh, lrow, lpart, PARTS, next);
    }
    cp_async_commit();
    next = after;
    after = ref_of(j + ST + 1);
    const uint32_t kts = shared_u32(kt), vts = kts + S::TILE;
    // S = Q K^T: the k-steps over d summed in the tensor cores
    float s[NT][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (16 * ks < d) {
        wgmma_rs_k<H>(s, qf[ks], k_desc<BN>(kts, ks), ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // visibility, scale (and int8's k scale) at each element's (row, key)
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kk = 8 * i + 2 * t + (r & 1);
        float v = s[i][r] * a.scale;
        if constexpr (KV == kI8) v *= sc[kk];
        s[i][r] = k0 + kk <= last[r >> 1] ? v : kNegInf;
      }
    }
    if constexpr (H == kF16) {
      pf.m_prev[0] = m[0];
      pf.m_prev[1] = m[1];
    }
    online_softmax(s, m, l, acc);
    if constexpr (H == kF16) {
      // P F (and int8's v scales), acc in units of F (l has summed the
      // unscaled P)
      scale_p_f16<KV>(s, acc, pf, m,
                      [&](int i, int r) { return 8 * i + 2 * t + (r & 1); },
                      [&](int k) { return sc[BN + k]; });
    } else if constexpr (KV == kI8) {
      // the v scales into P (l has summed the unscaled P)
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[i][r] *= sc[BN + 8 * i + 2 * t + (r & 1)];
      }
    }
    // O += P V: P in three 16-bit terms from registers, the smallest first
    // a 16-key step, V an MN-major operand
    uint32_t hi[NT / 2][4], mid[NT / 2][4], lo[NT / 2][4];
#pragma unroll
    for (int mm = 0; mm < NT / 2; ++mm) {
      split3_frag_a<H>(s, mm, hi[mm], mid[mm], lo[mm]);
    }
    reg_fence(acc);
    reg_fence(hi);
    reg_fence(mid);
    reg_fence(lo);
    wgmma_fence();
#pragma unroll
    for (int mm = 0; mm < NT / 2; ++mm) {
      const uint64_t desc = mn_desc<BN>(vts, mm);
      wgmma_rs<H>(acc, lo[mm], desc, 1);
      wgmma_rs<H>(acc, mid[mm], desc, 1);
      wgmma_rs<H>(acc, hi[mm], desc, 1);
    }
    wgmma_commit();
    if constexpr (S::WIDEN) {
      // the next tile widened under this P V: its pair was last read by
      // tile j - 1's products, done before this tile's barrier
      if (k0 + STEP < kend) {
        cp_async_wait<ST - 2>();
        span_widen<H, KV>(stage(j + 1),
                          region + ((j + 1) & 1) * 2 * S::TILE, d, a.cpy,
                          lrow, lpart, PARTS);
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
  }
  cp_async_wait<0>();
  if constexpr (H == kF16) unscale_acc(acc, pf);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  if constexpr (KG == 2) {
    // merge: the second group's (m, l, acc) of each row through shared
    // memory ([BM][d + 4] of acc, then [BM] of m and of l) into the first
    // group's
    const int mld = d + 4;
    float* macc = reinterpret_cast<float*>(smem);
    float* mm = macc + BM * mld;
    float* ml = mm + BM;
    __syncthreads();   // every group is done with its region
    if (kg == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
#pragma unroll
        for (int jj = 0; jj < NTO; ++jj) {
          const int col = 8 * jj + 2 * t;
          if (col < d) {
            *reinterpret_cast<float2*>(macc + r * mld + col) =
                make_float2(acc[jj][2 * h], acc[jj][2 * h + 1]);
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
      for (int jj = 0; jj < NTO; ++jj) {
        const int col = 8 * jj + 2 * t;
        if (col < d) {
          const float2 o =
              *reinterpret_cast<const float2*>(macc + r * mld + col);
          acc[jj][2 * h] = acc[jj][2 * h] * f0 + o.x * f1;
          acc[jj][2 * h + 1] = acc[jj][2 * h + 1] * f0 + o.y * f1;
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
      Half<H>* dst = static_cast<Half<H>*>(a.out) +
                     ((int64_t)(b * a.T + tt) * a.n_q + head) * d;
#pragma unroll
      for (int jj = 0; jj < NTO; ++jj) {
        const int col = 8 * jj + 2 * t;
        if (col < d) {
          st2(dst + col, acc[jj][2 * h] * inv, acc[jj][2 * h + 1] * inv);
        }
      }
    }
  }
}

// The span form's kernels: bf16 q and fp16 q (K1-fp16's), one body.
template <int KV>
__global__ void __launch_bounds__(SpanB<KV>::NTHR, 1)
ragged_span_bf16_kernel(Ragged a) {
  span_body<kBf16, KV>(a);
}

template <int KV>
__global__ void __launch_bounds__(SpanB<KV>::NTHR, 1)
ragged_span_f16_kernel(Ragged a) {
  span_body<kF16, KV>(a);
}

template <int H, int KV>
cudaError_t launch_span_kv(const Ragged& a, int B, cudaStream_t stream) {
  using S = SpanB<KV>;
  void (*kernel)(Ragged);
  if constexpr (H == kF16) {
    kernel = ragged_span_f16_kernel<KV>;
  } else {
    kernel = ragged_span_bf16_kernel<KV>;
  }
  const size_t smem = span_bf16_smem<KV>(a.d);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = (a.n_q / a.n_kv) * a.T;
  const dim3 grid((G + S::BM - 1) / S::BM, a.n_kv, B);
  kernel<<<grid, S::NTHR, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------- decode form

// The split walk's tiling (d <= 128).
struct DecB {
  // warps, keys a warp tile, ring stages a warp, blocks an SM at most
  static constexpr int NW = 4, KT = 16, ST = 3, PER_SM = 2;
  static constexpr int MAXD = 128, NT = KT / 8, NTO = MAXD / 8;
  static constexpr int KS = MAXD / 16, NTHR = 32 * NW;
};

// Bytes of a warp's 16-bit tile (K or V): KT rows of bf_ld(d) elements,
// which ldmatrix reads free of bank conflicts.
__host__ __device__ __forceinline__ int dec_tile(int d) {
  return DecB::KT * bf_ld(d) * 2;
}

// Bytes of one warp stage: 16-bit pools the K and V tiles; 1-byte pools
// the K and V code rows (rows of code_ld(d) bytes), then for int8 their
// page scales [2][KT].
template <int KV>
__host__ __device__ __forceinline__ int dec_stage(int d) {
  return Elem<KV>::bytes == 2 ? 2 * dec_tile(d)
                     : 2 * DecB::KT * code_ld<KV>(d) +
                           (KV == kI8 ? 8 * DecB::KT : 0);
}

// Bytes of a warp's region: its ring, then for 1-byte pools its widened K
// and V tiles.
template <int KV>
__host__ __device__ __forceinline__ int dec_warp(int d) {
  return DecB::ST * dec_stage<KV>(d) +
         (Elem<KV>::bytes == 2 ? 0 : 2 * dec_tile(d));
}

// Shared memory: the warps' regions (or, after the walk, their merge area:
// [NW][kDecodeRows][d] of acc, [NW][kDecodeRows] of m and of l), then the
// work list's prefix over the sequences and its scan buffer (2 (B + 1)
// ints), then an item's table slice (keys_per_split + 1 ints at most).
template <int KV>
__host__ __device__ __forceinline__ int dec_area(int d) {
  const int walk = DecB::NW * dec_warp<KV>(d);
  const int merge = DecB::NW * (kDecodeRows * d + 2 * kDecodeRows) * 4;
  return walk > merge ? walk : merge;
}

template <int KV>
size_t split_smem_bytes(int d, int B, int keys_per_split) {
  return (size_t)dec_area<KV>(d) +
         sizeof(int) * (2 * ((size_t)B + 1) + keys_per_split + 1);
}


__device__ __forceinline__ int splits_of(int kend, int keys_per_split) {
  return max(1, (kend + keys_per_split - 1) / keys_per_split);
}

// The work list: every split of every sequence, n_kv heads each; returns
// its prefix over the sequences (cum[s] = n_kv * the splits of the
// sequences before s; cum[B] = the items), a scan in shared memory through
// the buffers x and y ([B + 1] ints each).
template <int NTHR>
__device__ __forceinline__ const int* work_list(const Ragged& a, int B,
                                                int G, int kps, int* x,
                                                int* y) {
  const int tid = threadIdx.x;
  for (int s = tid; s <= B; s += NTHR) {
    x[s] = s == 0 ? 0
                  : a.n_kv * splits_of(
                        rows_key_end(a, 0, G, G, __ldg(a.start_pos + s - 1),
                                     __ldg(a.q_len + s - 1)), kps);
  }
  __syncthreads();
  for (int off = 1; off <= B; off <<= 1) {
    for (int s = tid; s <= B; s += NTHR) {
      y[s] = x[s] + (s >= off ? x[s - off] : 0);
    }
    __syncthreads();
    int* tmp = x;
    x = y;
    y = tmp;
  }
  return x;
}

// The sequence of work item `item`: the last s with cum[s] <= item.
__device__ __forceinline__ int item_seq(const int* cum, int B, int item) {
  int lo = 0, hi = B;   // cum[lo] <= item < cum[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= item) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// An item's output from its warps' states in shared memory (macc
// [NW][kDecodeRows][d] partial outputs, mm and ml [NW][kDecodeRows] their
// m and l), merged in warp order: a sequence of one split writes its rows;
// otherwise the split's (acc, m, l) go to the workspace and the block that
// takes the (sequence, kv head)'s ticket last merges every split's in
// split order and resets the ticket.
template <int H, int NTHR>
__device__ __forceinline__ void finish_item(
    const Ragged& a, const ragged::Split& sp, int B, int G, int b, int kvh,
    int split, int n_split, const float* macc, const float* mm,
    const float* ml, int* s_last) {
  constexpr int NW = NTHR / 32;
  const int d = a.d, tid = threadIdx.x, n_rep = a.n_q / a.n_kv;
  const int64_t bh = (int64_t)b * a.n_kv + kvh;
  // this split's rows in the workspace: acc [.., d], then (m, l)
  const int64_t n_part = (int64_t)B * a.n_kv * sp.n_splits * G;
  float* pacc = sp.part;
  float* pml = sp.part + n_part * d;
  for (int idx = tid; idx < G * (d / 4); idx += NTHR) {
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
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(den, 1e-30f);
      const int tt = r % a.T, head = kvh * n_rep + r / a.T;
      st4(static_cast<Half<H>*>(a.out) +
              ((int64_t)(b * a.T + tt) * a.n_q + head) * d + c,
          make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
    } else {
      const int64_t pr = (bh * sp.n_splits + split) * G + r;
      *reinterpret_cast<float4*>(pacc + pr * d + c) = num;
      if (c == 0) {
        pml[2 * pr] = mx;
        pml[2 * pr + 1] = den;
      }
    }
  }
  if (n_split > 1) {
    // the block's writes, then one thread's fence and ticket; the last
    // split to finish merges them all in split order
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      *s_last = atomicAdd(sp.tickets + bh, 1) == n_split - 1;
      if (*s_last) __threadfence();
    }
    __syncthreads();
    if (*s_last) {
      for (int idx = tid; idx < G * (d / 4); idx += NTHR) {
        const int r = idx / (d / 4), c = 4 * (idx - r * (d / 4));
        const int64_t r0s = bh * sp.n_splits * G + r;
        float Ms = kNegInf;
        for (int s = 0; s < n_split; ++s) {
          Ms = fmaxf(Ms, __ldcg(pml + 2 * (r0s + (int64_t)s * G)));
        }
        float Ls = 0.f;
        float4 As = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < n_split; ++s) {
          const int64_t pr = r0s + (int64_t)s * G;
          const float f = expf(__ldcg(pml + 2 * pr) - Ms);
          const float4 v4 =
              __ldcg(reinterpret_cast<const float4*>(pacc + pr * d + c));
          Ls += f * __ldcg(pml + 2 * pr + 1);
          As.x += f * v4.x; As.y += f * v4.y;
          As.z += f * v4.z; As.w += f * v4.w;
        }
        const float inv = 1.f / fmaxf(Ls, 1e-30f);
        const int tt = r % a.T, head = kvh * n_rep + r / a.T;
        st4(static_cast<Half<H>*>(a.out) +
                ((int64_t)(b * a.T + tt) * a.n_q + head) * d + c,
            make_float4(As.x * inv, As.y * inv, As.z * inv, As.w * inv));
      }
      if (tid == 0) sp.tickets[bh] = 0;
    }
  }
}

template <int H, int KV>
__device__ __forceinline__ void split_body(const Ragged& a,
                                           const ragged::Split& sp, int B) {
  constexpr int NW = DecB::NW, KT = DecB::KT, ST = DecB::ST;
  constexpr int NT = DecB::NT, NTO = DecB::NTO, KS = DecB::KS;
  constexpr int NTHR = DecB::NTHR, EB = Elem<KV>::bytes;
  extern __shared__ float4 smem4[];
  __shared__ int s_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int d = a.d, w = (d + 15) & ~15, ld = bf_ld(d);
  int* lists = reinterpret_cast<int*>(smem + dec_area<KV>(d));
  int* tbl = lists + 2 * (B + 1);   // the item's pages, from its first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* mine = smem + warp * dec_warp<KV>(d);
  uint8_t* wide = mine + ST * dec_stage<KV>(d);   // 1-byte pools: K, V
  const int n_rep = a.n_q / a.n_kv, G = n_rep * a.T;
  const int kps = sp.keys_per_split;
  // a pool row's copies: 16-byte chunks of 16-bit rows, a.cpy bytes of
  // code rows; CPR of them a row, lane + 32 i the warp's copy i of a tile
  constexpr bool NATIVE = Elem<KV>::bytes == 2;   // a 16-bit pool
  const int cb = NATIVE ? 16 : a.cpy, cpr = w * EB / cb;

  const int* cum = work_list<NTHR>(a, B, G, kps, lists, lists + B + 1);
  const int items = cum[B];

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    // item -> (sequence b, split, kv head): sequence-major through cum
    const int b = item_seq(cum, B, item), r0 = item - cum[b];
    const int split = r0 / a.n_kv, kvh = r0 - split * a.n_kv;
    const int start = __ldg(a.start_pos + b), qlen = __ldg(a.q_len + b);
    const int kend = rows_key_end(a, 0, G, G, start, qlen);
    const int n_split = splits_of(kend, kps);
    const int k0 = split * kps, k1 = min(k0 + kps, kend);
    const int ntiles = k1 > k0 ? (k1 - k0 + KT - 1) / KT : 0;
    const int p0 = k0 / a.page_size;   // the slice's first page

    // the split's table slice into shared memory
    if (k1 > k0) {
      const int n_pages = (k1 - 1) / a.page_size - p0 + 1;
      for (int i = tid; i < n_pages; i += NTHR) {
        tbl[i] = __ldg(a.table + (int64_t)b * a.pages_per_seq + p0 + i);
      }
    }
    // this lane's rows g (h = 0) and g + 8 (h = 1, never a live row: G <=
    // 8); their Q fragments (the mma A operand of each 16-deep k-step),
    // zero past d and for rows past G
    uint32_t qf[KS][4];
    int last;   // row g's last visible key in this split, -1 for none
    {
      const int tt = g % a.T;
      const bool live = g < G && k1 > k0;
      last = g < G && tt < qlen ? min(start + tt, k1 - 1) : -1;
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
          static_cast<const uint16_t*>(a.q) +
          (live ? ((int64_t)(b * a.T + tt) * a.n_q + kvh * n_rep + g / a.T)
                      * d : 0));
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c = 16 * ks + 2 * t;
        qf[ks][0] = live && c < d ? __ldg(qrow + c / 2) : 0u;
        qf[ks][2] = live && c + 8 < d ? __ldg(qrow + c / 2 + 4) : 0u;
        qf[ks][1] = qf[ks][3] = 0u;   // rows g + 8
      }
    }
    __syncthreads();   // the table slice

    // warp tile jt (keys k0 + jt KT ..) into stage st: each lane its copies
    // lane, lane + 32, ... of the tile's chunks, neighbouring lanes on
    // neighbouring chunks of a row; rows past the split zero-filled
    auto load = [&](int st, int jt) {
      uint8_t* dst = mine + st * dec_stage<KV>(d);
      for (int x = lane; x < KT * cpr; x += 32) {
        const int row = x / cpr, c = x - row * cpr;
        const int kpos = k0 + jt * KT + row;
        const bool live = kpos < k1;
        const int page = live ? tbl[kpos / a.page_size - p0] : 0;
        const int64_t off =
            live ? key_off(a, kvh, KeyRef{page, kpos}) * EB : 0;
        const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool) + off;
        const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool) + off;
        const bool valid = live && c * cb < d * EB;
        if constexpr (NATIVE) {
          uint8_t* kd = dst + row * ld * 2 + 16 * c;
          cp_async16(kd, valid ? kp + 16 * c : kp, valid);
          cp_async16(kd + dec_tile(d), valid ? vp + 16 * c : vp, valid);
        } else {
          const int rb = code_ld<KV>(d);
          uint8_t* kd = dst + row * rb + cb * c;
          cp_async_n(kd, valid ? kp + cb * c : kp, valid, cb);
          cp_async_n(kd + KT * rb, valid ? vp + cb * c : vp, valid, cb);
          if constexpr (KV == kI8) {
            if (c == 0) {
              float* sc = reinterpret_cast<float*>(dst + 2 * KT * rb);
              const int64_t so = live ? (int64_t)page * a.n_kv + kvh : 0;
              cp_async4(sc + row, a.k_scale + so, live);
              cp_async4(sc + KT + row, a.v_scale + so, live);
            }
          }
        }
      }
    };

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[NTO][4];
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    [[maybe_unused]] PFactor pf;   // fp16: P's factors, acc's units
    // the warp's tiles warp, warp + NW, ... through its ring, ST - 1
    // ahead of the one multiplied
    int jt = warp;
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (jt + i * NW < ntiles) load(i, jt + i * NW);
      cp_async_commit();
    }
    for (int i = 0; jt < ntiles; jt += NW, ++i) {
      if (jt + (ST - 1) * NW < ntiles) {
        load((i + ST - 1) % ST, jt + (ST - 1) * NW);
      }
      cp_async_commit();
      cp_async_wait<ST - 1>();   // this lane's copies of tile jt landed
      uint8_t* stg = mine + (i % ST) * dec_stage<KV>(d);
      const uint16_t* kt;
      const float* sc = nullptr;   // int8: the tile's [k, v][KT] scales
      if constexpr (NATIVE) {
        kt = reinterpret_cast<const uint16_t*>(stg);
      } else {
        // widen the bytes this lane copied into the 16-bit tiles
        const int rb = code_ld<KV>(d);
        for (int x = lane; x < KT * cpr; x += 32) {
          const int row = x / cpr, c = x - row * cpr;
          const uint8_t* kr = stg + row * rb;
          uint16_t* wk = reinterpret_cast<uint16_t*>(wide) + row * ld;
          for (int e = cb * c; e < cb * (c + 1); e += 4) {
            *reinterpret_cast<uint2*>(wk + e) =
                codes16x4<H, KV>(*reinterpret_cast<const uint32_t*>(kr + e));
            *reinterpret_cast<uint2*>(wk + KT * ld + e) = codes16x4<H, KV>(
                *reinterpret_cast<const uint32_t*>(kr + KT * rb + e));
          }
        }
        kt = reinterpret_cast<const uint16_t*>(wide);
        sc = reinterpret_cast<const float*>(stg + 2 * KT * rb);
      }
      __syncwarp();   // the tile is the warp's
      const uint16_t* vt = kt + KT * ld;
      const int key0 = k0 + jt * KT;
      // S = Q K^T: one 16-bit mma a 16-deep k-step, summed in fp32
      float s[NT][4];
#pragma unroll
      for (int i2 = 0; i2 < NT; ++i2) {
        s[i2][0] = s[i2][1] = s[i2][2] = s[i2][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (16 * ks < d) {
#pragma unroll
          for (int i2 = 0; i2 < NT; i2 += 2) {
            uint32_t b0[2], b1[2];
            frag_b_rows(b0, b1, kt, 8 * i2, 16 * ks, ld, lane);
            mma_step<H>(s[i2], qf[ks], b0);
            mma_step<H>(s[i2 + 1], qf[ks], b1);
          }
        }
      }
      // visibility, scale (and int8's k scale) at each element
#pragma unroll
      for (int i2 = 0; i2 < NT; ++i2) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kk = 8 * i2 + 2 * t + (r & 1);
          float v = s[i2][r] * a.scale;
          if constexpr (KV == kI8) v *= sc[kk];
          s[i2][r] = r < 2 && key0 + kk <= last ? v : kNegInf;
        }
      }
      if constexpr (H == kF16) {
        pf.m_prev[0] = m[0];
        pf.m_prev[1] = m[1];
      }
      online_softmax(s, m, l, acc);
      if constexpr (H == kF16) {
        // P F (and int8's v scales), acc in units of F (l has summed the
        // unscaled P)
        scale_p_f16<KV>(
            s, acc, pf, m,
            [&](int i2, int r) { return 8 * i2 + 2 * t + (r & 1); },
            [&](int k) { return sc[KT + k]; });
      } else if constexpr (KV == kI8) {
        // the v scales into P (l has summed the unscaled P)
#pragma unroll
        for (int i2 = 0; i2 < NT; ++i2) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[i2][r] *= sc[KT + 8 * i2 + 2 * t + (r & 1)];
          }
        }
      }
      // O += P V: P in three 16-bit terms, three mma a 16-key k-step,
      // summed from zero and added in fp32
#pragma unroll
      for (int mm = 0; mm < NT / 2; ++mm) {
        uint32_t hi[4], mid[4], lo[4];
        split3_frag_a<H>(s, mm, hi, mid, lo);
#pragma unroll
        for (int j = 0; j < NTO; j += 2) {
          if (8 * j < d) {
            uint32_t b0[2], b1[2];
            frag_b_cols(b0, b1, vt, 16 * mm, 8 * j, ld, lane);
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
            mma16<H>(p0, lo, b0);
            mma16<H>(p1, lo, b1);
            mma16<H>(p0, mid, b0);
            mma16<H>(p1, mid, b1);
            mma16<H>(p0, hi, b0);
            mma16<H>(p1, hi, b1);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[j][r] += p0[r];
              acc[j + 1][r] += p1[r];
            }
          }
        }
      }
      __syncwarp();   // this stage (and the widened tiles) consumed
    }
    cp_async_wait<0>();
    if constexpr (H == kF16) unscale_acc(acc, pf);
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
    __syncthreads();   // every warp is done with its region

    // merge the warps' (m, l, acc) of rows 0 .. G in warp order:
    // [NW][kDecodeRows][d] partial outputs, then [NW][kDecodeRows] of m
    // and of l
    float* macc = reinterpret_cast<float*>(smem);
    float* mm = macc + NW * kDecodeRows * d;
    float* ml = mm + NW * kDecodeRows;
    if (g < G) {
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < d) {
          *reinterpret_cast<float2*>(macc + (warp * kDecodeRows + g) * d +
                                     col) = make_float2(acc[j][0], acc[j][1]);
        }
      }
      if (t == 0) {
        mm[warp * kDecodeRows + g] = m[0];
        ml[warp * kDecodeRows + g] = l[0];
      }
    }
    __syncthreads();
    finish_item<H, NTHR>(a, sp, B, G, b, kvh, split, n_split, macc, mm,
                         ml, &s_last);
    __syncthreads();   // the regions and the slice are free for the next item
  }
}

// The split walk's kernels: bf16 q and fp16 q (K1-fp16's), one body.
template <int KV>
__global__ void __launch_bounds__(DecB::NTHR, DecB::PER_SM)
ragged_decode_split_kernel(Ragged a, ragged::Split sp, int B) {
  split_body<kBf16, KV>(a, sp, B);
}

template <int KV>
__global__ void __launch_bounds__(DecB::NTHR, DecB::PER_SM)
ragged_decode_split_f16_kernel(Ragged a, ragged::Split sp, int B) {
  split_body<kF16, KV>(a, sp, B);
}

// The split walk of one grouped row (G = 1: MHA decode), on the CUDA
// cores: K2's walk inside a split. Four warps own interleaved tiles of KT
// = 8 keys through private rings of three cp.async stages; LPK = 4 lanes
// copy and score a key, each every 4th 16-byte chunk of its row, against
// the row's q chunks held in registers; a lane owns a float4 column chunk
// of acc; int8 values are code * scale in fp32, as the plain version. A
// 16-row mma tile would leave 15 of its rows empty. Up to eight blocks an
// SM: at two (the other forms' cap) MHA decode took 1.5x as long, at
// 4-key tiles 1.1x (tools/k1_bf16_variants.py).
struct DecR {
  static constexpr int NW = 4, KT = 8, ST = 3, PER_SM = 8;
  static constexpr int LPK = 32 / KT, MAXD = 128, NTHR = 32 * NW;
};

// Bytes of one warp stage of the row walk: KT rows of K and of V, d
// elements each, then for int8 their page scales [2][KT].
template <int KV>
__host__ __device__ __forceinline__ int row_stage(int d) {
  return 2 * DecR::KT * d * Elem<KV>::bytes + (KV == kI8 ? 8 * DecR::KT : 0);
}

template <int KV>
__host__ __device__ __forceinline__ int row_area(int d) {
  const int walk = DecR::NW * DecR::ST * row_stage<KV>(d);
  const int merge = DecR::NW * (kDecodeRows * d + 2 * kDecodeRows) * 4;
  return walk > merge ? walk : merge;
}

template <int KV>
size_t row_smem_bytes(int d, int B, int keys_per_split) {
  return (size_t)row_area<KV>(d) +
         sizeof(int) * (2 * ((size_t)B + 1) + keys_per_split + 1);
}

// CB: the bytes of one read of a key row from a stage (16, or 8 for
// 1-byte rows of d = 8 mod 16); the copies into the stage take a.cpy.
template <int H, int KV, int CB>
__device__ __forceinline__ void row_body(const Ragged& a,
                                         const ragged::Split& sp, int B) {
  constexpr int NW = DecR::NW, KT = DecR::KT, ST = DecR::ST;
  constexpr int LPK = DecR::LPK, NTHR = DecR::NTHR;
  constexpr int EB = Elem<KV>::bytes, EPC = CB / EB;   // elements a read
  // the reads of a row a lane makes, and the q elements it holds
  constexpr int QC = (DecR::MAXD * EB + LPK * CB - 1) / (LPK * CB);
  extern __shared__ float4 smem4[];
  __shared__ int s_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int d = a.d, rsb = d * EB, sb = row_stage<KV>(d);
  int* lists = reinterpret_cast<int*>(smem + row_area<KV>(d));
  int* tbl = lists + 2 * (B + 1);   // the item's pages, from its first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* mine = smem + warp * ST * sb;
  const int kps = sp.keys_per_split;
  const int lrow = lane % KT, lpart = lane / KT;   // this lane's copies
  const int kk = lane / LPK, part = lane % LPK;    // its key, its part

  const int* cum = work_list<NTHR>(a, B, 1, kps, lists, lists + B + 1);
  const int items = cum[B];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item_seq(cum, B, item), r0 = item - cum[b];
    const int split = r0 / a.n_kv, kvh = r0 - split * a.n_kv;
    const int start = __ldg(a.start_pos + b), qlen = __ldg(a.q_len + b);
    const int kend = rows_key_end(a, 0, 1, 1, start, qlen);
    const int n_split = splits_of(kend, kps);
    const int k0 = split * kps, k1 = min(k0 + kps, kend);
    const int ntiles = k1 > k0 ? (k1 - k0 + KT - 1) / KT : 0;
    const int p0 = k0 / a.page_size;
    // the row's last visible key in this split (its one key row: t = 0)
    const int last = qlen > 0 ? min(start, k1 - 1) : -1;

    if (k1 > k0) {
      const int n_pages = (k1 - 1) / a.page_size - p0 + 1;
      for (int i = tid; i < n_pages; i += NTHR) {
        tbl[i] = __ldg(a.table + (int64_t)b * a.pages_per_seq + p0 + i);
      }
    }
    // this lane's q elements (reads part, part + LPK, ... of the row), as
    // fp32; zero past d
    float qv[QC][EPC];
    {
      const Half<H>* qrow = static_cast<const Half<H>*>(a.q) +
                            ((int64_t)b * a.T * a.n_q + kvh) * d;
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        const int e0 = (part + LPK * i) * EPC;
#pragma unroll
        for (int w = 0; w < EPC / 4; ++w) {
          const float4 v = e0 + 4 * w < d && k1 > k0
                               ? ldg4(qrow + e0 + 4 * w)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          qv[i][4 * w] = v.x; qv[i][4 * w + 1] = v.y;
          qv[i][4 * w + 2] = v.z; qv[i][4 * w + 3] = v.w;
        }
      }
    }
    __syncthreads();   // the table slice

    // warp tile jt into stage st: K rows, V rows (and int8 page scales)
    auto load = [&](int st, int jt) {
      uint8_t* kd = mine + st * sb;
      uint8_t* vd = kd + KT * rsb;
      const int kpos = k0 + jt * KT + lrow, cb = a.cpy;
      const bool live = kpos < k1;
      const int page = live ? tbl[kpos / a.page_size - p0] : 0;
      const int64_t off = live ? key_off(a, kvh, KeyRef{page, kpos}) * EB : 0;
      const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool) + off;
      const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool) + off;
      for (int c = cb * lpart; c < rsb; c += cb * LPK) {
        cp_async_n(kd + lrow * rsb + c, live ? kp + c : kp, live, cb);
        cp_async_n(vd + lrow * rsb + c, live ? vp + c : vp, live, cb);
      }
      if constexpr (KV == kI8) {
        if (lpart == 0) {
          float* sc = reinterpret_cast<float*>(vd + KT * rsb);   // [2][KT]
          const int64_t so = live ? (int64_t)page * a.n_kv + kvh : 0;
          cp_async4(sc + lrow, a.k_scale + so, live);
          cp_async4(sc + KT + lrow, a.v_scale + so, live);
        }
      }
    };

    float m = kNegInf, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int jt = warp;
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (jt + i * NW < ntiles) load(i, jt + i * NW);
      cp_async_commit();
    }
    for (int i = 0; jt < ntiles; jt += NW, ++i) {
      if (jt + (ST - 1) * NW < ntiles) {
        load((i + ST - 1) % ST, jt + (ST - 1) * NW);
      }
      cp_async_commit();
      cp_async_wait<ST - 1>();
      __syncwarp();
      const uint8_t* kt = mine + (i % ST) * sb;
      const uint8_t* vt = kt + KT * rsb;
      const float* sc = reinterpret_cast<const float*>(vt + KT * rsb);
      // q . k of this lane's key over its parts of d
      float s = 0.f;
#pragma unroll
      for (int i2 = 0; i2 < QC; ++i2) {
        const int c = (part + LPK * i2) * CB;
        if (c < rsb) {
#pragma unroll
          for (int w = 0; w < EPC / 4; ++w) {
            float4 kv = load4<KV>(kt + kk * rsb, c / EB + 4 * w);
            if constexpr (KV == kI8) {
              // code * scale, rounded in fp32 as the plain version does
              const float ks = sc[kk];
              kv = make_float4(kv.x * ks, kv.y * ks, kv.z * ks, kv.w * ks);
            }
            s += qv[i2][4 * w] * kv.x + qv[i2][4 * w + 1] * kv.y +
                 qv[i2][4 * w + 2] * kv.z + qv[i2][4 * w + 3] * kv.w;
          }
        }
      }
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      const int key = k0 + jt * KT + kk;
      s = key <= last ? s * a.scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      const float p = s <= kMaskedBelow ? 0.f : expf(s - m_new);
      float ps = p;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      }
      l = l * corr + ps;
      m = m_new;
      acc.x *= corr; acc.y *= corr; acc.z *= corr; acc.w *= corr;
      // acc += P V over the tile's keys, this lane's columns 4 lane ..
#pragma unroll
      for (int k2 = 0; k2 < KT; ++k2) {
        const float pk = __shfl_sync(0xffffffffu, p, k2 * LPK);
        if (4 * lane < d) {
          float4 vv = load4<KV>(vt + k2 * rsb, 4 * lane);
          if constexpr (KV == kI8) {
            const float vs = sc[KT + k2];
            vv = make_float4(vv.x * vs, vv.y * vs, vv.z * vs, vv.w * vs);
          }
          acc.x += pk * vv.x; acc.y += pk * vv.y;
          acc.z += pk * vv.z; acc.w += pk * vv.w;
        }
      }
      __syncwarp();   // this stage is consumed before it is refilled
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with its stages

    // the warps' states into the merge area (row 0 of each warp's rows)
    float* macc = reinterpret_cast<float*>(smem);
    float* mm = macc + NW * kDecodeRows * d;
    float* ml = mm + NW * kDecodeRows;
    if (4 * lane < d) {
      *reinterpret_cast<float4*>(macc + warp * kDecodeRows * d + 4 * lane) =
          acc;
    }
    if (lane == 0) {
      mm[warp * kDecodeRows] = m;
      ml[warp * kDecodeRows] = l;
    }
    __syncthreads();
    finish_item<H, NTHR>(a, sp, B, 1, b, kvh, split, n_split, macc, mm,
                         ml, &s_last);
    __syncthreads();   // the stages and the slice are free for the next item
  }
}

// The row walk's kernels: bf16 q and fp16 q (K1-fp16's), one body.
template <int KV, int CB>
__global__ void __launch_bounds__(DecR::NTHR, 4)
ragged_decode_row_kernel(Ragged a, ragged::Split sp, int B) {
  row_body<kBf16, KV, CB>(a, sp, B);
}

template <int KV, int CB>
__global__ void __launch_bounds__(DecR::NTHR, 4)
ragged_decode_row_f16_kernel(Ragged a, ragged::Split sp, int B) {
  row_body<kF16, KV, CB>(a, sp, B);
}

template <int H, int KV, int CB>
cudaError_t launch_row_cb(const Ragged& a, const ragged::Split& sp, int B,
                          cudaStream_t stream) {
  void (*kernel)(Ragged, ragged::Split, int);
  if constexpr (H == kF16) {
    kernel = ragged_decode_row_f16_kernel<KV, CB>;
  } else {
    kernel = ragged_decode_row_kernel<KV, CB>;
  }
  const size_t smem = row_smem_bytes<KV>(a.d, B, sp.keys_per_split);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, DecR::NTHR, smem);
  }
  if (err != cudaSuccess) return err;
  const int cap = DecR::PER_SM;
  const int64_t resident =
      (int64_t)sms * (per_sm < 1 ? 1 : per_sm > cap ? cap : per_sm);
  const int64_t items = (int64_t)sp.n_splits * B * a.n_kv;
  const int grid = (int)(items < resident ? items : resident);
  kernel<<<grid, DecR::NTHR, smem, stream>>>(a, sp, B);
  return cudaGetLastError();
}

template <int H, int KV>
cudaError_t launch_split_kv(const Ragged& a, const ragged::Split& sp, int B,
                            cudaStream_t stream) {
  if ((a.n_q / a.n_kv) * a.T == 1) {
    // one row: the CUDA cores' walk (8-byte reads for 1-byte rows of d =
    // 8 mod 16; 16-bit rows are whole 16-byte chunks)
    if constexpr (Elem<KV>::bytes == 1) {
      if (a.d % 16 != 0) return launch_row_cb<H, KV, 8>(a, sp, B, stream);
    }
    return launch_row_cb<H, KV, 16>(a, sp, B, stream);
  }
  void (*kernel)(Ragged, ragged::Split, int);
  if constexpr (H == kF16) {
    kernel = ragged_decode_split_f16_kernel<KV>;
  } else {
    kernel = ragged_decode_split_kernel<KV>;
  }
  const size_t smem = split_smem_bytes<KV>(a.d, B, sp.keys_per_split);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // set at every size: the kernel's static shared memory counts against
  // the default 48 KiB too
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a persistent grid of up to PER_SM blocks an SM (any grid computes
  // the same result)
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, DecB::NTHR, smem);
  }
  if (err != cudaSuccess) return err;
  const int cap = DecB::PER_SM;
  const int64_t resident =
      (int64_t)sms * (per_sm < 1 ? 1 : per_sm > cap ? cap : per_sm);
  const int64_t items = (int64_t)sp.n_splits * B * a.n_kv;
  const int grid = (int)(items < resident ? items : resident);
  kernel<<<grid, DecB::NTHR, smem, stream>>>(a, sp, B);
  return cudaGetLastError();
}

}  // namespace

namespace ragged {

template <typename QT>
cudaError_t launch_span16(const Ragged& a, int kv, int B,
                          cudaStream_t stream) {
  constexpr int H = std::is_same_v<QT, __half> ? kF16 : kBf16;
  constexpr int kHalfPool = H == kF16 ? kFP16 : kBF16;
  switch (kv) {
    case kHalfPool: return launch_span_kv<H, kHalfPool>(a, B, stream);
    case kI8: return launch_span_kv<H, kI8>(a, B, stream);
    case kF8: return launch_span_kv<H, kF8>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t launch_decode_split(const Ragged& a, const Split& sp, int kv,
                                int B, cudaStream_t stream) {
  constexpr int H = std::is_same_v<QT, __half> ? kF16 : kBf16;
  constexpr int kHalfPool = H == kF16 ? kFP16 : kBF16;
  switch (kv) {
    case kHalfPool: return launch_split_kv<H, kHalfPool>(a, sp, B, stream);
    case kI8: return launch_split_kv<H, kI8>(a, sp, B, stream);
    case kF8: return launch_split_kv<H, kF8>(a, sp, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t launch_span16<__nv_bfloat16>(const Ragged&, int, int,
                                                  cudaStream_t);
template cudaError_t launch_span16<__half>(const Ragged&, int, int,
                                           cudaStream_t);
template cudaError_t launch_decode_split<__nv_bfloat16>(const Ragged&,
                                                        const Split&, int,
                                                        int, cudaStream_t);
template cudaError_t launch_decode_split<__half>(const Ragged&, const Split&,
                                                 int, int, cudaStream_t);

}  // namespace ragged
