// The bf16 and fp16 flash forward, dq and dk/dv kernels for Hopper,
// sm_90a, on wgmma with TMA-fed shared-memory rings, for head dims d <=
// 128 (instantiations MAXD = 64 and 128; the bf16 and fp16 entry points of
// flash_attention.cu call them there and keep their mma.sync kernels for
// 128 < d <= 256).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py at bf16 (fp16) q, k,
// v ::
//   _flash_forward (kernel _flash_fwd_kernel)
//     -> flash_fwd_bf16_wgmma_kernel (flash_fwd_f16_wgmma_kernel)
//   _flash_backward (kernel _flash_bwd_dq_kernel)
//     -> flash_bwd_dq_bf16_wgmma_kernel (flash_bwd_dq_f16_wgmma_kernel)
//   _flash_backward (kernel _flash_bwd_dkv_kernel)
//     -> flash_bwd_dkv_bf16_wgmma_kernel (flash_bwd_dkv_f16_wgmma_kernel)
// dense and in every masked form, with the contract of the mma.sync
// 16-bit kernels (flash_attention.cu): layout [B, S, H, d], bottom-right
// causal alignment, the masks of flash_common.cuh at each accumulator
// element, the hard-mask guard (s <= -5e29 -> p = 0: an additive mask
// cast to fp16 holds -inf, which the guard also takes), lse and delta in
// fp32, the outputs rounded to the operands' type once.
//
// One body per kernel (fwd_wgmma, dq_wgmma, dkv_wgmma) takes the element
// type as its template argument H, and two __global__ kernels instantiate
// it, so each type keeps a kernel name of its own. The fp16 forms differ
// from the bf16 ones in the wgmma type, the tensor maps' data type, the
// split's and the store's conversions, and in the backward's row scale of
// dS (flash_common.cuh: fp16's range is 2^-14 .. 65504, bf16's fp32's).
//
// What bounds them on the H100: the JAX kernel's 4 d (forward), 6 d (dq)
// and 8 d (dk/dv) FLOPs per visible pair at the dense bf16 rate (989
// TFLOP/s), one to two orders of magnitude above their bytes at the
// training shapes. P and dS are fp32 in the JAX kernel; here each is
// split into hi = bf16(x) and lo = bf16(x - hi) (bf16_mma.cuh; fp16 the
// same) and multiplied twice, so the forward and dk/dv do 1.5x and dq 4/3
// the bound's FLOPs. One bf16 term misrounds ~40 % of the outputs
// (chip_smoke.py's misround gate), so both terms stay. At d = 64 and
// short sequences (ERNIE: 512) a tile's products are small and its
// softmax, masks and split on the CUDA cores take as long: there the
// kernels are bound by instruction issue.
//
// Design (one block per (batch * head, tile of 128 rows of the block's
// own side), heaviest causal tiles first, dead causal and block-mask
// tiles skipped with their loads; no atomics, so the gradients are
// deterministic):
// - Warp specialisation: 3 warpgroups. Warpgroup 0 is the producer: one
//   thread keeps TMA loads of the streamed tiles in flight into a ring of
//   ST = 4 stages, each with a full and an empty mbarrier; setmaxnreg
//   gives its registers to the two consumer warpgroups (40 / 232 a
//   thread). Each consumer warpgroup owns 64 rows of the block's side;
//   a warp's 16 rows are its accumulator rows.
// - Forward: Q [128 x d] once; the ring streams K and V in tiles of 64
//   keys. S = Q K^T (both operands in shared memory), the masks on the
//   accumulator (tile_scores: scaling only inside the masks, the per-key
//   bias read once per key, frag_scores otherwise), the online softmax
//   with exp as 2^x on the special-function unit, P split into hi / lo
//   register A fragments, then O += P_lo V + P_hi V per 16-key step
//   (register A, V an MN-major operand). Each turn issues the next tile's
//   S and this tile's P V together and runs the next tile's softmax under
//   P V; the accumulator's rescale waits for P V.
// - dk/dv: K and V [128 x d] once; the ring streams Q and dO in tiles of
//   32 query rows, and the producer warp copies each tile's lse and delta
//   into the stage (its 32 lanes arrive on the full barrier with them).
//   In the transposed form S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//   are accumulators and never leave registers: P = exp(s - lse) with the
//   guard, dS = scale P (dP - delta), each split, then dV += P^T dO and
//   dK += dS^T Q, lo then hi per 16-row step (register A, dO and Q
//   MN-major).
// - dq: the forward's shape with a second score product. Q and dO
//   [128 x d] once, lse and delta of each thread's two rows read once
//   into registers; the ring streams K and V in tiles of 32 keys. S = Q
//   K^T and dP = dO V^T (both operands in shared memory), P = exp(s -
//   lse) with the masks and the guard (tile_scores), dS = scale P (dP -
//   delta) split in two terms, then dQ += dS_lo K + dS_hi K per 16-key
//   step (register A, K an MN-major operand: the forward's P V with dS
//   for P and K for V). dQ's product of a tile stays in flight while the
//   next tile's S and dP are issued; its stage is released after them.
// - Accumulation: the chains of S, S^T and the split products sum their
//   k-steps in the tensor cores (over d, over a tile's keys or queries);
//   tiles add up in the fp32 accumulators. dP and dP^T sum each k-step's
//   product in fp32 instead (a zero-scaled wgmma per k-step into one of
//   two scratch accumulators, two in flight, P formed meanwhile): where a
//   row sees one key, dS = P (dP - delta) cancels to rounding noise, and
//   the tensor cores' running sum rounds coarser than fp32 (with dP^T's
//   chain in the tensor cores, dk at sq = sk = 1 sat at the edge of the
//   2x gate against fp64).
// - Registers: ptxas gives the consumers their 232 only if no path of the
//   kernel traps (sm90_wgmma.cuh's barrier wait has no bounded-poll
//   trap); tiles of 64 keys (forward) and 32 rows (dq's keys, dk/dv's
//   queries) keep the accumulators, S, dP, P's or dS's two terms and the
//   scratch within them, unspilled.
// - Shared memory (d = 128): forward Q 32 KB + 4 stages x (K, V) 32 KB =
//   160 KB; dq Q, dO 64 KB + 4 stages x (K, V) 16 KB = 128 KB; dk/dv K, V
//   64 KB + 4 stages x (Q, dO) 16 KB + lse and delta = 129 KB; one block
//   per SM. Tiles are boxes of 64 columns in the 128-byte swizzle
//   (sm90_wgmma.cuh), two per row at d > 64.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "flash_common.cuh"
#include "sm90_wgmma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWgThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kRows = 128;        // rows of the block's own side
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Bytes of a tile of R rows and MAXD columns: MAXD / 64 boxes of R rows
// of 128 bytes.
template <int R, int MAXD>
constexpr uint32_t tile_bytes() {
  return (uint32_t)R * MAXD * 2;
}

// The boxes of rows [row0, row0 + R) of a tile, one TMA load each.
template <int R, int MAXD>
__device__ __forceinline__ void load_tile_tma(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int head,
                                              int row0, int b) {
#pragma unroll
  for (int j = 0; j < MAXD / 64; ++j) {
    tma_load_4d(dst + j * R * 128, map, bar, 64 * j, head, row0, b);
  }
}

// The descriptor of k-step kk (16 columns of d) of a K-major operand: rows
// from row0 of a tile of R rows.
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  return sw128_desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32,
                    16, 1024);
}

// The descriptor of k-step mm (rows 16 mm .. + 16) of an MN-major operand
// of a tile of R rows: its d columns in boxes R * 128 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int mm) {
  return sw128_desc(tile + mm * 16 * 128, R * 128, 1024);
}

// acc += (hi + lo) Y over the NK 16-row steps of a register operand split
// in two terms of type H, lo first, Y an MN-major tile of R rows.
template <int R, int H, int NK, int NTO>
__device__ __forceinline__ void wgmma_split(float (&acc)[NTO][4],
                                            uint32_t (&hi)[NK][4],
                                            uint32_t (&lo)[NK][4],
                                            uint32_t y) {
  reg_fence(acc);
  reg_fence(hi);
  reg_fence(lo);
  wgmma_fence();
#pragma unroll
  for (int mm = 0; mm < NK; ++mm) {
    const uint64_t desc = mnmajor_desc<R>(y, mm);
    wgmma_rs<H>(acc, lo[mm], desc, 1);
    wgmma_rs<H>(acc, hi[mm], desc, 1);
  }
  wgmma_commit();
}

// A warp's accumulator tiles split in two terms of type H, as NT / 2
// register A fragments each.
template <int H, int NT>
__device__ __forceinline__ void split_all(const float (&c)[NT][4],
                                          uint32_t (&hi)[NT / 2][4],
                                          uint32_t (&lo)[NT / 2][4]) {
#pragma unroll
  for (int mm = 0; mm < NT / 2; ++mm) {
    split_frag_a<H>(c, mm, hi[mm], lo[mm]);
  }
}

// P's tiles split for their products: at fp16 times kPScale first
// (flash_common.cuh), the caller's output taking 1 / kPScale.
template <int H, int NT>
__device__ __forceinline__ void split_p(float (&p)[NT][4],
                                        uint32_t (&hi)[NT / 2][4],
                                        uint32_t (&lo)[NT / 2][4]) {
  if constexpr (H == kF16) scale_frags(p, kPScale);
  split_all<H>(p, hi, lo);
}

// Whether every pair of the rows [r0, r0 + nr) and the keys [k0, k0 + nk)
// is visible: inside both lengths and, under the causal mask, the last key
// visible from the first row.
__device__ __forceinline__ bool all_visible(int r0, int nr, int k0, int nk,
                                            const Dims& dm) {
  return r0 + nr <= dm.Sq && k0 + nk <= dm.Sk &&
         (!dm.causal || k0 + nk - 1 <= r0 + (dm.Sk - dm.Sq));
}

// Scores from raw products in fragment coordinates (frag_scores_of's
// layout and TRANSPOSED) when the per-key bias is the only masking
// operand, the key-padding form ERNIE trains with: each of the thread's
// keys' bias read once (2 keys a thread transposed, 2 per 8-key tile
// otherwise), the pairs' visibility checked only where `inside` is false.
template <bool TRANSPOSED, int NT>
__device__ __forceinline__ void kbias_scores(float (&c)[NT][4], int b,
                                             int mb, int nb, bool inside,
                                             const Dims& dm) {
  const float* kb = dm.kbias + (int64_t)b * dm.Sk;
  float bias[TRANSPOSED ? 2 : 2 * NT];   // per key: rows h, or columns
  if (TRANSPOSED) {
    bias[0] = mb < dm.Sk ? __ldg(kb + mb) : 0.f;
    bias[1] = mb + 8 < dm.Sk ? __ldg(kb + mb + 8) : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int key = nb + 8 * (j >> 1) + (j & 1);
      bias[j] = inside || key < dm.Sk ? __ldg(kb + key) : 0.f;
    }
  }
#define PT_BIAS(i, r) (TRANSPOSED ? bias[(r) >> 1] : bias[2 * (i) + ((r) & 1)])
  if (inside) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) c[i][r] = c[i][r] * dm.scale + PT_BIAS(i, r);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = mb + 8 * (r >> 1), n = nb + 8 * i + (r & 1);
      const int row = TRANSPOSED ? n : m, key = TRANSPOSED ? m : n;
      c[i][r] = visible(row, key, dm) ? c[i][r] * dm.scale + PT_BIAS(i, r)
                                      : kNegInf;
    }
  }
#undef PT_BIAS
}

// A warp's scores from its raw products, in place: rows from r0 and the n
// keys from k0 (TRANSPOSED: keys from r0 as rows, queries from k0), at
// lane (g, t). The dense form inside the masks scales only; the per-key
// bias alone takes kbias_scores; any other mask the generic frag_scores.
template <bool TRANSPOSED, int NT>
__device__ __forceinline__ void tile_scores(float (&c)[NT][4], int b,
                                            int head, int r0, int k0, int g,
                                            int t, const Dims& dm) {
  reg_fence(c);
  const bool inside = TRANSPOSED ? all_visible(k0, 8 * NT, r0, 16, dm)
                                 : all_visible(r0, 16, k0, 8 * NT, dm);
  if (dm.mask || dm.qseg) {
    frag_scores<TRANSPOSED>(c, b, head, r0 + g, k0 + 2 * t, dm);
  } else if (dm.kbias) {
    kbias_scores<TRANSPOSED>(c, b, r0 + g, k0 + 2 * t, inside, dm);
  } else if (inside) {
    scale_frags(c, dm.scale);
  } else {
    frag_scores_of<false, TRANSPOSED>(c, b, head, r0 + g, k0 + 2 * t, dm);
  }
}

// ------------------------------------------------------------ forward

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22, well under the
// 2^-17 of the P split; outputs below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax's step for one tile of scores s (fragment layout):
// the running max m and sum l of rows g and g + 8, s replaced by P =
// exp(s - m) (2^((s - m) log2 e); a hard-masked score gives 0 exactly),
// and corr, the factor the accumulator takes for the new max (applied by
// the caller once its P V product of the tile before has completed).
template <int NT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mneg[2];   // -m log2 e
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
    corr[h] = exp2_approx((m[h] - m_new) * kLog2e);
    m[h] = m_new;
    mneg[h] = -m_new * kLog2e;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = s[i][r];
      const float p = x <= kMaskedBelow
                          ? 0.f
                          : exp2_approx(fmaf(x, kLog2e, mneg[r >> 1]));
      s[i][r] = p;
      l[r >> 1] += p;
    }
  }
}

// S = Q K^T for a warpgroup's 64 rows of Q (from shared address q64, a
// tile of kRows rows) and the BN keys of the K tile at kt, issued as one
// wgmma group.
template <int MAXD, int BN, int H>
__device__ __forceinline__ void issue_scores(float (&s)[BN / 8][4],
                                             uint32_t q64, uint32_t kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < MAXD / 16; ++kk) {
    wgmma_ss<H>(s, kmajor_desc<kRows>(q64, 0, kk),
                kmajor_desc<BN>(kt, 0, kk), kk > 0);
  }
  wgmma_commit();
}

// BN keys per streamed tile, ST stages in the ring.
template <int MAXD>
struct FwdWg {
  static constexpr int BN = 64, ST = 4;
  static constexpr uint32_t kQ = tile_bytes<kRows, MAXD>();
  static constexpr uint32_t kKV = tile_bytes<BN, MAXD>();
  // Q | K[ST] | V[ST] | barriers (q, full[ST], empty[ST])
  static constexpr uint32_t kBars = kQ + 2 * ST * kKV;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 2 * ST);
};

// The forward's body for 16-bit operands of type H; the kernels below
// instantiate it for bf16 and fp16 (tq, tk, tv: their __grid_constant__
// tensor maps).
template <int MAXD, int H>
__device__ __forceinline__ void fwd_wgmma(const CUtensorMap& tq,
                                          const CUtensorMap& tk,
                                          const CUtensorMap& tv,
                                          uint16_t* __restrict__ o,
                                          float* __restrict__ lse,
                                          const Dims& dm) {
  using T = FwdWg<MAXD>;
  constexpr int BN = T::BN, ST = T::ST, NT = BN / 8, NTO = MAXD / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (shared_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sk = sq + T::kQ, sv = sk + ST * T::kKV;
  const uint32_t qbar = base + T::kBars;
  auto full = [&](int s) { return qbar + 8 * (1 + s); };
  auto empty = [&](int s) { return qbar + 8 * (1 + ST + s); };

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int kend = key_end(q0, kRows, dm);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, T::kQ);
      load_tile_tma<kRows, MAXD>(sq, &tq, qbar, head, q0, b);
      int st = 0;
      uint32_t ph = 0;
      for (int k0 = live_key_tile<BN>(q0, 0, kend, dm); k0 < kend;
           k0 = live_key_tile<BN>(q0, k0 + BN, kend, dm)) {
        mbar_wait(empty(st), ph ^ 1);
        mbar_arrive_expect_tx(full(st), 2 * T::kKV);
        load_tile_tma<BN, MAXD>(sk + st * T::kKV, &tk, full(st), head, k0, b);
        load_tile_tma<BN, MAXD>(sv + st * T::kKV, &tv, full(st), head, k0, b);
        if (++st == ST) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. + 64 of the tile
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 64 * cw + 16 * warp;   // this warp's first row
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float s[NT][4];
  uint32_t hi[NT / 2][4], lo[NT / 2][4];   // P of the tile before

  mbar_wait(qbar, 0);
  int k0 = live_key_tile<BN>(q0, 0, kend, dm);
  int st = 0;
  uint32_t ph = 0;
  if (k0 < kend) {
    mbar_wait(full(st), ph);
    issue_scores<MAXD, BN, H>(s, sq + 64 * cw * 128, sk + st * T::kKV);
    wgmma_wait<0>();
    tile_scores<false>(s, b, head, q0 + m0, k0, g, t, dm);
    softmax_step(s, m, l, corr);   // acc is 0: no correction to apply
    split_p<H>(s, hi, lo);
    // each turn: S of the next tile and P V of this one go to the tensor
    // cores together; the next tile's softmax runs under this one's P V
    for (int kn = live_key_tile<BN>(q0, k0 + BN, kend, dm); kn < kend;
         kn = live_key_tile<BN>(q0, kn + BN, kend, dm)) {
      const int sn = st + 1 == ST ? 0 : st + 1;
      const uint32_t pn = sn == 0 ? ph ^ 1 : ph;
      mbar_wait(full(sn), pn);
      reg_fence(acc);
      reg_fence(hi);
      reg_fence(lo);
      issue_scores<MAXD, BN, H>(s, sq + 64 * cw * 128, sk + sn * T::kKV);
#pragma unroll
      for (int mm = 0; mm < NT / 2; ++mm) {
        const uint64_t desc = mnmajor_desc<BN>(sv + st * T::kKV, mm);
        wgmma_rs<H>(acc, lo[mm], desc, 1);
        wgmma_rs<H>(acc, hi[mm], desc, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();   // S of the next tile
      tile_scores<false>(s, b, head, q0 + m0, kn, g, t, dm);
      softmax_step(s, m, l, corr);
      wgmma_wait<0>();   // P V of this tile
      reg_fence(acc);
      if (lane == 0) mbar_arrive(empty(st));   // this stage is consumed
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] *= corr[r >> 1];
      }
      split_p<H>(s, hi, lo);
      st = sn;
      ph = pn;
    }
    wgmma_split<BN, H>(acc, hi, lo, sv + st * T::kKV);   // the last P V
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(empty(st));
  }

  const int64_t rs = (int64_t)dm.H * dm.d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * dm.d;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float den = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / den;
    const int row = q0 + m0 + g + 8 * h;
    if (row < dm.Sq && t == 0) {
      lse[(int64_t)bh * dm.Sq + row] = m[h] + logf(den);
    }
    if constexpr (H == kF16) inv[h] *= 1.f / kPScale;
  }
  store_frags16<NTO, H>(o + qoff, rs, acc, inv, q0 + m0, dm.Sq, 0, dm.d, g,
                        t);
}

template <int MAXD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            uint16_t* __restrict__ o,
                            float* __restrict__ lse, Dims dm) {
  fwd_wgmma<MAXD, kBf16>(tq, tk, tv, o, lse, dm);
}

template <int MAXD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_f16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           uint16_t* __restrict__ o,
                           float* __restrict__ lse, Dims dm) {
  fwd_wgmma<MAXD, kF16>(tq, tk, tv, o, lse, dm);
}

// ------------------------------------------------- the backward's scores

// The backward's two score products for a warpgroup's 64 rows (from row0
// of the kRows-row tiles a and c) and the BN rows of the streamed tiles b
// and d, all K-major over d: S = a b^T sums its k-steps in the tensor
// cores; dP = c d^T sums each k-step's product in fp32 (dS = P (dP -
// delta) cancels where a row sees one key, and the tensor cores' running
// sum rounds coarser than fp32). issue_scores_bwd issues S with dP's
// first k-step, then dP's second and third k-steps into the scratch pa
// and pb, as three wgmma groups; the caller waits for the first
// (wgmma_wait<2>) and forms P while the other two run, then
// sum_dp_steps adds each scratch product to dP as it completes and
// issues the next k-step into it, two in flight, until every group the
// caller issued has completed.
template <int MAXD, int BN, int H>
__device__ __forceinline__ void issue_scores_bwd(float (&s)[BN / 8][4],
                                                 float (&dp)[BN / 8][4],
                                                 float (&pa)[BN / 8][4],
                                                 float (&pb)[BN / 8][4],
                                                 uint32_t a, uint32_t b,
                                                 uint32_t c, uint32_t d,
                                                 int row0) {
  reg_fence(pa);
  reg_fence(pb);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < MAXD / 16; ++kk) {
    wgmma_ss<H>(s, kmajor_desc<kRows>(a, row0, kk),
                kmajor_desc<BN>(b, 0, kk), kk > 0);
  }
  wgmma_ss<H>(dp, kmajor_desc<kRows>(c, row0, 0), kmajor_desc<BN>(d, 0, 0),
              0);
  wgmma_commit();
  wgmma_ss<H>(pa, kmajor_desc<kRows>(c, row0, 1), kmajor_desc<BN>(d, 0, 1),
              0);
  wgmma_commit();
  wgmma_ss<H>(pb, kmajor_desc<kRows>(c, row0, 2), kmajor_desc<BN>(d, 0, 2),
              0);
  wgmma_commit();
}

template <int MAXD, int BN, int H>
__device__ __forceinline__ void sum_dp_steps(float (&dp)[BN / 8][4],
                                             float (&pa)[BN / 8][4],
                                             float (&pb)[BN / 8][4],
                                             uint32_t c, uint32_t d,
                                             int row0) {
  constexpr int NK = MAXD / 16, NT = BN / 8;
#pragma unroll
  for (int kk = 1; kk < NK; ++kk) {
    float (&part)[NT][4] = (kk & 1) ? pa : pb;
    if (kk + 1 < NK) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    reg_fence(part);
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dp[i][r] += part[i][r];
    }
    if (kk + 2 < NK) {
      reg_fence(part);
      wgmma_fence();
      wgmma_ss<H>(part, kmajor_desc<kRows>(c, row0, kk + 2),
                  kmajor_desc<BN>(d, 0, kk + 2), 0);
      wgmma_commit();
    }
  }
}

// ------------------------------------------------------------- dk, dv

// BN query rows per streamed tile, ST stages in the ring. The two fp32
// accumulators take 128 registers a thread at d = 128, and S^T, dP^T and
// its two scratch accumulators 16 each at 32 rows; 64 rows time the same
// at d = 64 and spill there.
template <int MAXD>
struct DkvWg {
  static constexpr int BN = 32, ST = 4;
  static constexpr uint32_t kKV = tile_bytes<kRows, MAXD>();
  static constexpr uint32_t kQ = tile_bytes<BN, MAXD>();
  // K | V | Q[ST] | dO[ST] | lse[ST][BN] | delta[ST][BN] | barriers (kv,
  // full[ST], empty[ST])
  static constexpr uint32_t kRowsAt = 2 * kKV + 2 * ST * kQ;
  static constexpr uint32_t kBars = kRowsAt + 2 * ST * BN * 4;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 2 * ST);
};

// dk/dv's body for 16-bit operands of type H (the kernels below).
template <int MAXD, int H>
__device__ __forceinline__ void dkv_wgmma(const CUtensorMap& tq,
                                          const CUtensorMap& tk,
                                          const CUtensorMap& tv,
                                          const CUtensorMap& tdo,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          uint16_t* __restrict__ dk,
                                          uint16_t* __restrict__ dv,
                                          const Dims& dm) {
  using T = DkvWg<MAXD>;
  constexpr int BN = T::BN, ST = T::ST, NT = BN / 8, NTO = MAXD / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = shared_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base, sv = sk + T::kKV, sq = sv + T::kKV;
  const uint32_t sdo = sq + ST * T::kQ;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                          T::kRowsAt);   // [ST][BN]
  float* delta_s = lse_s + ST * BN;                      // [ST][BN]
  const uint32_t kvbar = base + T::kBars;
  auto full = [&](int s) { return kvbar + 8 * (1 + s); };
  auto empty = [&](int s) { return kvbar + 8 * (1 + ST + s); };

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int k0 = blockIdx.y * kRows;   // the first key tiles see the most rows
  // under the causal mask, rows before k0 - (Sk - Sq) see none of these
  // keys (the other masks only hide more)
  int qstart = 0;
  if (dm.causal) qstart = max(0, k0 - (dm.Sk - dm.Sq)) / BN * BN;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 32);   // the producer warp's lanes, lse and delta
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0; lane 0 issues the loads, every lane copies
    // lse and delta
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_b = lse + (int64_t)bh * dm.Sq;
      const float* delta_b = delta + (int64_t)bh * dm.Sq;
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * T::kKV);
        load_tile_tma<kRows, MAXD>(sk, &tk, kvbar, head, k0, b);
        load_tile_tma<kRows, MAXD>(sv, &tv, kvbar, head, k0, b);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int q1 = live_query_tile<BN>(qstart, k0, dm); q1 < dm.Sq;
           q1 = live_query_tile<BN>(q1 + BN, k0, dm)) {
        mbar_wait(empty(st), ph ^ 1);
        for (int r = lane; r < BN; r += 32) {
          const bool valid = q1 + r < dm.Sq;
          lse_s[st * BN + r] = valid ? __ldg(lse_b + q1 + r) : 0.f;
          delta_s[st * BN + r] = valid ? __ldg(delta_b + q1 + r) : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(st), 2 * T::kQ);
          load_tile_tma<BN, MAXD>(sq + st * T::kQ, &tq, full(st), head, q1,
                                  b);
          load_tile_tma<BN, MAXD>(sdo + st * T::kQ, &tdo, full(st), head,
                                  q1, b);
        } else {
          mbar_arrive(full(st));
        }
        if (++st == ST) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys 64 cw .. + 64 of the tile
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 64 * cw + 16 * warp;   // this warp's first key
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

  mbar_wait(kvbar, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int q1 = live_query_tile<BN>(qstart, k0, dm); q1 < dm.Sq;
       q1 = live_query_tile<BN>(q1 + BN, k0, dm)) {
    mbar_wait(full(st), ph);
    const uint32_t qt = sq + st * T::kQ, dot = sdo + st * T::kQ;
    const float* lse_t = lse_s + st * BN;
    const float* delta_t = delta_s + st * BN;
    // transposed scores: rows are this block's keys, columns the queries
    float s[NT][4], dp[NT][4], pa[NT][4], pb[NT][4];
    issue_scores_bwd<MAXD, BN, H>(s, dp, pa, pb, sk, qt, sv, dot, 64 * cw);
    wgmma_wait<2>();   // S^T and dP^T's first k-step
    tile_scores<true>(s, b, head, k0 + m0, q1, g, t, dm);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 8 * i + 2 * t + (r & 1);
        const float x = s[i][r];
        s[i][r] = x <= kMaskedBelow
                      ? 0.f
                      : exp2_approx((x - lse_t[n]) * kLog2e);
      }
    }
    sum_dp_steps<MAXD, BN, H>(dp, pa, pb, sv, dot, 64 * cw);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 8 * i + 2 * t + (r & 1);
        dp[i][r] = ds_mul[r >> 1] * (s[i][r] * (dp[i][r] - delta_t[n]));
      }
    }
    uint32_t hi[NT / 2][4], lo[NT / 2][4];
    split_p<H>(s, hi, lo);
    wgmma_split<BN, H>(dv_acc, hi, lo, dot);   // dV += P^T dO
    uint32_t dhi[NT / 2][4], dlo[NT / 2][4];
    split_all<H>(dp, dhi, dlo);
    wgmma_split<BN, H>(dk_acc, dhi, dlo, qt);  // dK += dS^T Q
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    if (lane == 0) mbar_arrive(empty(st));   // this stage is consumed
    if (++st == ST) {
      st = 0;
      ph ^= 1;
    }
  }

  const int64_t rs = (int64_t)dm.H * dm.d;
  const int64_t koff = ((int64_t)b * dm.Sk * dm.H + head) * dm.d;
  float unp[2] = {1.f, 1.f};   // at fp16 dv's rows times 1 / kPScale
  if constexpr (H == kF16) unp[0] = unp[1] = 1.f / kPScale;
  float unf[2];   // dk's rows: 1 / their ds_scale at fp16
  ds_row_inverses<H>(dm, ds_mul, unf);
  store_frags16<NTO, H>(dk + koff, rs, dk_acc, unf, k0 + m0, dm.Sk, 0, dm.d,
                        g, t);
  store_frags16<NTO, H>(dv + koff, rs, dv_acc, unp, k0 + m0, dm.Sk, 0, dm.d,
                        g, t);
}

template <int MAXD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                uint16_t* __restrict__ dk,
                                uint16_t* __restrict__ dv, Dims dm) {
  dkv_wgmma<MAXD, kBf16>(tq, tk, tv, tdo, lse, delta, dk, dv, dm);
}

template <int MAXD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_f16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               uint16_t* __restrict__ dk,
                               uint16_t* __restrict__ dv, Dims dm) {
  dkv_wgmma<MAXD, kF16>(tq, tk, tv, tdo, lse, delta, dk, dv, dm);
}

// ----------------------------------------------------------------- dq

// BN keys per streamed tile, ST stages in the ring. dQ takes 64 registers
// a thread at d = 128, and S, dP, dP's two scratch accumulators BN / 2
// each and dS's two terms (kept until dQ's product of the tile has run)
// BN / 4 each: 144 at 32 keys, 224 at 64, which spills.
template <int MAXD>
struct DqWg {
  static constexpr int BN = 32, ST = 4;
  static constexpr uint32_t kQ = tile_bytes<kRows, MAXD>();
  static constexpr uint32_t kKV = tile_bytes<BN, MAXD>();
  // Q | dO | K[ST] | V[ST] | barriers (q, full[ST], empty[ST])
  static constexpr uint32_t kBars = 2 * kQ + 2 * ST * kKV;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 2 * ST);
};

// dq's body for 16-bit operands of type H (the kernels below).
template <int MAXD, int H>
__device__ __forceinline__ void dq_wgmma(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const CUtensorMap& tdo,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         uint16_t* __restrict__ dq,
                                         const Dims& dm) {
  using T = DqWg<MAXD>;
  constexpr int BN = T::BN, ST = T::ST, NT = BN / 8, NTO = MAXD / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (shared_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = sq + T::kQ, sk = sdo + T::kQ;
  const uint32_t sv = sk + ST * T::kKV;
  const uint32_t qbar = base + T::kBars;
  auto full = [&](int s) { return qbar + 8 * (1 + s); };
  auto empty = [&](int s) { return qbar + 8 * (1 + ST + s); };

  const int bh = blockIdx.x, b = bh / dm.H, head = bh - b * dm.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int kend = key_end(q0, kRows, dm);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, 2 * T::kQ);
      load_tile_tma<kRows, MAXD>(sq, &tq, qbar, head, q0, b);
      load_tile_tma<kRows, MAXD>(sdo, &tdo, qbar, head, q0, b);
      int st = 0;
      uint32_t ph = 0;
      for (int k0 = live_key_tile<BN>(q0, 0, kend, dm); k0 < kend;
           k0 = live_key_tile<BN>(q0, k0 + BN, kend, dm)) {
        mbar_wait(empty(st), ph ^ 1);
        mbar_arrive_expect_tx(full(st), 2 * T::kKV);
        load_tile_tma<BN, MAXD>(sk + st * T::kKV, &tk, full(st), head, k0, b);
        load_tile_tma<BN, MAXD>(sv + st * T::kKV, &tv, full(st), head, k0, b);
        if (++st == ST) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. + 64 of the tile
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 64 * cw + 16 * warp;   // this warp's first row
  // lse and delta of rows g (h = 0) and g + 8 (h = 1), read once
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    const bool valid = row < dm.Sq;
    row_lse[h] = valid ? __ldg(lse + (int64_t)bh * dm.Sq + row) : 0.f;
    row_delta[h] = valid ? __ldg(delta + (int64_t)bh * dm.Sq + row) : 0.f;
  }
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  uint32_t hi[NT / 2][4], lo[NT / 2][4];   // dS of the tile before
  // dS's multipliers of rows g and g + 8 (at fp16 with their ds_scale)
  float ds_mul[2];
  ds_row_multipliers<H>(dm, bh, q0 + m0, dm.Sq, g, ds_mul);

  mbar_wait(qbar, 0);
  int st = 0, prev = -1;   // prev: the stage dQ's last product reads
  uint32_t ph = 0;
  for (int k0 = live_key_tile<BN>(q0, 0, kend, dm); k0 < kend;
       k0 = live_key_tile<BN>(q0, k0 + BN, kend, dm)) {
    mbar_wait(full(st), ph);
    const uint32_t kt = sk + st * T::kKV, vt = sv + st * T::kKV;
    // the tile before's dQ product is still in flight ahead of S and dP
    float s[NT][4], dp[NT][4], pa[NT][4], pb[NT][4];
    issue_scores_bwd<MAXD, BN, H>(s, dp, pa, pb, sq, kt, sdo, vt, 64 * cw);
    wgmma_wait<2>();   // the tile before's dQ, S and dP's first k-step
    reg_fence(acc);
    reg_fence(hi);
    reg_fence(lo);
    if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));   // consumed
    tile_scores<false>(s, b, head, q0 + m0, k0, g, t, dm);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[i][r];
        s[i][r] = x <= kMaskedBelow
                      ? 0.f
                      : exp2_approx((x - row_lse[r >> 1]) * kLog2e);
      }
    }
    sum_dp_steps<MAXD, BN, H>(dp, pa, pb, sdo, vt, 64 * cw);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dp[i][r] = ds_mul[r >> 1] *
                   (s[i][r] * (dp[i][r] - row_delta[r >> 1]));
      }
    }
    split_all<H>(dp, hi, lo);
    wgmma_split<BN, H>(acc, hi, lo, kt);   // dQ += dS K, waited next turn
    prev = st;
    if (++st == ST) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));

  const int64_t rs = (int64_t)dm.H * dm.d;
  const int64_t qoff = ((int64_t)b * dm.Sq * dm.H + head) * dm.d;
  float unf[2];   // dq's rows: 1 / their ds_scale at fp16
  ds_row_inverses<H>(dm, ds_mul, unf);
  store_frags16<NTO, H>(dq + qoff, rs, acc, unf, q0 + m0, dm.Sq, 0, dm.d, g,
                        t);
}

template <int MAXD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               uint16_t* __restrict__ dq, Dims dm) {
  dq_wgmma<MAXD, kBf16>(tq, tk, tv, tdo, lse, delta, dq, dm);
}

template <int MAXD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_f16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              uint16_t* __restrict__ dq, Dims dm) {
  dq_wgmma<MAXD, kF16>(tq, tk, tv, tdo, lse, delta, dq, dm);
}

// ----------------------------------------------------------- launches

template <int MAXD, int H>
cudaError_t launch_fwd(const uint16_t* q, const uint16_t* k,
                       const uint16_t* v, uint16_t* o, float* lse, int B,
                       const Dims& dm, cudaStream_t st) {
  using T = FwdWg<MAXD>;
  const auto kernel = H == kF16 ? flash_fwd_f16_wgmma_kernel<MAXD>
                                : flash_fwd_bf16_wgmma_kernel<MAXD>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_bshd16<H>(&tq, q, B, dm.Sq, dm.H, dm.d, kRows);
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tk, k, B, dm.Sk, dm.H, dm.d, T::BN);
  }
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tv, v, B, dm.Sk, dm.H, dm.d, T::BN);
  }
  if (err == cudaSuccess) err = opt_in(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + kRows - 1) / kRows);
  kernel<<<grid, kWgThreads, T::kSmem, st>>>(tq, tk, tv, o, lse, dm);
  return cudaGetLastError();
}

template <int MAXD, int H>
cudaError_t launch_dkv(const uint16_t* q, const uint16_t* k,
                       const uint16_t* v, const uint16_t* dout,
                       const float* lse, const float* delta, uint16_t* dk,
                       uint16_t* dv, int B, const Dims& dm, cudaStream_t st) {
  using T = DkvWg<MAXD>;
  const auto kernel = H == kF16 ? flash_bwd_dkv_f16_wgmma_kernel<MAXD>
                                : flash_bwd_dkv_bf16_wgmma_kernel<MAXD>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd16<H>(&tq, q, B, dm.Sq, dm.H, dm.d, T::BN);
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tdo, dout, B, dm.Sq, dm.H, dm.d, T::BN);
  }
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tk, k, B, dm.Sk, dm.H, dm.d, kRows);
  }
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tv, v, B, dm.Sk, dm.H, dm.d, kRows);
  }
  if (err == cudaSuccess) err = opt_in(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sk + kRows - 1) / kRows);
  kernel<<<grid, kWgThreads, T::kSmem, st>>>(tq, tk, tv, tdo, lse, delta,
                                             dk, dv, dm);
  return cudaGetLastError();
}

template <int MAXD, int H>
cudaError_t launch_dq(const uint16_t* q, const uint16_t* k,
                      const uint16_t* v, const uint16_t* dout,
                      const float* lse, const float* delta, uint16_t* dq,
                      int B, const Dims& dm, cudaStream_t st) {
  using T = DqWg<MAXD>;
  const auto kernel = H == kF16 ? flash_bwd_dq_f16_wgmma_kernel<MAXD>
                                : flash_bwd_dq_bf16_wgmma_kernel<MAXD>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd16<H>(&tq, q, B, dm.Sq, dm.H, dm.d, kRows);
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tdo, dout, B, dm.Sq, dm.H, dm.d, kRows);
  }
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tk, k, B, dm.Sk, dm.H, dm.d, T::BN);
  }
  if (err == cudaSuccess) {
    err = encode_bshd16<H>(&tv, v, B, dm.Sk, dm.H, dm.d, T::BN);
  }
  if (err == cudaSuccess) err = opt_in(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * dm.H, (dm.Sq + kRows - 1) / kRows);
  kernel<<<grid, kWgThreads, T::kSmem, st>>>(tq, tk, tv, tdo, lse, delta,
                                             dq, dm);
  return cudaGetLastError();
}

// The launchers of one 16-bit type, by head dim.
template <int H>
cudaError_t launch_fwd16(const uint16_t* q, const uint16_t* k,
                         const uint16_t* v, uint16_t* o, float* lse, int B,
                         const Dims& dm, cudaStream_t st) {
  if (dm.d <= 64) return launch_fwd<64, H>(q, k, v, o, lse, B, dm, st);
  return launch_fwd<128, H>(q, k, v, o, lse, B, dm, st);
}

template <int H>
cudaError_t launch_dq16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const uint16_t* dout,
                        const float* lse, const float* delta, uint16_t* dq,
                        int B, const Dims& dm, cudaStream_t st) {
  if (dm.d <= 64) {
    return launch_dq<64, H>(q, k, v, dout, lse, delta, dq, B, dm, st);
  }
  return launch_dq<128, H>(q, k, v, dout, lse, delta, dq, B, dm, st);
}

template <int H>
cudaError_t launch_dkv16(const uint16_t* q, const uint16_t* k,
                         const uint16_t* v, const uint16_t* dout,
                         const float* lse, const float* delta, uint16_t* dk,
                         uint16_t* dv, int B, const Dims& dm,
                         cudaStream_t st) {
  if (dm.d <= 64) {
    return launch_dkv<64, H>(q, k, v, dout, lse, delta, dk, dv, B, dm, st);
  }
  return launch_dkv<128, H>(q, k, v, dout, lse, delta, dk, dv, B, dm, st);
}

}  // namespace

namespace flash {

cudaError_t launch_fwd_bf16_wgmma(const uint16_t* q, const uint16_t* k,
                                  const uint16_t* v, uint16_t* o,
                                  float* lse, int B, const Dims& dm,
                                  cudaStream_t st) {
  return launch_fwd16<kBf16>(q, k, v, o, lse, B, dm, st);
}

cudaError_t launch_dq_bf16_wgmma(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, const uint16_t* dout,
                                 const float* lse, const float* delta,
                                 uint16_t* dq, int B, const Dims& dm,
                                 cudaStream_t st) {
  return launch_dq16<kBf16>(q, k, v, dout, lse, delta, dq, B, dm, st);
}

cudaError_t launch_dkv_bf16_wgmma(const uint16_t* q, const uint16_t* k,
                                  const uint16_t* v, const uint16_t* dout,
                                  const float* lse, const float* delta,
                                  uint16_t* dk, uint16_t* dv, int B,
                                  const Dims& dm, cudaStream_t st) {
  return launch_dkv16<kBf16>(q, k, v, dout, lse, delta, dk, dv, B, dm, st);
}

cudaError_t launch_fwd_f16_wgmma(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, uint16_t* o, float* lse,
                                 int B, const Dims& dm, cudaStream_t st) {
  return launch_fwd16<kF16>(q, k, v, o, lse, B, dm, st);
}

cudaError_t launch_dq_f16_wgmma(const uint16_t* q, const uint16_t* k,
                                const uint16_t* v, const uint16_t* dout,
                                const float* lse, const float* delta,
                                uint16_t* dq, int B, const Dims& dm,
                                cudaStream_t st) {
  return launch_dq16<kF16>(q, k, v, dout, lse, delta, dq, B, dm, st);
}

cudaError_t launch_dkv_f16_wgmma(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, const uint16_t* dout,
                                 const float* lse, const float* delta,
                                 uint16_t* dk, uint16_t* dv, int B,
                                 const Dims& dm, cudaStream_t st) {
  return launch_dkv16<kF16>(q, k, v, dout, lse, delta, dk, dv, B, dm, st);
}

}  // namespace flash
