// Paged single-token decode attention (fp32 pools, MHA) for Hopper, sm_90a.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py ::
//   paged_decode_attention (kernel body _paged_decode_kernel).
//
// One decode query per sequence and head: q [b, h, d]; pools
// [N, page_size, h, d]; block_table [b, P]; pos [b] (int32). Keys at
// positions <= pos[b] are visible (the token at pos was written before the
// call), capped at P * page_size; pages past pos are never read. A sequence
// with no visible key (pos < 0) gets zeros. Returns [b, h, d].
//
// What bounds it on the H100: the bytes. Each visible key costs 2 * d * 4
// bytes of K and V against 4 * d FLOPs, about half an operation per byte,
// so the page reads at 3.35 TB/s set the floor; the sums stay fp32 on the
// CUDA cores (the tensor cores have nothing to offer at that ratio).
//
// Design (flash-decoding over a persistent grid):
// - Each (sequence, head)'s visible keys are cut into splits of
//   keys_per_split keys (a constant of the wrapper, never derived from the
//   batch). The work list holds every split of every sequence, h heads
//   each, sequence-major; each block scans pos into its prefix over the
//   sequences in shared memory, so the host never reads pos. The grid is
//   as many blocks of four warps as the card holds at once, sized from the
//   shapes alone, and block k takes items k, k + grid, ...: a short batch
//   in a long table costs no empty blocks, and no block holds more than
//   one item above another (a stride over every possible split, live or
//   not, left some blocks three items where most had one or two).
// - Inside a split, warp w owns the tiles w, w + 4, ... of KT keys (4 at
//   d <= 128, 2 above: 2 KB of K rows either way) and keeps its own online
//   softmax (m, l, acc). The warp's tiles over all of its block's items are
//   one stream of 16-byte cp.async.cg copies into a private ring of
//   kStages shared-memory stages, kStages - 1 tiles ahead of the tile being
//   scored and across item boundaries, with each tile's page-table entries
//   read one issue earlier, so no copy waits on a table read. LPK = 32 / KT
//   lanes score one key (each a strided part of d, a quarter-warp reading
//   one 128-byte line, free of bank conflicts); each lane owns float4
//   column chunks of acc. Deeper rings, eight warps, 2-key tiles and
//   an L2 prefetch hint on the copies measured no faster
//   (tools/k2_variants.py).
// - At the split's end the four warps merge in warp order through shared
//   memory. A sequence that fits one split writes its output there.
//   Otherwise the split writes its fp32 (m, l, acc) to the workspace, and
//   the block that finishes a (sequence, head) last (a ticket taken with
//   atomicAdd after __threadfence) merges all its splits from the
//   workspace in split order and resets the ticket to 0 for the next call.
//   A warp with no visible key (m = -1e30, l = 0) weighs exp(-1e30 - M) = 0
//   in the merge; a sequence without keys gets zeros. No float atomics, a
//   fixed merge order and a batch-independent split size: a sequence's
//   output does not depend on the rest of the batch, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"   // kNegInf, kMaskedBelow, cp_async16 and its waits

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;   // ring depth of each warp
constexpr int kMaxD = 256;
// keys_per_split must be a multiple of this (four warps' tiles at d <= 128)
constexpr int kSplitTile = 16;

template <int MAXD>
struct Cfg {
  static constexpr int KT = 512 / MAXD;        // keys a warp tile
  static constexpr int LPK = 32 / KT;          // lanes scoring one key
  static constexpr int QC = MAXD / 4 / LPK;    // q float4 chunks a lane
  static constexpr int NC = MAXD / 128;        // acc float4 chunks a lane
};

// The operands and sizes of one launch.
struct Args {
  const float* q;
  const float* k_pool;
  const float* v_pool;
  const int32_t* table;
  const int32_t* pos;
  float* out;
  float* part_acc;    // [b * h * n_splits, d] partial acc of each split
  float* part_ml;     // [b * h * n_splits, 2] its (m, l)
  int32_t* tickets;   // [b * h], 0 between calls
  int b, h, d, page_size, pages_per_seq, keys_per_split, n_splits;
  float scale;
};

__device__ __forceinline__ int visible_keys(const Args& a, int seq) {
  const int p = __ldg(a.pos + seq);
  return p < 0 ? 0 : min(p, a.pages_per_seq * a.page_size - 1) + 1;
}

__device__ __forceinline__ int splits_of(const Args& a, int n_keys) {
  return max(1, (n_keys + a.keys_per_split - 1) / a.keys_per_split);
}

// floats of the merges' area: the warps' states, or every split's (m, l)
// of a (sequence, head)
__host__ __device__ __forceinline__ int merge_floats(int d, int n_splits) {
  return max(kWarps * (d + 2), 2 * n_splits);
}

// dynamic shared memory: the rings, the merges' area, then the work
// list's prefix over the sequences and its scan buffer (2 (b + 1) ints)
template <int MAXD>
size_t smem_bytes(int d, int n_splits, int b) {
  return sizeof(float) * kWarps * kStages * 2 * Cfg<MAXD>::KT * d +
         sizeof(float) * merge_floats(d, n_splits) +
         sizeof(int) * 2 * ((size_t)b + 1);
}

// One work item: a split of one (sequence, head).
struct Item {
  int seq, head, split, n_split, k0, k1;
};

// item x of the work list -> (sequence, split, head): sequence-major
// through cum (cum[s] = h * the splits of the sequences before s; cum[b]
// = the items), then split, then head
__device__ __forceinline__ Item item_at(const Args& a, const int* cum,
                                        int x) {
  int lo = 0, hi = a.b;   // cum[lo] <= x < cum[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= x) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  Item it;
  it.seq = lo;
  const int r = x - cum[lo];
  it.split = r / a.h;
  it.head = r - it.split * a.h;
  const int n_keys = visible_keys(a, lo);
  it.n_split = splits_of(a, n_keys);
  it.k0 = it.split * a.keys_per_split;
  it.k1 = min(it.k0 + a.keys_per_split, n_keys);
  return it;
}

// the tiles warp w owns of an item: w, w + kWarps, ... below its tile count
template <int KT>
__device__ __forceinline__ int warp_tiles(const Item& it, int warp) {
  const int nt = (it.k1 - it.k0 + KT - 1) / KT;
  return nt > warp ? (nt - warp + kWarps - 1) / kWarps : 0;
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(Args a) {
  using C = Cfg<MAXD>;
  constexpr int KT = C::KT, LPK = C::LPK, QC = C::QC, NC = C::NC;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_last;
  const int d = a.d, d4 = d / 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stage = 2 * KT * d;                 // floats: K rows, V rows
  float* ring = smem + warp * kStages * stage;
  float* mg = smem + kWarps * kStages * stage;  // the merges' area
  int* cum = reinterpret_cast<int*>(mg + merge_floats(d, a.n_splits));
  int* scan = cum + a.b + 1;

  // the page table (a few KB) into L2, a slice from each block, so that no
  // block's table reads go to device memory
  {
    const int64_t line = (int64_t)blockIdx.x * kThreads + tid;   // 128 B
    if (line * 32 < (int64_t)a.b * a.pages_per_seq) {
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.table + line * 32));
    }
  }
  // the work list: every split of every sequence, h heads each; cum is
  // its prefix over the sequences (a scan in shared memory), so each
  // block's stride through it holds floor or ceil(items / grid) items
  for (int s = tid; s <= a.b; s += kThreads) {
    cum[s] = s == 0 ? 0 : a.h * splits_of(a, visible_keys(a, s - 1));
  }
  __syncthreads();
  for (int off = 1; off <= a.b; off <<= 1) {
    for (int s = tid; s <= a.b; s += kThreads) {
      scan[s] = cum[s] + (s >= off ? cum[s - off] : 0);
    }
    __syncthreads();
    int* t = cum;
    cum = scan;
    scan = t;
  }
  const int items = cum[a.b];
  const int kk = lane / LPK, part = lane % LPK;   // this lane's key, part

  // The copy side. The warp's tiles over all of the block's items form
  // one stream; a cursor runs kStages - 1 tiles ahead of the tile being
  // scored, across item boundaries, with the page-table entry of its tile
  // read one issue earlier.
  int p_item = (int)blockIdx.x - (int)gridDim.x, p_j = 0, p_nj = 0;
  Item p_it{};
  auto advance = [&]() -> bool {
    if (++p_j < p_nj) return true;
    for (p_item += gridDim.x; p_item < items; p_item += gridDim.x) {
      p_it = item_at(a, cum, p_item);
      p_nj = warp_tiles<KT>(p_it, warp);
      if (p_nj > 0) {
        p_j = 0;
        return true;
      }
    }
    return false;
  };
  // element offset of this lane's row of the cursor's tile, -1 past the
  // split
  auto row_at = [&]() -> int64_t {
    const int key = p_it.k0 + (warp + p_j * kWarps) * KT + kk;
    if (key >= p_it.k1) return -1;
    const int page = __ldg(a.table + (int64_t)p_it.seq * a.pages_per_seq +
                           key / a.page_size);
    return (((int64_t)page * a.page_size + key % a.page_size) * a.h +
            p_it.head) * d;
  };
  bool p_valid = advance();
  int64_t p_row = p_valid ? row_at() : -1;
  int issued = 0;
  // the cursor's tile into the next stage (this lane's part of its row's K
  // and V; a row past the split is zero-filled), then the cursor moves on
  auto issue = [&]() {
    if (p_valid) {                                // uniform across the warp
      float* kd = ring + (issued % kStages) * stage + kk * d;
      float* vd = kd + KT * d;
      const bool live = p_row >= 0;
      const float* kp = a.k_pool + (live ? p_row : 0);
      const float* vp = a.v_pool + (live ? p_row : 0);
      for (int c = part; c < d4; c += LPK) {
        cp_async16(kd + 4 * c, kp + 4 * c, live);
        cp_async16(vd + 4 * c, vp + 4 * c, live);
      }
      ++issued;
      p_valid = advance();
      p_row = p_valid ? row_at() : -1;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue();

  // The scoring side: the block's items in the same order.
  int consumed = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_at(a, cum, item);
    const int nj = warp_tiles<KT>(it, warp);
    const int64_t bhi = (int64_t)it.seq * a.h + it.head;
    const float4* q4 = reinterpret_cast<const float4*>(a.q + bhi * d);
    float4 qv[QC];
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const int c = part + LPK * i;
      qv[i] = c < d4 ? __ldg(q4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float m = kNegInf, l = 0.f;
    float4 acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int j = 0; j < nj; ++j, ++consumed) {
      issue();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const float* kt = ring + (consumed % kStages) * stage;
      const float* vt = kt + KT * d;

      // q . k of this lane's key over its parts of d
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        const int c = part + LPK * i;
        if (c < d4) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kt + kk * d + 4 * c);
          s += qv[i].x * kv.x + qv[i].y * kv.y + qv[i].z * kv.z +
               qv[i].w * kv.w;
        }
      }
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      const int key = it.k0 + (warp + j * kWarps) * KT + kk;
      s = key < it.k1 ? s * a.scale : kNegInf;
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
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
      }
      // acc += P V over the tile's keys
#pragma unroll
      for (int k2 = 0; k2 < KT; ++k2) {
        const float pk = __shfl_sync(0xffffffffu, p, k2 * LPK);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int col = lane + 32 * i;
          if (col < d4) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vt + k2 * d + 4 * col);
            acc[i].x += pk * vv.x; acc[i].y += pk * vv.y;
            acc[i].z += pk * vv.z; acc[i].w += pk * vv.w;
          }
        }
      }
      __syncwarp();   // this stage is consumed before it is refilled
    }

    // merge the warps' (m, l, acc) in warp order: [kWarps][d] partial
    // outputs, then [kWarps] of m and of l (the copies of later items stay
    // in flight meanwhile)
    float* macc = mg;
    float* mm = macc + kWarps * d;
    float* ml = mm + kWarps;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int col = lane + 32 * i;
      if (col < d4) {
        *reinterpret_cast<float4*>(macc + warp * d + 4 * col) = acc[i];
      }
    }
    if (lane == 0) {
      mm[warp] = m;
      ml[warp] = l;
    }
    __syncthreads();
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mm[w]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < d4) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(mm[w] - M);
        const float4 v4 =
            *reinterpret_cast<const float4*>(macc + w * d + 4 * tid);
        L += f * ml[w];
        A.x += f * v4.x; A.y += f * v4.y; A.z += f * v4.z; A.w += f * v4.w;
      }
    }
    float4* out4 = reinterpret_cast<float4*>(a.out + bhi * d);
    if (it.n_split == 1) {
      if (tid < d4) {
        const float inv = 1.f / fmaxf(L, 1e-30f);
        out4[tid] = make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv);
      }
      __syncthreads();   // the merge area is read before the next item
      continue;
    }

    // several splits: publish this one, and the last to finish merges all
    const int64_t p0 = bhi * a.n_splits;
    if (tid < d4) {
      reinterpret_cast<float4*>(a.part_acc + (p0 + it.split) * d)[tid] = A;
    }
    if (tid == 0) {
      a.part_ml[2 * (p0 + it.split)] = M;
      a.part_ml[2 * (p0 + it.split) + 1] = L;
    }
    // the block's writes, then one thread's fence and ticket (a fence in
    // every thread would also wait for its warp's copies in flight)
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      s_last = atomicAdd(a.tickets + bhi, 1) == it.n_split - 1;
      if (s_last) __threadfence();
    }
    __syncthreads();
    if (s_last) {
      // every split's (m, l) into the merge area, then each thread folds
      // its column chunk of every split's acc in split order
      float* sm = mg;
      float* sl = sm + it.n_split;
      for (int s = tid; s < it.n_split; s += kThreads) {
        sm[s] = __ldcg(a.part_ml + 2 * (p0 + s));
        sl[s] = __ldcg(a.part_ml + 2 * (p0 + s) + 1);
      }
      __syncthreads();
      if (tid < d4) {
        float Ms = kNegInf;
        for (int s = 0; s < it.n_split; ++s) Ms = fmaxf(Ms, sm[s]);
        float Ls = 0.f;
        float4 As = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int s = 0; s < it.n_split; ++s) {
          const float f = expf(sm[s] - Ms);
          const float4 v4 = __ldcg(
              reinterpret_cast<const float4*>(a.part_acc + (p0 + s) * d) +
              tid);
          Ls += f * sl[s];
          As.x += f * v4.x; As.y += f * v4.y;
          As.z += f * v4.z; As.w += f * v4.w;
        }
        const float inv = 1.f / fmaxf(Ls, 1e-30f);
        out4[tid] = make_float4(As.x * inv, As.y * inv, As.z * inv,
                                As.w * inv);
      }
      if (tid == 0) a.tickets[bhi] = 0;
    }
    __syncthreads();   // the merge area is free for the next item
  }
  cp_async_wait<0>();   // only empty groups are left
}

template <int MAXD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<MAXD>(a.d, a.n_splits, a.b);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // set at every size: the kernel's static shared memory counts against
  // the default 48 KiB too; the attribute is per device, so it is set on
  // the current one
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // as many blocks as the card holds at once (any grid of at least one
  // block computes the same result)
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_decode_kernel<MAXD>, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t items = (int64_t)a.n_splits * a.b * a.h;
  const int grid = (int)(items < resident ? items : resident);
  paged_decode_kernel<MAXD><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// part: b * h * n_splits * (d + 2) floats of workspace (written before it
// is read); tickets: b * h int32 zeros, left zero by the kernel.
extern "C" int paged_decode_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, void* part, void* tickets, int b, int h,
    int d, int page_size, int pages_per_seq, int keys_per_split,
    int n_splits, float scale, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD || page_size <= 0 ||
      keys_per_split <= 0 || keys_per_split % kSplitTile != 0 ||
      n_splits < 1 ||
      (int64_t)n_splits * keys_per_split <
          (int64_t)pages_per_seq * page_size) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || h == 0) return (int)cudaSuccess;
  float* p = static_cast<float*>(part);
  const int64_t n_part = (int64_t)b * h * n_splits;
  const Args a{static_cast<const float*>(q),
               static_cast<const float*>(k_pool),
               static_cast<const float*>(v_pool),
               static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(pos),
               static_cast<float*>(out),
               p,
               p + n_part * d,
               static_cast<int32_t*>(tickets),
               b, h, d, page_size, pages_per_seq, keys_per_split, n_splits,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d <= 128 ? (int)launch<128>(a, st) : (int)launch<256>(a, st);
}
