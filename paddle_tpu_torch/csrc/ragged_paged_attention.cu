// Ragged paged attention (fp32 pools) for Hopper, sm_90a.
//
// Replaces: paddle_tpu/ops/pallas/ragged_paged_attention.py ::
//   ragged_paged_attention (kernel body _ragged_kernel).
//
// Computes causal attention for a ragged batch of query spans straight off
// the paged K/V pools. q [B, T, n_q, d]; pools [N, page_size, n_kv, d];
// block_table [B, P]; start_pos, q_len [B] (int32). Query row t of sequence
// b sees the keys at positions <= start_pos[b] + t; rows t >= q_len[b] (and
// dead slots, q_len = 0) come out exactly 0.0. GQA groups the n_rep = n_q /
// n_kv query heads of one kv head into n_rep * T rows, row r = (rep, t)
// flattened with t = r % T, as the Pallas kernel does.
//
// What bounds it on the H100: a prefill chunk does 4 * d fp32 FLOPs per
// visible (row, key) pair against one read of the visible pages, so at
// T >= 64 rows per kv head the fp32 FLOPs (67 TFLOP/s) are the bound; at
// decode widths (T = 1, n_rep rows) it is the page bytes (3.35 TB/s).
//
// Design: one thread block per (sequence, kv head, tile of 16 grouped query
// rows). The block loads its query tile once, then walks the keys in tiles
// of 16 positions, each position resolved through the block table, so the
// walk is independent of the page size and stops at the tile's last visible
// key (pages past it cost neither loads nor FLOPs). K and V tiles are staged
// in shared memory with a padded row stride (d + 4 floats) so that the
// float4 reads of eight different key rows fall in distinct banks. Each row
// keeps an fp32 online softmax (m, l, acc) in registers across the walk;
// keys that are masked contribute p = 0 exactly, so a row that sees no key
// ends with l = 0 and acc = 0 and writes exact zeros. The scores are plain
// CUDA-core FMAs: wgmma tiles, cp.async double buffering and a split of the
// page walk across blocks are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 16 rows x 8 threads per row
constexpr int kRows = 16;       // grouped query rows per block
constexpr int kKeys = 16;       // key positions per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// MAXD bounds the head dim this instantiation holds in registers: each
// thread owns MAXD / 32 float4 chunks of its row's accumulator.
template <int MAXD>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
              const float* __restrict__ v_pool,
              const int32_t* __restrict__ table,
              const int32_t* __restrict__ start_pos,
              const int32_t* __restrict__ q_len, float* __restrict__ out,
              int T, int n_q, int n_kv, int d, int page_size,
              int pages_per_seq, float scale) {
  constexpr int kChunks = MAXD / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = d + 4;           // padded row stride, in floats
  float* qs = smem;                   // [kRows][stride]
  float* ks = qs + kRows * stride;    // [kKeys][stride]
  float* vs = ks + kKeys * stride;    // [kKeys][stride]

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_rep = n_q / n_kv;
  const int G = n_rep * T;
  const int d4 = d / 4;
  const int tid = threadIdx.x;
  const int r = tid >> 3;             // row of the tile this thread serves
  const int j = tid & 7;              // its lane within the row's group
  const int lane = tid & 31;
  const int group_base = lane & ~7;

  const int start = start_pos[b];
  const int qlen = q_len[b];

  // the tile's last live row decides how far the key walk goes
  int max_t = -1;
  for (int i = 0; i < kRows; ++i) {
    const int rr = row0 + i;
    if (rr < G) {
      const int tt = rr % T;
      if (tt < qlen && tt > max_t) max_t = tt;
    }
  }
  int n_keys = 0;
  if (max_t >= 0) {
    n_keys = min(start + max_t + 1, pages_per_seq * page_size);
  }

  const int row = row0 + r;
  const int t = row % T;
  const bool row_live = row < G && t < qlen;
  const int q_head = kvh * n_rep + row / T;

  // query tile -> shared memory (rows past G are zero)
  for (int idx = tid; idx < kRows * d4; idx += kThreads) {
    const int rr = idx / d4, c = idx % d4;
    const int grow = row0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grow < G && n_keys > 0) {
      const int tt = grow % T, qh = kvh * n_rep + grow / T;
      val = reinterpret_cast<const float4*>(
          q + ((int64_t)(b * T + tt) * n_q + qh) * d)[c];
    }
    reinterpret_cast<float4*>(qs + rr * stride)[c] = val;
  }

  float m = kNegInf, l = 0.f;
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int32_t* trow = table + (int64_t)b * pages_per_seq;
  const int last_visible = start + t;   // for this thread's row

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();   // the previous tile is consumed (and qs written)
    for (int idx = tid; idx < kKeys * d4; idx += kThreads) {
      const int kk = idx / d4, c = idx % d4;
      const int kpos = k0 + kk;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kpos < n_keys) {
        const int page = trow[kpos / page_size];
        const int64_t base =
            ((int64_t)page * page_size + kpos % page_size) * n_kv + kvh;
        kv = reinterpret_cast<const float4*>(k_pool + base * d)[c];
        vv = reinterpret_cast<const float4*>(v_pool + base * d)[c];
      }
      reinterpret_cast<float4*>(ks + kk * stride)[c] = kv;
      reinterpret_cast<float4*>(vs + kk * stride)[c] = vv;
    }
    __syncthreads();

    // scores of this thread's row against keys j and j + 8
    const float4* q4 = reinterpret_cast<const float4*>(qs + r * stride);
    const float4* ka = reinterpret_cast<const float4*>(ks + j * stride);
    const float4* kb = reinterpret_cast<const float4*>(ks + (j + 8) * stride);
    float s0 = 0.f, s1 = 0.f;
    for (int c = 0; c < d4; ++c) {
      const float4 qv = q4[c];
      s0 += dot4(qv, ka[c]);
      s1 += dot4(qv, kb[c]);
    }
    const int p0pos = k0 + j, p1pos = k0 + j + 8;
    const bool vis0 = row_live && p0pos < n_keys && p0pos <= last_visible;
    const bool vis1 = row_live && p1pos < n_keys && p1pos <= last_visible;
    s0 = vis0 ? s0 * scale : kNegInf;
    s1 = vis1 ? s1 * scale : kNegInf;

    float mx = fmaxf(s0, s1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    // masked keys give exactly 0: a row with no visible key yet keeps
    // l = 0 even though m_new is still kNegInf
    const float p0 = vis0 ? expf(s0 - m_new) : 0.f;
    const float p1 = vis1 ? expf(s1 - m_new) : 0.f;
    const float corr = expf(m - m_new);
    float ps = p0 + p1;
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    ps += __shfl_xor_sync(0xffffffffu, ps, 4);
    l = l * corr + ps;
    m = m_new;

#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
    }
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      const float pk = __shfl_sync(0xffffffffu, kk < 8 ? p0 : p1,
                                   group_base + (kk & 7));
      const float4* v4 = reinterpret_cast<const float4*>(vs + kk * stride);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = j + 8 * i;
        if (c < d4) {
          const float4 vv = v4[c];
          acc[i].x += pk * vv.x; acc[i].y += pk * vv.y;
          acc[i].z += pk * vv.z; acc[i].w += pk * vv.w;
        }
      }
    }
  }

  if (row < G) {
    const float den = fmaxf(l, 1e-30f);
    float4* o4 = reinterpret_cast<float4*>(
        out + ((int64_t)(b * T + t) * n_q + q_head) * d);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = j + 8 * i;
      if (c < d4) {
        o4[c] = make_float4(acc[i].x / den, acc[i].y / den,
                            acc[i].z / den, acc[i].w / den);
      }
    }
  }
}

template <int MAXD>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int32_t* table, const int32_t* start_pos,
                   const int32_t* q_len, float* out, int B, int T, int n_q,
                   int n_kv, int d, int page_size, int pages_per_seq,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kRows + 2 * kKeys) * (d + 4);
  if (smem > 48 * 1024) {
    // only d = 256 (49,920 B) needs more than the default 48 KiB; the
    // attribute is per device, so it is set on the current one each time
    cudaError_t err = cudaFuncSetAttribute(
        ragged_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int G = (n_q / n_kv) * T;
  dim3 grid((G + kRows - 1) / kRows, n_kv, B);
  ragged_kernel<MAXD><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, table, start_pos, q_len, out, T, n_q, n_kv, d,
      page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ragged_paged_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start_pos, const void* q_len, void* out, int B, int T,
    int n_q, int n_kv, int d, int page_size, int pages_per_seq, float scale,
    void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 256 || n_kv <= 0 || n_q % n_kv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0) return (int)cudaSuccess;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int32_t* tb = static_cast<const int32_t*>(table);
  const int32_t* sp = static_cast<const int32_t*>(start_pos);
  const int32_t* ql = static_cast<const int32_t*>(q_len);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 128) {
    return (int)launch<128>(qf, kf, vf, tb, sp, ql, of, B, T, n_q, n_kv, d,
                            page_size, pages_per_seq, scale, st);
  }
  return (int)launch<256>(qf, kf, vf, tb, sp, ql, of, B, T, n_q, n_kv, d,
                          page_size, pages_per_seq, scale, st);
}
