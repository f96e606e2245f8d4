// Paged single-token decode attention (fp32 pools, MHA) for Hopper, sm_90a.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py ::
//   paged_decode_attention (kernel body _paged_decode_kernel).
//
// One decode query per sequence and head: q [b, h, d]; pools
// [N, page_size, h, d]; block_table [b, P]; pos [b] (int32). Keys at
// positions <= pos[b] are visible (the token at pos was written before the
// call), pages past pos are never read. Returns [b, h, d].
//
// What bounds it on the H100: the bytes. Each visible key costs 2 * d * 4
// bytes of K and V against 4 * d FLOPs, about half an operation per byte,
// so the page reads at 3.35 TB/s set the floor.
//
// Design: one thread block of four warps per (sequence, head). The block
// walks positions 0..pos in tiles of 16, each resolved through the block
// table (any page size), and all 128 threads stage the tile's K and V rows
// into shared memory with 16-byte loads so that many loads are in flight at
// once. Each warp scores four keys (lanes split d, a shuffle reduction sums
// them), one thread per key turns the scores into probabilities against the
// running max, and the threads that own a float4 of the output dim fold the
// V rows into an fp32 accumulator. The (m, l) of the online softmax live in
// every thread, so no extra reduction is needed. Splitting long page walks
// across blocks (flash-decoding) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 16;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ pos, float* __restrict__ out,
                    int h, int d, int page_size, int pages_per_seq,
                    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = d + 4;
  float* ks = smem;                   // [kKeys][stride]
  float* vs = ks + kKeys * stride;    // [kKeys][stride]
  float* sc = vs + kKeys * stride;    // [kKeys] scores
  float* pr = sc + kKeys;             // [kKeys] probabilities

  const int b = blockIdx.y;
  const int head = blockIdx.x;
  const int d4 = d / 4;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const int n_keys = min(pos[b] + 1, pages_per_seq * page_size);
  const float4* q4 =
      reinterpret_cast<const float4*>(q + ((int64_t)b * h + head) * d);
  float4 qa = make_float4(0.f, 0.f, 0.f, 0.f), qb = qa;
  if (lane < d4) qa = q4[lane];
  if (lane + 32 < d4) qb = q4[lane + 32];

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int32_t* trow = table + (int64_t)b * pages_per_seq;

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();
    for (int idx = tid; idx < kKeys * d4; idx += kThreads) {
      const int kk = idx / d4, c = idx % d4;
      const int kpos = k0 + kk;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kpos < n_keys) {
        const int page = trow[kpos / page_size];
        const int64_t base =
            ((int64_t)page * page_size + kpos % page_size) * h + head;
        kv = reinterpret_cast<const float4*>(k_pool + base * d)[c];
        vv = reinterpret_cast<const float4*>(v_pool + base * d)[c];
      }
      reinterpret_cast<float4*>(ks + kk * stride)[c] = kv;
      reinterpret_cast<float4*>(vs + kk * stride)[c] = vv;
    }
    __syncthreads();

    for (int kk = warp; kk < kKeys; kk += kWarps) {
      const float4* k4 = reinterpret_cast<const float4*>(ks + kk * stride);
      float s = 0.f;
      if (lane < d4) {
        const float4 kv = k4[lane];
        s += qa.x * kv.x + qa.y * kv.y + qa.z * kv.z + qa.w * kv.w;
      }
      if (lane + 32 < d4) {
        const float4 kv = k4[lane + 32];
        s += qb.x * kv.x + qb.y * kv.y + qb.z * kv.z + qb.w * kv.w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) sc[kk] = (k0 + kk < n_keys) ? s * scale : kNegInf;
    }
    __syncthreads();

    float mx = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) mx = fmaxf(mx, sc[kk]);
    const float m_new = fmaxf(m, mx);
    if (tid < kKeys) {
      const float s = sc[tid];
      pr[tid] = s <= kNegInf * 0.5f ? 0.f : expf(s - m_new);
    }
    __syncthreads();

    const float corr = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) ps += pr[kk];
    l = l * corr + ps;
    m = m_new;
    if (tid < d4) {
      acc.x *= corr; acc.y *= corr; acc.z *= corr; acc.w *= corr;
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        const float pk = pr[kk];
        const float4 vv = reinterpret_cast<const float4*>(vs + kk * stride)[tid];
        acc.x += pk * vv.x; acc.y += pk * vv.y;
        acc.z += pk * vv.z; acc.w += pk * vv.w;
      }
    }
  }

  if (tid < d4) {
    const float den = fmaxf(l, 1e-30f);
    reinterpret_cast<float4*>(out + ((int64_t)b * h + head) * d)[tid] =
        make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
  }
}

}  // namespace

extern "C" int paged_decode_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, int b, int h, int d, int page_size,
    int pages_per_seq, float scale, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  // at most 33,408 B at d = 256: inside the default 48 KiB of dynamic smem
  const size_t smem = sizeof(float) * (2 * kKeys * (d + 4) + 2 * kKeys);
  dim3 grid(h, b);
  paged_decode_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<float*>(out), h, d,
      page_size, pages_per_seq, scale);
  return (int)cudaGetLastError();
}
