// What the ragged kernel's two sources share (ragged_paged_attention.cu
// with the entry points, the fp32-q forms and the 16-bit-q forms for d >
// 128; ragged_paged_attention_bf16.cu with the bf16-q and fp16-q forms for
// d <= 128): the operands of one launch (Ragged), the pool storage types,
// the keys a block's rows see, the 1-byte pools' codes as fp32, and the
// launchers the entry points call in the 16-bit source.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem_io.cuh"
#include "tf32_mma.cuh"

namespace ragged {

// The operands and sizes of one launch.
struct Ragged {
  const void* q;      // fp32, bf16 or fp16 (the kernels' QT)
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;   // [N, n_kv], int8 pools only
  const float* v_scale;
  const int32_t* table;
  const int32_t* start_pos;
  const int32_t* q_len;
  void* out;          // in q's type
  int T, n_q, n_kv, d, page_size, pages_per_seq;
  float scale;
  int cpy;   // bytes of one cp.async of a pool row: 16, 8 or 4
};

// The split walk's workspace (the 16-bit-q decode form): each split's fp32
// (acc [d], m, l) for each of its G rows, [B, n_kv, n_splits, G, d + 2]
// floats, written before it is read (null where n_splits is 1), and one
// int32 ticket per (sequence, kv head), 0 between launches.
struct Split {
  float* part;
  int32_t* tickets;
  int keys_per_split, n_splits;
};

// The 16-bit-q launchers (ragged_paged_attention_bf16.cu), for q of type
// QT (__nv_bfloat16 or __half); kv is the pool storage type: kBF16 or
// kFP16 (q's own type), kI8 or kF8 (below).
template <typename QT>
cudaError_t launch_span16(const Ragged& a, int kv, int B,
                          cudaStream_t stream);
template <typename QT>
cudaError_t launch_decode_split(const Ragged& a, const Split& sp, int kv,
                                int B, cudaStream_t stream);

}  // namespace ragged

namespace {

using ragged::Ragged;

// storage type of the K/V pools (a template argument); kFP16 is the fp16
// pool (bf16_mma.cuh's kF16 is the products' element type)
constexpr int kF32 = 0, kI8 = 1, kF8 = 2, kBF16 = 3, kFP16 = 4;
// G = n_rep * T at or below this takes the decode form (the wrapper's
// ragged_form mirrors it)
constexpr int kDecodeRows = 8;

template <int KV>
struct Elem {
  static constexpr int bytes =
      KV == kF32 ? 4 : KV == kBF16 || KV == kFP16 ? 2 : 1;
};

// A cp.async of n = 16, 8 or 4 bytes (n uniform across the warp).
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           bool valid, int n) {
  if (n == 16) {
    cp_async16(dst, src, valid);
  } else if (n == 8) {
    cp_async8(dst, src, valid);
  } else {
    cp_async4(dst, src, valid);
  }
}

// The keys a block's rows [row0, row0 + n) need: up to the last visible
// key of its last live row (0 without one), and no further than the table
// maps.
__device__ __forceinline__ int rows_key_end(const Ragged& a, int row0, int n,
                                            int G, int start, int qlen) {
  int max_t = -1;
  for (int r = row0; r < min(row0 + n, G); ++r) {
    const int t = r % a.T;
    if (t < qlen && t > max_t) max_t = t;
  }
  if (max_t < 0) return 0;
  return min(start + max_t + 1, a.pages_per_seq * a.page_size);
}

// Four codes of a 1-byte pool (little-endian in w) as fp32: exact, so
// their tf32 split has a zero small half (and they are exact in bf16 and
// in fp16).
// fp8 NaN codes give NaN.
template <int KV>
__device__ __forceinline__ float4 codes4(uint32_t w) {
  if constexpr (KV == kI8) {
    return make_float4(static_cast<float>(static_cast<int8_t>(w)),
                       static_cast<float>(static_cast<int8_t>(w >> 8)),
                       static_cast<float>(static_cast<int8_t>(w >> 16)),
                       static_cast<float>(static_cast<int8_t>(w >> 24)));
  } else {
    const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3));
    const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3));
    const float2 a = __half22float2(lo), b = __half22float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// Elements c .. c + 3 (c a multiple of 4) of a staged or pooled row of
// storage type KV as fp32: fp32 as they are, bf16 and fp16 widened,
// 1-byte codes as codes4 gives them (an int8 code still wants its page
// scale).
template <int KV>
__device__ __forceinline__ float4 load4(const uint8_t* row, int c) {
  if constexpr (KV == kF32) {
    return ld4(reinterpret_cast<const float*>(row) + c);
  } else if constexpr (KV == kBF16) {
    return ld4(reinterpret_cast<const __nv_bfloat16*>(row) + c);
  } else if constexpr (KV == kFP16) {
    return ld4(reinterpret_cast<const __half*>(row) + c);
  } else {
    return codes4<KV>(*reinterpret_cast<const uint32_t*>(row + c));
  }
}

// Row stride (bytes) of a staged tile of 1-byte codes or 16-bit values: d
// rounded to 16 elements, plus 16 bytes.
template <int KV>
__host__ __device__ __forceinline__ int code_ld(int d) {
  return Elem<KV>::bytes * ((d + 15) & ~15) + 16;
}

// A barrier of one key group's threads (named barrier 1 + kg), or of the
// block where there is one group.
template <int KG, int GTHR>
__device__ __forceinline__ void group_sync(int kg) {
  if constexpr (KG == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kg), "r"(GTHR));
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  // the attribute is per device, so it is set on the current one each time
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
