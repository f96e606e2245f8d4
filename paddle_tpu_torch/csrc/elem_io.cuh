// Loads and stores of fp32 or bf16 elements four (or two) at a time, for
// the serving kernels that take q, the pools and the output in either
// type (ragged_paged_attention.cu, paged_decode_attention.cu). Every
// value is widened to fp32 where it is read and the sums stay fp32, as
// the Pallas kernels cast each tile to fp32; an output is rounded to
// bf16 (to nearest even) only where it is written. A bf16 value widens
// to fp32 exactly (its bits shifted up by 16), so a bf16 operand is also
// exact in tf32: its split has a zero small half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// four bf16 values (little-endian in w: element 0 in the low half of w.x)
// as fp32, exactly
__device__ __forceinline__ float4 bf16x4(uint2 w) {
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// elements p[0 .. 3] as fp32 (p 16-byte aligned for fp32, 8 for bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return bf16x4(*reinterpret_cast<const uint2*>(p));
}

// the same through the read-only cache (operands that no launch writes)
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// p[0], p[1] = a, b
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// p[0 .. 3] = v
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  st2(p, v.x, v.y);
  st2(p + 2, v.z, v.w);
}

}  // namespace
