// Loads and stores of fp32, bf16 or fp16 elements four (or two) at a
// time, for the serving kernels that take q, the pools and the output in
// any of these types (ragged_paged_attention.cu, paged_decode_attention.cu).
// Every value is widened to fp32 where it is read and the sums stay fp32,
// as the Pallas kernels cast each tile to fp32; an output is rounded to
// bf16 or fp16 (to nearest even) only where it is written. A bf16 value
// widens to fp32 exactly (its bits shifted up by 16); an fp16 value
// widens exactly through the conversion instruction (__half22float2: its
// exponent is rebiased, so it cannot be widened by shifting bits). Both
// are exact in tf32 (fp16's 11 significant bits, its subnormals normal in
// tf32's exponent range): their split has a zero small half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// four fp16 values (element 0 in the low half of w.x) as fp32, exactly
__device__ __forceinline__ float4 f16x4(uint2 w) {
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// elements p[0 .. 3] as fp32 (p 16-byte aligned for fp32, 8 for 16-bit
// types)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return bf16x4(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float4 ld4(const __half* p) {
  return f16x4(*reinterpret_cast<const uint2*>(p));
}

// the same through the read-only cache (operands that no launch writes)
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float4 ldg4(const __half* p) {
  return f16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// p[0], p[1] = a, b
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rounded to nearest even; past 65504 inf, below 2^-14 subnormal
__device__ __forceinline__ void st2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// p[0 .. 3] = v
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  st2(p, v.x, v.y);
  st2(p + 2, v.z, v.w);
}

__device__ __forceinline__ void st4(__half* p, float4 v) {
  st2(p, v.x, v.y);
  st2(p + 2, v.z, v.w);
}

}  // namespace
