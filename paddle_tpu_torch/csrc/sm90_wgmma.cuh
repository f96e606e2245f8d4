// Hopper (sm_90a) pieces for the bf16 and fp16 flash kernels on wgmma
// (flash_attention_wgmma.cu), in raw PTX: no CUTLASS or CuTe header, so
// the kernels build in seconds. The products and the tensor map take the
// 16-bit element type as a template argument (bf16_mma.cuh's kBf16, the
// default, or kF16).
//
// - TMA: a 4-D tensor map over a 16-bit [B, S, H, d] tensor (innermost d,
//   then heads, rows and batches; row stride H d), a box of 64 columns x
//   1 head x R rows x 1 batch written to shared memory with the 128-byte
//   swizzle: R rows of 128 bytes, the 16-byte chunk c of row r at chunk
//   c ^ (r % 8). Coordinates past d, past S or past B are zero-filled, so
//   a tile's ragged edges (d = 40 or 96, the last rows of a sequence) read
//   zeros. The map is encoded on the host with cuTensorMapEncodeTiled,
//   fetched through the runtime's driver entry point, so the library
//   needs no -lcuda, and passed to the kernel as a __grid_constant__.
// - mbarriers: a TMA load completes its bytes on a barrier in shared
//   memory (expect_tx, complete_tx); waiters poll try_wait on its phase
//   parity.
// - wgmma: a warpgroup (4 warps, 128 threads) multiplies a 64-row tile.
//   Operands in shared memory are read through a 64-bit descriptor:
//   start address >> 4 (bits 0-13), the leading byte offset >> 4 (16-29),
//   the stride byte offset >> 4 (32-45) and the layout (62-63: 1 = the
//   128-byte swizzle). K-major operands (Q, K, V, dO contracted over d):
//   rows of 64 bf16 of the swizzled box, eight rows 1024 bytes apart (the
//   stride offset); a k-step of 16 columns moves the start by 32 bytes
//   inside the swizzled row. MN-major operands (V for P V, dO and Q for
//   P^T dO and dS^T Q, contracted over their rows): the box as it is, the
//   leading offset from one 64-column box to the next along d, the stride
//   offset 1024 bytes per 8 rows; a k-step of 16 rows moves the start by
//   2048 bytes. A register A operand is the mma.sync A fragment of each
//   warp's 16 rows, and the fp32 accumulator holds, per warp, rows g and
//   g + 8 at columns 8 i + 2 t, + 1 (d[i][0..3]), the mma.sync C layout:
//   a pair of accumulator tiles is an A fragment as it is.
// - Register ordering: wgmma runs asynchronously, so the accumulators and
//   register operands are pinned (reg_fence) around wgmma.fence and after
//   wgmma.wait_group, where the compiler could otherwise move plain reads
//   and writes of them across the asynchronous window.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"   // kBf16, kF16

namespace {

// ------------------------------------------------------------- barriers

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Arrive and expect `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` has completed. (No trap on a bound
// of polls here: a trap's exit path makes ptxas hold every region of a
// kernel at its launch register count and ignore setmaxnreg.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

// One box of a 4-D tensor map into shared memory at dst, its bytes
// completed on bar; (c0, c1, c2, c3) = (column, head, row, batch).
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// The descriptor of an operand at shared address `addr` in the 128-byte
// swizzle, with its leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers at this point of the instruction stream.
template <int NT>
__device__ __forceinline__ void reg_fence(float (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[i][r]) :: "memory");
  }
}

template <int NK>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int i = 0; i < NK; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r]) :: "memory");
  }
}

// Move registers between the warpgroups of a warp-specialised block (every
// warp of a warpgroup executes it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// m64nNk16, bf16 x bf16 (or fp16 x fp16 at H = kF16) -> fp32: with
// scale_d 0 the product overwrites d (the first k-step of a chain), else
// it is added to d in the tensor cores. Shared-memory operands at N = 32
// and 64 (the score tiles), register A at N = 64 and 128 (the head dims).
// Each asm statement is written once, as a macro of the type's PTX name.

// d (64 x 32) += A B, A and B in shared memory, both K-major.
#define WGMMA_SS_N32(TY)                                                      \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),           \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])            \
      : "l"(a), "l"(b), "r"(scale_d))
template <int H = kBf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (H == kF16) {
    WGMMA_SS_N32("f16");
  } else {
    WGMMA_SS_N32("bf16");
  }
}
#undef WGMMA_SS_N32

// d (64 x 64) += A B, A and B in shared memory, both K-major.
#define WGMMA_SS_N64(TY)                                                      \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),           \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])            \
      : "l"(a), "l"(b), "r"(scale_d))
template <int H = kBf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (H == kF16) {
    WGMMA_SS_N64("f16");
  } else {
    WGMMA_SS_N64("bf16");
  }
}
#undef WGMMA_SS_N64

// d (64 x 64) += A B, A in registers (an mma A fragment per warp), B in
// shared memory, MN-major.
#define WGMMA_RS_N64(TY)                                                      \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "  \
      "p, 1, 1, 1;\n}\n"                                                      \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),           \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))
template <int H = kBf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (H == kF16) {
    WGMMA_RS_N64("f16");
  } else {
    WGMMA_RS_N64("bf16");
  }
}
#undef WGMMA_RS_N64

// d (64 x 128) += A B, A in registers (an mma A fragment per warp), B in
// shared memory, MN-major.
#define WGMMA_RS_N128(TY)                                                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "  \
      "p, 1, 1, 1;\n}\n"                                                      \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),           \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),           \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),           \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),           \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),       \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),       \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),       \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),       \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),       \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))
template <int H = kBf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (H == kF16) {
    WGMMA_RS_N128("f16");
  } else {
    WGMMA_RS_N128("bf16");
  }
}
#undef WGMMA_RS_N128

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime.
cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a 16-bit [B, S, H, d] tensor (bf16, or fp16 at ET =
// kF16) read in boxes of 64 columns x `rows` rows of one head, with the
// 128-byte swizzle (d % 8 == 0, base 16-byte aligned: the wrapper checks
// both).
template <int ET>
cudaError_t encode_bshd16(CUtensorMap* map, const void* base, int B, int S,
                          int H, int d, int rows) {
  EncodeTiledFn fn;
  cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t row = 2 * (cuuint64_t)d * H;
  const cuuint64_t strides[3] = {2 * (cuuint64_t)d, row, row * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = ET == kF16
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult res = fn(map, type, 4,
                          const_cast<void*>(base), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
