// Hopper (sm_90a) building blocks for the flash kernels in
// flash_attention_sm90.cu (head_dim 64, 128 and 512): the 128-byte-swizzled
// shared-memory tile that wgmma reads, its matrix descriptors, the wgmma
// shapes the kernels use, their fences, cp.async into the swizzled layout,
// a named barrier, and the host side of a launch (the shared-memory
// attribute, the alignment check, the attribute query). The fp32 kernels
// of flash_attention_fp32.cu use its cp.async and host helpers.
//
// The kernels take 16-bit inputs, bf16 or fp16 (Elem<T> below: the wgmma
// operand type and the conversions to and from fp32); both are 16 bits an
// element, so the tiles, their swizzle and the descriptors serve either.
//
// A tile holds R rows of D 16-bit elements (D = 64, 128 or 512) as D / 64 column
// halves, each R rows of 128 bytes; 16-byte chunk c of row r sits at chunk
// (c ^ (r % 8)) of its row in its half. That is the SWIZZLE_128B layout of
// the hardware (address bits 4-6 XOR bits 7-9), so every tile starts on a
// 1024-byte boundary. At D = 64 a row is exactly one 128-byte swizzle atom
// and the one half is the whole tile. One tile serves as either operand
// form:
//
// * K-major (the D columns are the reduction dim K): A or B of S = Q K^T
//   and its relatives. Rows are M or N; 8-row groups 1024 bytes apart (the
//   stride byte offset); the leading byte offset is unused. k-step kk of 16
//   starts (kk / 4) halves and (kk % 4) * 32 bytes in (D / 16 k-steps).
// * MN-major (the rows are K, the D columns are N): B of the accumulating
//   products (P V, dS K, P^T dO, dS^T Q), read transposed (imm-trans-b 1,
//   which bf16 and fp16 allow). Each 64-column half is one N atom, R * 128 bytes
//   after the one before (the leading byte offset: two atoms for an n128
//   product, never used by an n64 one); 8-row K groups are 1024 bytes apart
//   (the stride byte offset). k-step kk starts kk * 16 rows in; a product
//   over columns [64 a, ...) starts a halves in.
//
// The accumulator of an m64nNk16 wgmma gives thread t of the warpgroup
// (warp w = t / 32, g = (t % 32) / 4, c4 = t % 4) the elements
// d[4j + 2i + c] = D[16w + g + 8i][8j + 2 c4 + c], and the A fragment of an
// m64nNk16 product from registers has the same per-thread layout over a
// 16-column k-step: so a score tile converts into the A operand of the next
// product in registers (pack_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// The element types of the wgmma kernels' inputs and outputs: whether a
// wgmma reads them as .f16 (else .bf16), and two fp32 values as one 32-bit
// register of two elements (round to nearest even) and back.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr bool F16 = false;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
};

template <>
struct Elem<f16> {
  static constexpr bool F16 = true;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int R, int D>
struct Tile {
  static constexpr int BYTES = R * D * 2;
  static constexpr int HALF = R * 128;
  static constexpr int CHUNKS = D / 8;     // 16-byte chunks of a row
  static_assert(R % 8 == 0, "whole 8-row swizzle atoms");
  static_assert(D % 64 == 0, "whole 64-column halves");
  // byte offset of 16-byte chunk c (0 .. CHUNKS - 1) of row r
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    return (c >> 3) * HALF + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
};

// A shared-memory matrix descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The descriptors of a tile of R rows (at either D: a half is R * 128
// bytes whatever D is).
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}

template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across the wait (or from reusing them before it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define AOZORA_F8(i)                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 fp32) = (accumulate ? d : 0) + A (64 x 16) B (64 x 16)^T, both
// K-major in shared memory: the score products of 64-row streamed tiles.
// TY is the operand type as the instruction spells it ("bf16" or "f16").
#define AOZORA_MMA_SS(TY)                                                          \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                          \
      : AOZORA_F8(0), AOZORA_F8(8), AOZORA_F8(16), AOZORA_F8(24)                   \
      : "l"(a), "l"(b), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (Elem<T>::F16)
    AOZORA_MMA_SS("f16");
  else
    AOZORA_MMA_SS("bf16");
}

// d (64 x 64 fp32) += A (64 x 16, in registers) B (16 x 64), B MN-major in
// shared memory: the accumulating products at head_dim 64.
#define AOZORA_MMA_RS64(TY)                                                        \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
      : AOZORA_F8(0), AOZORA_F8(8), AOZORA_F8(16), AOZORA_F8(24)                   \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint64_t b) {
  if constexpr (Elem<T>::F16)
    AOZORA_MMA_RS64("f16");
  else
    AOZORA_MMA_RS64("bf16");
}

// d (64 x 128 fp32) += A (64 x 16, in registers) B (16 x 128), B MN-major
// in shared memory: the accumulating products at head_dim 128.
#define AOZORA_MMA_RS128(TY)                                                       \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                             \
      : AOZORA_F8(0), AOZORA_F8(8), AOZORA_F8(16), AOZORA_F8(24), AOZORA_F8(32),   \
        AOZORA_F8(40), AOZORA_F8(48), AOZORA_F8(56)                                \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint64_t b) {
  if constexpr (Elem<T>::F16)
    AOZORA_MMA_RS128("f16");
  else
    AOZORA_MMA_RS128("bf16");
}

#undef AOZORA_MMA_SS
#undef AOZORA_MMA_RS64
#undef AOZORA_MMA_RS128
#undef AOZORA_F8

// A 64 x N fp32 score tile (accumulator layout, N / 2 floats a thread) as
// the T A fragments of N / 16 16-column k-steps: a[4 kk .. 4 kk + 3] is
// k-step kk.
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&s)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = Elem<T>::pack(s[2 * i], s[2 * i + 1]);
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// where !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Rows [row0, row0 + R) of one head of a (B, S, H, D) tensor of 16-bit
// elements (row stride rs elements) into a swizzled tile, by THREADS
// threads; rows >= S are zeros.
template <int R, int D, int THREADS, typename T>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const T* head, int row0,
                                                int S, int rs, int tid) {
  constexpr int CH = Tile<R, D>::CHUNKS;
  static_assert((R * CH) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const unsigned c = tid + i * THREADS;
    const int r = c / CH, ch = c % CH;
    const bool ok = row0 + r < S;
    cp_async16(tile + Tile<R, D>::chunk(r, ch),
               head + (size_t)(ok ? row0 + r : 0) * rs + ch * 8, ok);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// cudaFuncGetAttributes and the occupancy of one kernel: out = {registers,
// local (spill) bytes a thread, dynamic shared memory bytes, threads a
// block, blocks a SM}.
template <typename K>
int attributes(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = threads;
  out[4] = blocks;
  return 0;
}

}  // namespace sm90
