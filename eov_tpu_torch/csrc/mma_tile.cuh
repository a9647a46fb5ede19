// Tensor-core building blocks for Hopper (sm_90a) kernels of the port:
// asynchronous global -> shared copies (cp.async), ldmatrix fragment loads
// and the bf16 wgmma.mma_async products (A from registers, B from shared
// memory through a descriptor) with f32 sums, and the XOR swizzle of the
// activation tiles A is read from. Kernels 4 (basic_stack.cu) and 2 and 5
// (bottleneck_stack.cu, over bottleneck_mma.cuh) and 8 and 9
// (bottleneck_train.cu) are built on them; they carry no kernel-specific
// layout.
//
// Fragment layouts (PTX ISA, "wgmma .m64nNk16", register A): warp w of the
// warpgroup holds rows 16w..16w+15 of the 64-row A tile, lane l rows
// 16w + l/4 and + 8 at k = 2(l%4) + {0, 1} and the same + 8; ldmatrix.x4
// gives exactly that fragment of a 16x16 tile whose rows are 16-byte lines
// in shared memory when lane l points at row l%16, k-half l/16. The f32
// accumulator d[4j + {0, 1}] is row 16w + l/4, columns 8j + 2(l%4) +
// {0, 1}; d[4j + {2, 3}] the row 8 below.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t dst, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The transposed load: lane l points at row l%8 of matrix l/8, a 16-byte
// line of 8 values; thread t receives column t/4, rows 2(t%4) + {0, 1} of
// each matrix. On [k][m] data (pixels x channels) it gives the register A
// fragment of the [m][k] tile (the weight gradients' A = activation^T):
// matrices 0..3 = (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
// (m 8-15, k 8-15).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// wgmma, one warpgroup (4 warps): fence before products that read
// registers written since, commit the issued products as a group, wait
// until at most 0 or 1 groups are in flight.
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) before later async-proxy reads of it (wgmma's B operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major wgmma operand in 128-byte swizzle atoms: rows of
// 64 bf16 k, 128 B apart, the 16-byte line l of row r stored at l ^ (r % 8);
// 8-row groups 1024 B apart; atoms 1024-byte aligned. A k16 step inside
// the atom advances the address by 32 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major wgmma B operand of 64 bf16 columns in one
// 128-byte swizzle atom: row k (64 n values) 128 B after row k - 1, the
// 16-byte line l of row k stored at l ^ (k % 8), 8-row groups 1024 B apart
// (the stride field; the leading field, the step between 64-column atoms,
// is never taken at N = 64 and is given the same value); 1024-byte
// aligned. A k16 step advances the address by 2048 B.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[0..31] += A (64x16, registers) * B (16x64, shared, MN-major, the
// transpose bit set, descriptor sw128_desc_mn): wgmma m64n64k16, f32 sums;
// with acc = 0, d = A B (d's old values are not read).
__device__ __forceinline__ void wgmma_m64n64_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// d[0..31] += A (64x16, registers) * B (16x64, shared, K-major,
// 128-byte swizzle, descriptor desc): wgmma m64n64k16, f32 sums; with
// acc = 0, d = A B (d's old values are not read).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// d[0..63] += A (64x16, registers) * B (16x128, shared, K-major,
// 128-byte swizzle, descriptor desc): wgmma m64n128k16, f32 sums; acc as
// wgmma_m64n64.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// One m64 tile of kNW (64 or 128) channels: wgmma_m64n64 / _m64n128.
template <int kNW>
__device__ __forceinline__ void wgmma_tile(float (&d)[kNW / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc = 1);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int acc) {
  wgmma_m64n64(d, a, desc, acc);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int acc) {
  wgmma_m64n128(d, a, desc, acc);
}

// Offset in elements of channel n of pixel pix in a swizzled buffer of
// pitch cp: the 16-byte line (n/8)%8 is XORed with pix%8.
__device__ __forceinline__ int swz(int pix, int cp, int n) {
  return pix * cp + (n & ~63) + ((((n >> 3) & 7) ^ (pix & 7)) << 3) + (n & 7);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

}  // namespace
