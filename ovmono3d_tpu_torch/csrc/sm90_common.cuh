// Hopper (sm_90a) building blocks as inline PTX: mbarriers, TMA tensor
// loads and 1-D bulk copies, cp.async copies that arrive on an mbarrier,
// wgmma shared-memory descriptors (128- and 32-byte swizzles) and
// warpgroup products (bf16 -> f32, s8 -> s32), proxy fences and named
// barriers, and register reallocation between warpgroups; and on the host,
// the tensor maps of [B, N, H, cols] bf16 views and of 2-D matrices.
// Header-only, included by flash_attn_fwd.cu, flash_attn_bwd.cu,
// attn_sweep_fwd.cu, relpos_flash_fwd.cu, window_attn_fwd.cu and
// int8_gemm.cu. CUtensorMap and its enums come
// from <cuda.h> as types only: the maps are encoded through the runtime's
// driver entry point, so nothing links against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <utility>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// counts as having completed the phase of parity 1, so a producer's first
// wait on an empty barrier, at parity 1, passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA ----

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Copy the box of `map` at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at `dst`; completes `bytes` of `bar`'s transactions.
// Coordinates past the tensor's extent read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The 2-D box of `map` at (c0, c1), innermost first, into `dst`; as
// tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Copy the 2-D box at `src` in shared memory into the tensor of `map` at
// (c0, c1), innermost first; coordinates past the tensor's extent are not
// written. Completes in the bulk group that bulk_commit closes.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Copy the box at `src` in shared memory into the tensor of `map` at
// (c0, c1, c2, c3), innermost first; as tma_store_2d.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Wait until at most N of this thread's bulk groups are still in flight
// (their writes done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read their
// shared-memory sources.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Copy `bytes` (a multiple of 16) from global `src` into shared `dst`, both
// 16-byte aligned; completes `bytes` of `bar`'s transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- cp.async with an mbarrier ----

// Copy 16 bytes (both addresses 16-byte aligned) or 4 bytes from global
// `src` to shared `dst` asynchronously (no registers held for the data).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued so far
// has landed (the arrival counts in the barrier's expected count).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until every cp.async this thread has issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Which of a tensor map's dims 1..3 hold the head, token and batch
// coordinates (dim 0 is D); encode_view_d64 fills it.
struct MapDims {
  int h, n, b;
};

// The box of `map` at (head, token row, batch), from column `col`, into
// `dst`.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         const MapDims& md, uint64_t* bar,
                                         int head, int row, int batch,
                                         int col = 0) {
  const int c1 = md.h == 1 ? head : md.n == 1 ? row : batch;
  const int c2 = md.h == 2 ? head : md.n == 2 ? row : batch;
  const int c3 = md.h == 3 ? head : md.n == 3 ? row : batch;
  tma_load_4d(dst, map, bar, col, c1, c2, c3);
}

// The box at `src` into the tensor of `map` at (head, token row, batch),
// from column `col`; as load_box.
__device__ __forceinline__ void store_box(const CUtensorMap* map,
                                          const MapDims& md, const void* src,
                                          int head, int row, int batch,
                                          int col = 0) {
  const int c1 = md.h == 1 ? head : md.n == 1 ? row : batch;
  const int c2 = md.h == 2 ? head : md.n == 2 ? row : batch;
  const int c3 = md.h == 3 ? head : md.n == 3 ? row : batch;
  tma_store_4d(map, src, col, c1, c2, c3);
}

// ---- wgmma ----

// The descriptor of a bf16 tile in shared memory laid out as TMA writes it
// with a 128-byte swizzle: 128-byte rows, 8-row (1024-byte) swizzle atoms,
// the tile 1024-byte aligned. `lbo` and `sbo` are the leading and stride
// byte offsets (for a K-major operand sbo is the stride between 8-row
// groups and lbo is unused; for an MN-major one sbo is the stride between
// 8-row groups along K and lbo the stride between 64-element column
// blocks). Adding (bytes >> 4) to the descriptor moves its start.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);                      // layout type 1: 128-byte swizzle
}

// The descriptor of a bf16 tile laid out as TMA writes it with the 32-byte
// swizzle: 32-byte rows (16 elements), 8-row (256-byte) swizzle atoms, the
// tile 256-byte aligned. K-major: sbo is the stride between 8-row groups
// (256 for a packed tile). MN-major (rows along K): sbo is the stride
// between 8-row groups along K, lbo between 16-element column blocks.
__device__ __forceinline__ uint64_t desc_sw32(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (3ull << 62);                      // layout type 3: 32-byte swizzle
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

// Pins a register in place around the asynchronous products: the compiler
// may not move reads or writes of it across this point. Every operand of a
// batch of products (accumulators, A fragments, descriptors) is pinned
// before its wgmma_fence, so no instruction that defines one falls between
// the fence and the products (ptxas would serialise them).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(uint64_t& r) {
  asm volatile("" : "+l"(r)::"memory");
}

template <typename T, int N>
__device__ __forceinline__ void fence_operands(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    fence_operand(r[i]);
  }
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A B^T: A 64 x 16 and B 128 x 16,
// both bf16 K-major in shared memory. Accumulator layout: thread (warp w,
// lane 4g + t) holds d[4j + e] = (row 16w + g, column 8j + 2t + e) and
// d[4j + 2 + e] = (row 16w + g + 8, the same column), e in {0, 1}.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A B^T: A 64 x 16 and B 64 x 16,
// both bf16 K-major in shared memory (wgmma_m64n128k16_ss over 64 columns;
// the same accumulator layout, j < 8).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A B: A 64 x 16 bf16 from registers
// (a[0..3]: the m16n8k16 A fragment of the warp's 16 rows: (g, 2t), (g + 8,
// 2t), (g, 2t + 8), (g + 8, 2t + 8), pairs packed low column first) and B
// 16 x 64 bf16 in shared memory, MN-major (rows along K, the transposed-B
// form). Accumulator layout as wgmma_m64n128k16_ss's, over 64 columns.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A B^T: A 64 x 16 bf16 from
// registers (wgmma_m64n64k16_rs's fragment) and B 64 x 16 bf16 K-major in
// shared memory (as wgmma_m64n64k16_ss's B).
__device__ __forceinline__ void wgmma_m64n64k16_rs_kmajor(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 80, f32) = (scale_d ? d : 0) + A B: as wgmma_m64n64k16_rs over 80
// columns (j < 10).
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 144, f32) = (scale_d ? d : 0) + A B^T: A 64 x 16 and B 144 x 16,
// both bf16 K-major in shared memory (wgmma_m64n128k16_ss over 144 columns;
// the same accumulator layout, j < 18).
__device__ __forceinline__ void wgmma_m64n144k16_ss(float (&d)[72],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71},"
      " %72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256, s32) = (scale_d ? d : 0) + A B^T: A 64 x 32 and B 256 x 32,
// both s8 K-major in shared memory (8-bit operands must be K-major; a 128-byte
// swizzle row holds 128 k, so a k32 step moves a descriptor 32 bytes, as a
// bf16 k16 step does). The s32 accumulator has the f32 one's layout
// (wgmma_m64n128k16_ss). Products are exact: no saturation is asked for, and
// |d| stays far below 2^31 for K < 2^17.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Orders this thread's earlier shared-memory writes (generic proxy) before
// later reads of the async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the `threads` threads (a multiple of 32) that use named
// barrier `id` (1-15; 0 is __syncthreads's).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- softmax arithmetic ----

// 2^x on the SFU (flush to zero; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- warpgroup register reallocation (all 4 warps of a warpgroup) ----

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: tensor maps ----

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no -lcuda), or
// null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one [B, N, H, cols] bf16 view with batch/token/head
// strides sb, sn, sh (elements): dims (the columns, then H, N and B in
// ascending stride, dims of extent 1 last), a box of `box_cols` x
// `box_rows` tokens and the given swizzle (a row of the box must be the
// swizzle's width: 64 columns for 128 bytes, 16 for 32). Rows past N read
// as zeros. Returns cuTensorMapEncodeTiled's result, 0 on success.
inline int encode_view(CUtensorMap* map, MapDims* md, const void* base,
                       int batch, int n, int heads, long long sb,
                       long long sn, long long sh, int cols, int box_cols,
                       int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    return static_cast<int>(cudaErrorSymbolNotFound);
  }
  struct Dim {
    cuuint64_t size, stride;                // stride in bytes
    int role;                               // 0 head, 1 token, 2 batch
  };
  Dim dims[3] = {{static_cast<cuuint64_t>(heads),
                  static_cast<cuuint64_t>(sh) * 2, 0},
                 {static_cast<cuuint64_t>(n),
                  static_cast<cuuint64_t>(sn) * 2, 1},
                 {static_cast<cuuint64_t>(batch),
                  static_cast<cuuint64_t>(sb) * 2, 2}};
  const auto before = [](const Dim& a, const Dim& b) {
    if ((a.size == 1) != (b.size == 1)) {
      return b.size == 1;
    }
    return a.stride < b.stride;
  };
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && before(dims[j], dims[j - 1]); --j) {
      std::swap(dims[j], dims[j - 1]);
    }
  }
  const auto width = static_cast<cuuint64_t>(cols);
  cuuint64_t gdim[4] = {width, 1, 1, 1};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  int pos[3];
  cuuint64_t span = width * 2;              // bytes the dims so far cover
  for (int i = 0; i < 3; ++i) {
    if (dims[i].size == 1) {
      dims[i].stride = span;                // any stride serves extent 1
    }
    gdim[i + 1] = dims[i].size;
    gstride[i] = dims[i].stride;
    box[i + 1] = dims[i].role == 1 ? static_cast<cuuint32_t>(box_rows) : 1;
    pos[dims[i].role] = i + 1;
    span = std::max(span, dims[i].stride * dims[i].size);
  }
  *md = MapDims{pos[0], pos[1], pos[2]};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim,
      gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The tensor map of one [B, N, H, 64] bf16 view: a box of 64 x `box_rows`
// tokens with the 128-byte swizzle (a 64-element row is one 128-byte
// swizzle line).
inline int encode_view_d64(CUtensorMap* map, MapDims* md, const void* base,
                           int batch, int n, int heads, long long sb,
                           long long sn, long long sh, int box_rows) {
  return encode_view(map, md, base, batch, n, heads, sb, sn, sh, 64, 64,
                     box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The tensor map of a contiguous [rows, cols] matrix of `dtype` (elements
// of `elem_bytes`; a row of cols * elem_bytes bytes, a multiple of 16): a
// box of 128 bytes of a row x `box_rows` rows with the 128-byte swizzle.
// Rows and columns past the extents read as zeros and are not written.
// Returns cuTensorMapEncodeTiled's result, 0 on success.
inline int encode_matrix(CUtensorMap* map, const void* base,
                         CUtensorMapDataType dtype, int elem_bytes, int rows,
                         int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    return static_cast<int>(cudaErrorSymbolNotFound);
  }
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t gstride[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  return static_cast<int>(encode(
      map, dtype, 2, const_cast<void*>(base), gdim, gstride, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The SM count of the current device, or -1.
inline int sm_count() {
  int device = 0;
  int sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return -1;
  }
  return sms;
}

}  // namespace sm90
