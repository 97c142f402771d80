// Building blocks of the mma.sync kernels (sm_90a): tile geometry,
// cp.async copies, mma.sync m16n8k16 bf16 products with f32 accumulators,
// ldmatrix and fragment packing. Header-only, included by
// flash_attn_bwd.cu, window_attn_fwd.cu and attn_sweep_fwd.cu, and by
// flash_attn_fwd.cu for its D = 32 bf16 instances and the f32 instance
// (its bf16 D = 64 instances, and relpos_flash_fwd.cu, are built from
// sm90_common.cuh; they take pack_bf16, kLog2e, kLn2, Strides and the
// cp.async groups from here). The
// tile helpers are templates over the head dim D (a multiple of 16), which
// every caller names: 32 and 64 for the ViT attention, 32 for the window
// kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

constexpr int kBlock = 64;                  // rows per q tile and per k/v tile
constexpr int kWarps = kBlock / 16;         // each warp owns 16 rows of a tile
constexpr int kThreads = kWarps * 32;

// A 64-row smem tile of head dim D: rows padded by 8 elements (144 bytes at
// D = 64, 176 at D = 80), which keeps the fragment loads conflict-free.
template <int D>
struct Tile {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kStride = D + 8;
  static constexpr int kElems = kBlock * kStride;
  static constexpr int kChunks = D / 8;     // 16-byte chunks a row
};
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, n, h;                        // in elements
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a * b for one m16n8k16 tile: a is 16x16 (row), b is 16x8 (col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head (row stride `row_stride`) into a
// padded smem tile; rows at or past n arrive as zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int n, int tid) {
  constexpr int kChunks = Tile<D>::kChunks;
  constexpr int kIters = kBlock * kChunks / kThreads;
  static_assert(kBlock * kChunks % kThreads == 0, "tile loads must divide");
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < n;
    const __nv_bfloat16* src =
        base + (valid ? static_cast<long long>(row) * row_stride + c : 0);
    cp_async_16(smem + r * Tile<D>::kStride + c, src, valid);
  }
}

// A fragments (m16 x k16, row major) of the 16 rows of a 64 x D smem tile
// that warp `warp` owns, over the whole head dim: frag[kk] covers columns
// [16 kk, 16 kk + 16).
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&frag)[D / 16][4],
                                             const __nv_bfloat16* tile,
                                             int warp, int g, int t) {
  constexpr int kS = Tile<D>::kStride;
  const __nv_bfloat16* w = tile + warp * 16 * kS;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = w + kk * 16 + 2 * t;
    frag[kk][0] = ld_u32(p + g * kS);
    frag[kk][1] = ld_u32(p + (g + 8) * kS);
    frag[kk][2] = ld_u32(p + g * kS + 8);
    frag[kk][3] = ld_u32(p + (g + 8) * kS + 8);
  }
}

// acc[j] (16 x 8, j over the tile's 8 column groups) += A * tile^T, where A
// is this warp's 16 x D operand and `tile` holds 64 rows of D: the product
// of A with every row of the tile (the "rows as n, head dim as k" pattern of
// S = Q K^T).
template <int D>
__device__ __forceinline__ void mma_a_rowsT(float (&acc)[kBlock / 8][4],
                                            const uint32_t (&a)[D / 16][4],
                                            const __nv_bfloat16* tile, int g,
                                            int t) {
  constexpr int kS = Tile<D>::kStride;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      const __nv_bfloat16* r = tile + (j * 8 + g) * kS + kk * 16 + 2 * t;
      mma_bf16(acc[j], a[kk], ld_u32(r), ld_u32(r + 8));
    }
  }
}

// acc[dn] (16 x 8, dn over the head dim's D / 8 column groups) += P * tile,
// where P is this warp's 16 x 64 operand already packed as bf16 A fragments
// over the tile's 64 rows (the "rows as k" pattern of O = P V).
// ldmatrix.trans yields the B fragments of two 8-wide column groups per
// 16-row step.
template <int D>
__device__ __forceinline__ void mma_p_rows(float (&acc)[D / 8][4],
                                           const uint32_t (&p)[kBlock / 16][4],
                                           const __nv_bfloat16* tile,
                                           int lane) {
  constexpr int kS = Tile<D>::kStride;
  const int mat = lane >> 3;
  const int mrow = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, tile + (kk * 16 + (mat & 1) * 8 + mrow) * kS + dp * 16 +
                 (mat >> 1) * 8);
      mma_bf16(acc[2 * dp], p[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], p[kk], b[2], b[3]);
    }
  }
}

// Pack a 16 x 64 f32 accumulator tile (the C layout of 8 m16n8 products)
// into bf16 A fragments over its 64 columns.
__device__ __forceinline__ void pack_a_frags(uint32_t (&frag)[kBlock / 16][4],
                                             const float (&acc)[kBlock / 8][4]) {
#pragma unroll
  for (int j = 0; j < kBlock / 8; ++j) {
    frag[j / 2][(j % 2) * 2 + 0] = pack_bf16(acc[j][0], acc[j][1]);  // row g
    frag[j / 2][(j % 2) * 2 + 1] = pack_bf16(acc[j][2], acc[j][3]);  // row g+8
  }
}

// Store this warp's 16 x D f32 accumulator tile, rows times scale0 and
// scale1, as bf16 rows row0 + g and row0 + g + 8 of `base` (row stride
// `row_stride`), skipping rows at or past n.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride,
                                           const float (&acc)[D / 8][4],
                                           int row0, int n, int g, int t,
                                           float scale0, float scale1) {
  const int r0 = row0 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(base + r0 * row_stride + col) =
          pack_bf16(acc[dn][0] * scale0, acc[dn][1] * scale0);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(base + r1 * row_stride + col) =
          pack_bf16(acc[dn][2] * scale1, acc[dn][3] * scale1);
    }
  }
}

}  // namespace flash
