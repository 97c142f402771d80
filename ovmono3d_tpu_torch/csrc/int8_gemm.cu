// int8 x int8 -> int32 matrix product for Hopper (sm_90a), with an optional
// dequantizing epilogue: the W8A8 serving path of the ViT trunks.
//
// Replaces the TPU kernel _int8_mm_kernel of tools/probe_int8_pallas.py
// (behind pallas_int8_matmul), the int8 product that int8_matmul
// (ovmono3d_tpu/ops/quant.py) hands to XLA. For xq [R, K] and wq [M, K], both
// int8, contiguous and K-major (wq is nn.Linear's [out, in] layout):
//
//     acc[r, m] = sum_k xq[r, k] * wq[m, k]                      (int32)
//     raw:      out[r, m] = acc[r, m]                            (int32)
//     dequant:  out[r, m] = (float(acc) * (xs[r] * ws[m])) + bias[m]
//               rounded once to bf16 or kept in f32
//
// The dequant epilogue is the JAX package's order of operations, each step
// rounded on its own (__fmul_rn / __fadd_rn, which nvcc never contracts into
// an FMA), so it gives the plain PyTorch version's bits. The accumulation is
// exact in int32 while |acc| < 2^31; here |acc| <= 127^2 K <= 8.3e7.
//
// What bounds it on this card: operations. A ViT-B fc1 at 896^2 ([4097, 768]
// x [768, 3072]) is 19.3 GOP against 30.7 MB moved: 630 operations a byte,
// above the ~590 at which the int8 tensor cores (1979 TOPS dense) and HBM
// (3.35 TB/s) balance; the larger trunks' products are further above it.
//
// What the design does about it: a plain tiled product on mma.sync
// m16n8k32 (s8 x s8 -> s32). One block of 8 warps per 128 x 128 output tile;
// each warp owns 64 rows x 32 columns (4 x 4 mma tiles, 64 int32 registers).
// Both operands stream through shared memory in 64-byte-deep k tiles, three
// stages deep, with 16-byte cp.async copies into rows padded to 80 bytes
// (conflict-free ldmatrix). Because both operands are K-major, the plain
// ldmatrix (no .trans, which would permute 16-bit elements and scramble int8)
// on 16-byte rows yields the m16n8k32 s8 fragments directly: an A register
// holds 4 consecutive k of one row, a B register 4 consecutive k of one
// column, the same byte layout as the bf16 m16n8k16 fragments. Rows past R
// and columns past M load as zeros and are not stored; K must be a multiple
// of 32 (every trunk K is a multiple of 64), a partial last k tile loads
// zeros beyond K.
//
// Not yet: wgmma s8 with TMA, a persistent schedule, the activation's
// quantization fused in front (later work).

#include "flash_common.cuh"

#include <cstdint>

namespace {

using flash::cp_async_16;
using flash::cp_async_commit;
using flash::cp_async_wait;

constexpr int kBM = 128;                 // output rows (of xq) a block
constexpr int kBN = 128;                 // output columns (rows of wq) a block
constexpr int kBK = 64;                  // k bytes a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;            // 8 warps: 2 along rows, 4 along cols
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kLds = kBK + 16;           // padded smem row, bytes
constexpr int kStageBytes = (kBM + kBN) * kLds;
constexpr int kSmemBytes = kStages * kStageBytes;   // 61,440 B: opt in above 48 KB

enum Mode { kRaw = 0, kBf16 = 1, kF32 = 2 };

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b for one m16n8k32 tile: a is 16 x 32 s8 (row), b is 32 x 8 s8
// (col), c is 16 x 8 s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `kRows` rows of one k tile (k bytes [k0, k0 + 64)) into a padded smem
// tile: 4 16-byte chunks a row. Rows at or past `n` and chunks at or past
// `depth` arrive as zeros.
template <int kRows>
__device__ __forceinline__ void load_tile(int8_t* smem, const int8_t* base,
                                          int row0, int n, int k0, int depth,
                                          int tid) {
  static_assert(kRows * 4 % kThreads == 0, "tile loads must divide");
#pragma unroll
  for (int i = 0; i < kRows * 4 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 2;
    const int c = (idx & 3) * 16;
    const int row = row0 + r;
    const bool valid = row < n && k0 + c < depth;
    const int8_t* src =
        base + (valid ? static_cast<long long>(row) * depth + k0 + c : 0);
    cp_async_16(smem + r * kLds + c, src, valid);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ xq,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int rows, int cols, int depth) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;               // mma groupID
  const int t = lane & 3;                // thread in group
  const int wr = (warp >> 2) * kWarpM;   // warp's first row in the tile
  const int wc = (warp & 3) * kWarpN;    // warp's first column in the tile
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  int acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int mi = 0; mi < kWarpM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < kWarpN / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int ktiles = (depth + kBK - 1) / kBK;
  auto load_stage = [&](int stage, int kt) {
    int8_t* sa = smem + stage * kStageBytes;
    load_tile<kBM>(sa, xq, row0, rows, kt * kBK, depth, tid);
    load_tile<kBN>(sa + kBM * kLds, wq, col0, cols, kt * kBK, depth, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix addressing: lane l gives the row address of matrix l / 8, row
  // l % 8. A (x4): matrices rows 0-7 / 8-15 x bytes 0-15 / 16-31, in the
  // order of the A fragment's registers. B (x4): two n8 tiles, each as bytes
  // 0-15 then 16-31.
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 16;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile kt landed; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* sa = smem + (kt % kStages) * kStageBytes;
    const int8_t* sb = sa + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kWarpM / 16][4];
      uint32_t b[kWarpN / 8][2];
#pragma unroll
      for (int mi = 0; mi < kWarpM / 16; ++mi) {
        ldmatrix_x4(a[mi], sa + (wr + mi * 16 + a_row) * kLds + kk + a_col);
      }
#pragma unroll
      for (int ni = 0; ni < kWarpN / 8; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (wc + ni * 8 + b_row) * kLds + kk + b_col);
        b[ni][0] = r[0];
        b[ni][1] = r[1];
        b[ni + 1][0] = r[2];
        b[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kWarpM / 16; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWarpN / 8; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: c0, c1 at (g, 2t), (g, 2t + 1); c2, c3 eight rows below.
  const bool pairs = (cols & 1) == 0;    // 2-element stores stay aligned
#pragma unroll
  for (int mi = 0; mi < kWarpM / 16; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wr + mi * 16 + g + half * 8;
      if (row >= rows) continue;
      float xs = 0.f;
      if constexpr (kMode != kRaw) xs = x_scale[row];
#pragma unroll
      for (int ni = 0; ni < kWarpN / 8; ++ni) {
        const int col = col0 + wc + ni * 8 + 2 * t;
        if (col >= cols) continue;
        const bool both = col + 1 < cols;
        const int v0 = acc[mi][ni][2 * half];
        const int v1 = acc[mi][ni][2 * half + 1];
        const long long at = static_cast<long long>(row) * cols + col;
        if constexpr (kMode == kRaw) {
          int* o = static_cast<int*>(out) + at;
          if (both && pairs) {
            *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
          } else {
            o[0] = v0;
            if (both) o[1] = v1;
          }
        } else {
          float y0 = __fmul_rn(__int2float_rn(v0), __fmul_rn(xs, w_scale[col]));
          float y1 = 0.f;
          if (both) {
            y1 = __fmul_rn(__int2float_rn(v1), __fmul_rn(xs, w_scale[col + 1]));
          }
          if (bias != nullptr) {
            y0 = __fadd_rn(y0, bias[col]);
            if (both) y1 = __fadd_rn(y1, bias[col + 1]);
          }
          if constexpr (kMode == kBf16) {
            __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + at;
            if (both && pairs) {
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(y0, y1);
            } else {
              o[0] = __float2bfloat16_rn(y0);
              if (both) o[1] = __float2bfloat16_rn(y1);
            }
          } else {
            float* o = static_cast<float*>(out) + at;
            if (both && pairs) {
              *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
            } else {
              o[0] = y0;
              if (both) o[1] = y1;
            }
          }
        }
      }
    }
  }
}

template <int kMode>
int launch(const void* xq, const void* wq, const void* x_scale,
           const void* w_scale, const void* bias, void* out, int rows,
           int cols, int depth, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid((cols + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  int8_gemm_kernel<kMode><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), out, rows, cols, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq: contiguous [rows, depth] int8; wq: contiguous [cols, depth] int8; both
// 16-byte aligned, depth a multiple of 32. mode 0 stores the int32
// accumulator into out [rows, cols] (x_scale, w_scale and bias unused); mode
// 1 (bf16) and 2 (f32) store the dequantized product, with x_scale [rows] and
// w_scale [cols] f32 and bias [cols] f32 or null. Launches on `stream`;
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape or mode it
// does not take).
extern "C" int int8_gemm_s8(const void* xq, const void* wq,
                            const void* x_scale, const void* w_scale,
                            const void* bias, void* out, int rows, int cols,
                            int depth, int mode, void* stream) {
  if (rows <= 0 || cols <= 0 || depth <= 0 || depth % 32 != 0 ||
      (rows + kBM - 1) / kBM > 65535 ||
      (mode != kRaw && (x_scale == nullptr || w_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRaw:
      return launch<kRaw>(xq, wq, x_scale, w_scale, bias, out, rows, cols,
                          depth, st);
    case kBf16:
      return launch<kBf16>(xq, wq, x_scale, w_scale, bias, out, rows, cols,
                           depth, st);
    case kF32:
      return launch<kF32>(xq, wq, x_scale, w_scale, bias, out, rows, cols,
                          depth, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
