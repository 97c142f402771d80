// int8 x int8 -> int32 matrix product for Hopper (sm_90a), with an optional
// dequantizing epilogue, and the per-row int8 quantization of its
// activation: the W8A8 serving path of the ViT trunks.
//
// Replaces the TPU kernel _int8_mm_kernel of tools/probe_int8_pallas.py
// (behind pallas_int8_matmul), the int8 product that int8_matmul
// (ovmono3d_tpu/ops/quant.py) hands to XLA, and the XLA fusion of
// quantize_int8 that feeds it. For xq [R, K] and wq [M, K], both int8,
// contiguous and K-major (wq is nn.Linear's [out, in] layout):
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
// The quantization (quantize_rows_kernel) writes, for x [R, K] in bf16 or
// f32, xs[r] = max(max_k |x[r, k]|, 1e-12) * f32(1/127) and xq[r, k] =
// clamp(rint(x[r, k] / xs[r]), -127, 127): quantize_int8's bits (the
// division IEEE-rounded, ties to even), in one launch where the plain
// version takes six device passes. One warp a row: a sweep for the absmax,
// a warp shuffle reduction, and a second sweep of the same row (from L1 or
// L2, so device memory is read once) that divides, rounds and stores.
//
// What bounds the product on this card: operations. A ViT-B fc1 at 896^2
// ([4097, 768] x [768, 3072]) is 19.3 GOP against 30.7 MB moved: 630
// operations a byte, above the ~590 at which the int8 tensor cores (1979
// TOPS dense) and HBM (3.35 TB/s) balance; the larger trunks' products are
// further above it. The quantization is bound by bytes.
//
// What the design does about it: wgmma s8 (m64n256k32, both operands
// K-major in shared memory) fed by TMA, on csrc/sm90_common.cuh's
// machinery. A persistent grid of one block of three warpgroups an SM
// walks over the 128 x 256 output tiles (row tiles fastest; 128 x 128 tiles
// were slower at every shape but LIFT's qkv, PERF.md). Warpgroup 0 is the
// producer: it gives its registers to the others (setmaxnreg: 40 for it,
// 232 for each consumer thread) and one of its threads keeps a ring of
// three k stages in flight, A (128 x 128 bytes) and B (256 x 128 bytes)
// each one 2-D TMA box with the 128-byte swizzle, so a stage is one
// 128-byte row of k per operand row and four k32 products. Warpgroups 1 and
// 2 each own 64 rows of the tile and keep one stage's products in flight
// while the next are issued; a stage is released once its products have
// landed. The epilogue dequantizes from the accumulator registers (the f32
// layout of sm90_common.cuh) into shared memory, laid out as the 128-byte
// swizzle of 64-row boxes, and one thread a consumer stores the boxes with
// TMA: the stores are whole lines, run while the next tile's products do,
// and clip rows past R and columns past M. The tile's w_scale and bias
// columns and its rows' x_scale are loaded when the tile starts, so the
// epilogue waits on no global load. (Stores from the accumulator registers
// and loads of the scales in the epilogue made the epilogue take longer
// than the products: PERF.md.) Rows past R and columns past M arrive as
// zeros (TMA's out-of-bounds fill); K must be a multiple of 32 (the tensor
// maps' 16-byte stride), and a partial last 128-byte k stage reads zeros
// beyond K; an output row must be a multiple of 16 bytes.
//
// Host cost: the weight's tensor map is encoded once by the caller
// (int8_gemm_weight_map) and kept with the quantized weight; a call
// encodes only the activation's and the output's.
//
// Not yet: two consumers on alternate tiles, so one's epilogue runs beside
// the other's products; the quantization fused into the product's
// producer.

#include "sm90_common.cuh"

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

enum Mode { kRaw = 0, kBf16 = 1, kF32 = 2 };

constexpr int kBM = 128;                    // output rows (of xq) a tile
constexpr int kBK = 128;                    // k bytes a stage
constexpr int kConsumers = 2;               // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// The launch gives every thread 168 registers (65536 / 384, in steps of
// 8); setmaxnreg asking the warpgroups for more than that in all waits
// forever.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  kLaunchRegs * kThreads,
              "setmaxnreg beyond the launch allocation waits forever");
// A consumer's output staging: 64 rows x 512 bytes, as boxes of 64 rows x
// 128 bytes (the 128-byte swizzle, 8 KB each) that TMA stores.
constexpr int kBoxBytes = 64 * 128;
constexpr int kStageOutBytes = 4 * kBoxBytes;

constexpr int kBN = 256;                    // output columns (of wq) a tile
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kStages = 3;                  // 144 KB
constexpr int kAcc = kBN / 2;               // s32 accumulators a thread

// Every tile is a multiple of 8 KB, so each stays 1024-byte aligned (the
// swizzle atom) when the struct is. Each consumer keeps the current tile's
// w_scale and bias columns and stages its outputs.
struct Smem {
  int8_t a[kStages][kBM * kBK];
  int8_t b[kStages][kBN * kBK];
  uint8_t out[kConsumers][kStageOutBytes];
  float w_scale[kConsumers][kBN];
  float bias[kConsumers][kBN];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;

// One stage's four k32 products into acc (scale_d 0: the tile's first
// stage). The descriptors of the four steps (a step moves both 32 bytes
// along the swizzled 128-byte rows) and scale_d are pinned in registers
// before the fence, so no instruction defines an operand between the
// products (ptxas would serialise them).
__device__ __forceinline__ void mma_stage(int (&acc)[kAcc],
                                          const int8_t* a_tile,
                                          const int8_t* b_tile, int first) {
  uint64_t da[kBK / 32], db[kBK / 32];
  const uint64_t a0 = sm90::desc_sw128(a_tile, 16, 1024);
  const uint64_t b0 = sm90::desc_sw128(b_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk) {
    da[kk] = a0 + 2 * kk;
    db[kk] = b0 + 2 * kk;
  }
  int scale_d = first ? 0 : 1;
  sm90::fence_operands(da);
  sm90::fence_operands(db);
  sm90::fence_operand(scale_d);
  sm90::fence_operands(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk) {
    sm90::wgmma_m64n256k32_s8(acc, da[kk], db[kk], kk == 0 ? scale_d : 1);
  }
  sm90::wgmma_commit();
}

// A tile's dequantization terms for one consumer: the scales of its
// thread's two rows, and the tile's w_scale and bias columns, one or two a
// thread, loaded when the tile starts and put into shared memory after its
// products, so the epilogue waits on no global load.
struct Terms {
  float xa, xb;
  float ws[kBN / 128], b[kBN / 128];
};

template <int kMode>
__device__ __forceinline__ void load_terms(Terms& tm,
                                           const float* __restrict__ x_scale,
                                           const float* __restrict__ w_scale,
                                           const float* __restrict__ bias,
                                           int rows, int cols, int ra,
                                           int col0, int ctl) {
  if constexpr (kMode != kRaw) {
    tm.xa = ra < rows ? __ldg(x_scale + ra) : 0.f;
    tm.xb = ra + 8 < rows ? __ldg(x_scale + ra + 8) : 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 128; ++i) {
      const int col = col0 + ctl + 128 * i;
      tm.ws[i] = col < cols ? __ldg(w_scale + col) : 0.f;
      tm.b[i] = bias != nullptr && col < cols ? __ldg(bias + col) : 0.f;
    }
  }
}

// The output of one accumulator pair, raw or dequantized (each step
// rounded on its own), as the 4 or 8 bytes it is stored as.
template <int kMode>
struct Pair {
  using T = typename std::conditional<kMode == kBf16, uint32_t, uint2>::type;
};

template <int kMode>
__device__ __forceinline__ typename Pair<kMode>::T out_pair(
    int v0, int v1, float xs, float2 w, float2 b, bool has_bias) {
  if constexpr (kMode == kRaw) {
    return make_uint2(static_cast<uint32_t>(v0), static_cast<uint32_t>(v1));
  } else {
    float y0 = __fmul_rn(__int2float_rn(v0), __fmul_rn(xs, w.x));
    float y1 = __fmul_rn(__int2float_rn(v1), __fmul_rn(xs, w.y));
    if (has_bias) {
      y0 = __fadd_rn(y0, b.x);
      y1 = __fadd_rn(y1, b.y);
    }
    if constexpr (kMode == kBf16) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y0, y1);
      return *reinterpret_cast<const uint32_t*>(&h);
    } else {
      return make_uint2(__float_as_uint(y0), __float_as_uint(y1));
    }
  }
}

// Writes the columns [pass * cols_a_pass, ...) of the consumer's 64 x 256
// block into its staging boxes: thread (warp w, lane 4g + t) holds rows
// r = 16w + g and r + 8, columns 8j + 2t and 8j + 2t + 1. A box is 64 rows
// of 128 bytes; the 16-byte chunk c of row r sits at chunk c ^ (r % 8), as
// the 128-byte swizzle lays it out, so a warp's 4-byte writes hit 32
// different banks.
template <int kMode>
__device__ __forceinline__ void stage_out(const int (&acc)[kAcc],
                                          uint8_t* staging, const float* ws,
                                          const float* bs, bool has_bias,
                                          float xa, float xb, int r, int t,
                                          int pass) {
  constexpr int kEs = kMode == kBf16 ? 2 : 4;           // bytes an output
  constexpr int kPassCols = kStageOutBytes / (64 * kEs);
  constexpr int kBoxCols = 128 / kEs;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (8 * j / kPassCols != pass) continue;   // known at compile time
    float2 w = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    if constexpr (kMode != kRaw) {
      w = *reinterpret_cast<const float2*>(ws + col);
      b = *reinterpret_cast<const float2*>(bs + col);
    }
    const int c = col % kPassCols;
    const int byte = (c % kBoxCols) * kEs;
    uint8_t* at = staging + (c / kBoxCols) * kBoxBytes + r * 128 +
                  ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
    using T = typename Pair<kMode>::T;
    *reinterpret_cast<T*>(at) = out_pair<kMode>(
        acc[4 * j], acc[4 * j + 1], xa, w, b, has_bias);
    *reinterpret_cast<T*>(at + 8 * 128) = out_pair<kMode>(
        acc[4 * j + 2], acc[4 * j + 3], xb, w, b, has_bias);
  }
}

// A persistent grid: block b takes the tiles b, b + gridDim.x, ... (tile =
// row tile + row_tiles * column tile).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                          const __grid_constant__ CUtensorMap tm_b,
                          const __grid_constant__ CUtensorMap tm_out,
                          const float* __restrict__ x_scale,
                          const float* __restrict__ w_scale,
                          const float* __restrict__ bias, int rows, int cols,
                          int depth) {
  constexpr int kEs = kMode == kBf16 ? 2 : 4;
  constexpr int kPasses = 64 * kBN * kEs / kStageOutBytes;
  constexpr int kPassCols = kStageOutBytes / (64 * kEs);
  constexpr int kBoxCols = 128 / kEs;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int row_tiles = (rows + kBM - 1) / kBM;
  const int tiles = row_tiles * ((cols + kBN - 1) / kBN);
  const int ktiles = (depth + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], kConsumers * 4);   // one per warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer warpgroup: one thread keeps the stages' loads in flight.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_a);
      sm90::prefetch_tensormap(&tm_b);
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int r0 = (tile % row_tiles) * kBM;
        const int c0 = (tile / row_tiles) * kBN;
        for (int kb = 0; kb < ktiles; ++kb) {
          // A fresh barrier passes a wait at parity 1: the first round of
          // stages goes in at once.
          sm90::mbar_wait(&sm.empty[s], phase ^ 1);
          sm90::mbar_expect_tx(&sm.full[s], kStageBytes);
          sm90::tma_load_2d(sm.a[s], &tm_a, &sm.full[s], kb * kBK, r0);
          sm90::tma_load_2d(sm.b[s], &tm_b, &sm.full[s], kb * kBK, c0);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int ctid = threadIdx.x - 128;
    const int cw = ctid / 128;              // rows 64 cw .. 64 cw + 63
    const int ctl = ctid % 128;
    const int warp = ctl / 32;
    const int lane = ctid % 32;
    const int r = warp * 16 + lane / 4;     // the thread's first row
    const int bar = 1 + cw;                 // this consumer's named barrier
    const bool leader = ctl == 0;           // issues the consumer's stores
    if (leader) {
      sm90::prefetch_tensormap(&tm_out);
    }
    int acc[kAcc];
    Terms tm{};
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = (tile % row_tiles) * kBM + cw * 64;
      const int c0 = (tile / row_tiles) * kBN;
      load_terms<kMode>(tm, x_scale, w_scale, bias, rows, cols, r0 + r, c0,
                        ctl);
      int prev = -1;
      for (int kb = 0; kb < ktiles; ++kb) {
        sm90::mbar_wait(&sm.full[s], phase);
        mma_stage(acc, sm.a[s] + cw * 64 * kBK, sm.b[s], kb == 0);
        sm90::wgmma_wait<1>();              // the previous stage's landed
        sm90::fence_operands(acc);
        if (prev >= 0 && lane == 0) {
          sm90::mbar_arrive(&sm.empty[prev]);
        }
        prev = s;
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      if (lane == 0) {
        sm90::mbar_arrive(&sm.empty[prev]);
      }
      // The epilogue: dequantize into the staging boxes, then one thread
      // stores them with TMA, which clips rows past R and columns past M.
      // Before a pass writes the staging, the last stores have read it.
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        if (leader) {
          sm90::bulk_wait_read<0>();
        }
        sm90::named_barrier(bar, 128);
        if (kMode != kRaw && pass == 0) {
#pragma unroll
          for (int i = 0; i < kBN / 128; ++i) {
            sm.w_scale[cw][ctl + 128 * i] = tm.ws[i];
            sm.bias[cw][ctl + 128 * i] = tm.b[i];
          }
          sm90::named_barrier(bar, 128);
        }
        stage_out<kMode>(acc, sm.out[cw], sm.w_scale[cw], sm.bias[cw],
                         bias != nullptr, tm.xa, tm.xb, r, lane & 3, pass);
        sm90::fence_proxy_async();          // the writes, seen by TMA
        sm90::named_barrier(bar, 128);
        if (leader) {
          for (int box = 0; box * kBoxCols < kPassCols; ++box) {
            sm90::tma_store_2d(&tm_out, sm.out[cw] + box * kBoxBytes,
                               c0 + pass * kPassCols + box * kBoxCols, r0);
          }
          sm90::bulk_commit();
        }
      }
    }
    if (leader) {
      sm90::bulk_wait_read<0>();            // the staging outlives its stores
    }
  }
}

template <int kMode>
int launch(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
           const CUtensorMap& tm_out, const void* x_scale,
           const void* w_scale, const void* bias, int rows, int cols,
           int depth, cudaStream_t stream) {
  auto* kernel = int8_gemm_sm90_kernel<kMode>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const long long tiles = static_cast<long long>((rows + kBM - 1) / kBM) *
                          ((cols + kBN - 1) / kBN);
  const int grid = static_cast<int>(std::min<long long>(tiles, sms));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      tm_a, tm_b, tm_out, static_cast<const float*>(x_scale),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      rows, cols, depth);
  return static_cast<int>(cudaGetLastError());
}

// ---- the activation's quantization ----

// f32(1/127), as PyTorch rounds the Python constant 1.0 / 127.0.
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr int kQuantWarps = 8;

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8],
                                       const __nv_bfloat16*) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4],
                                       const float*) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ uint32_t quantize4(const float* v, float scale) {
  uint32_t packed = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q =
        fminf(fmaxf(rintf(__fdiv_rn(v[e], scale)), -127.f), 127.f);
    packed |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * e);
  }
  return packed;
}

// One warp a row of x [rows, depth] (row stride `row_stride` elements, 16-
// byte aligned rows, depth a multiple of 32): xq [rows, depth] int8 and
// x_scale [rows] f32, quantize_int8's bits.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
    quantize_rows_kernel(const T* __restrict__ x, long long row_stride,
                         int8_t* __restrict__ xq,
                         float* __restrict__ x_scale, int rows, int depth) {
  constexpr int kPer = 16 / sizeof(T);      // elements a 16-byte load
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (row >= rows) {
    return;
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * row_stride);
  const int vecs = depth / kPer;
  float amax = 0.f;
  for (int i = lane; i < vecs; i += 32) {
    float v[kPer];
    unpack(__ldg(xr + i), v, x);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      amax = fmaxf(amax, fabsf(v[e]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), kInv127);
  if (lane == 0) {
    x_scale[row] = scale;
  }
  int8_t* qr = xq + static_cast<long long>(row) * depth;
  for (int i = lane; i < vecs; i += 32) {
    float v[kPer];
    unpack(__ldg(xr + i), v, x);
    if constexpr (kPer == 8) {
      *reinterpret_cast<uint2*>(qr + i * kPer) =
          make_uint2(quantize4(v, scale), quantize4(v + 4, scale));
    } else {
      *reinterpret_cast<uint32_t*>(qr + i * kPer) = quantize4(v, scale);
    }
  }
}

}  // namespace

// The tensor map of wq [cols, depth] (contiguous int8, 16-byte aligned,
// depth a multiple of 32) for int8_gemm_s8, written into `map` (host
// memory, 128 bytes). The map holds wq's address: it serves while wq lives.
// Returns cuTensorMapEncodeTiled's result, 0 on success
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int int8_gemm_weight_map(void* map, const void* wq, int cols,
                                    int depth) {
  if (cols <= 0 || depth <= 0 || depth % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm;                            // the encoder writes it aligned
  const int rc = sm90::encode_matrix(&tm, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                     1, cols, depth, kBN);
  if (rc == 0) {
    std::memcpy(map, &tm, sizeof(CUtensorMap));
  }
  return rc;
}

// xq: contiguous [rows, depth] int8; wq: contiguous [cols, depth] int8; both
// 16-byte aligned, depth a multiple of 32. w_map: wq's tensor map from
// int8_gemm_weight_map, or null to encode it here. mode
// 0 stores the int32 accumulator into out [rows, cols] (x_scale, w_scale
// and bias unused); mode 1 (bf16) and 2 (f32) store the dequantized
// product, with x_scale [rows] and w_scale [cols] f32 and bias [cols] f32
// or null. out: contiguous, 16-byte aligned, its rows a multiple of 16
// bytes. Launches on `stream`; returns cudaGetLastError(),
// cuTensorMapEncodeTiled's result if a tensor map cannot be encoded, or
// cudaErrorInvalidValue for a shape or mode it does not take.
extern "C" int int8_gemm_s8(const void* xq, const void* wq,
                            const void* w_map, const void* x_scale,
                            const void* w_scale, const void* bias, void* out,
                            int rows, int cols, int depth, int mode,
                            void* stream) {
  const int out_bytes = mode == kBf16 ? 2 : 4;
  if (rows <= 0 || cols <= 0 || depth <= 0 || depth % 32 != 0 ||
      mode < kRaw || mode > kF32 ||
      cols * out_bytes % 16 != 0 ||
      (mode != kRaw && (x_scale == nullptr || w_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_a, tm_b, tm_out;
  int rc = sm90::encode_matrix(&tm_a, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                               rows, depth, kBM);
  if (rc == 0) {
    const CUtensorMapDataType dtype =
        mode == kBf16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
        : mode == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_INT32;
    rc = sm90::encode_matrix(&tm_out, out, dtype, out_bytes, rows, cols, 64);
  }
  if (rc == 0 && w_map != nullptr) {
    std::memcpy(&tm_b, w_map, sizeof(CUtensorMap));
  } else if (rc == 0) {
    rc = sm90::encode_matrix(&tm_b, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                             cols, depth, kBN);
  }
  if (rc != 0) {
    return rc;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRaw:
      return launch<kRaw>(tm_a, tm_b, tm_out, x_scale, w_scale, bias, rows,
                          cols, depth, st);
    case kBf16:
      return launch<kBf16>(tm_a, tm_b, tm_out, x_scale, w_scale, bias, rows,
                           cols, depth, st);
    default:
      return launch<kF32>(tm_a, tm_b, tm_out, x_scale, w_scale, bias, rows,
                          cols, depth, st);
  }
}

// x: [rows, depth] bf16 (dtype 0) or f32 (dtype 1) with row stride
// `row_stride` elements (unit stride along depth; pointer and rows 16-byte
// aligned), depth a multiple of 32. Writes xq: contiguous [rows, depth]
// int8 (8-byte aligned) and x_scale [rows] f32. Launches on `stream`;
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape or
// dtype it does not take).
extern "C" int int8_quantize_rows(const void* x, int dtype,
                                  long long row_stride, void* xq,
                                  void* x_scale, int rows, int depth,
                                  void* stream) {
  if (rows <= 0 || depth <= 0 || depth % 32 != 0 || row_stride < depth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((rows + kQuantWarps - 1) / kQuantWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<int8_t*>(xq);
  auto* s = static_cast<float*>(x_scale);
  if (dtype == 0) {
    quantize_rows_kernel<__nv_bfloat16><<<grid, kQuantWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), row_stride, q, s, rows, depth);
  } else if (dtype == 1) {
    quantize_rows_kernel<float><<<grid, kQuantWarps * 32, 0, st>>>(
        static_cast<const float*>(x), row_stride, q, s, rows, depth);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
