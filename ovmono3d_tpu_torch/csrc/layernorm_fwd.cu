// Row LayerNorm forward for Hopper (sm_90a): f32 statistics, the output in
// bf16 or f32, one warp per row.
//
// Replaces TPU kernels 9 and 12, each variant kept as its own instance so its
// arithmetic stays the TPU kernel's:
// - ovmono3d_tpu/ops/layernorm.py _ln_kernel (behind layer_norm_fused and
//   _ln_pallas), and tools/probe_layernorm.py _ln_kernel (v2, the same
//   math): kF32Stats, mean = sum / C and var = sum((x - mean)^2) / C;
// - tools/probe_layernorm.py _ln_kernel_dot (v3): kRecipMean, the row sums
//   (a product with a ones column there) multiplied by f32(1 / C);
// - tools/probe_layernorm.py _ln_kernel_bf16 (v4): kBf16Squares, as v3 but
//   each square (x - mean)^2 rounded to bf16 before its f32 sum.
// For x [rows, C] (bf16 or f32, contiguous), scale and bias [C] f32:
//
//     mean = sum_c x / C,  xc = x - mean,  var = sum_c xc^2 / C,
//     out  = (xc * rsqrt(var + eps)) * scale + bias
//
// Two passes over the row as the TPU kernel takes them (the mean, then the
// centred sum of squares), never E[x^2] - mean^2, which cancels.
//
// What bounds it on this card: bytes. 8 C flops a row against C * (in + out)
// bytes: ~2 flops a byte in bf16, far below the ~295 at which the card's
// compute would be the limit. [8, 4097, 768] bf16 -> bf16 moves 100.7 MB,
// 0.030 ms at 3.35 TB/s; [1, 4097, 768] moves 12.6 MB, 0.0038 ms, which is
// below a launch's own cost.
//
// What the design does about it: each byte crosses the bus once. One warp
// holds one row in registers (C / 32 values a lane: 24 at C = 768, 40 at
// 1280), loaded with 16-byte vectors where a lane's share allows (bf16 at
// C % 256 == 0, f32 always; 8 bytes for bf16 at C = 128 * odd), neighbouring
// lanes on neighbouring vectors. The two sums are warp shuffles in f32, the
// normalisation runs on the registers and the output leaves in one vector
// store a chunk. No shared memory, no synchronisation: 8 independent warps a
// block. Ragged row counts need no padding copy (the JAX wrapper pads to its
// block_rows): a warp past the last row returns. The product and sum of the
// epilogue are __fmul_rn / __fadd_rn, each rounded on its own as the plain
// version rounds them (nvcc would otherwise contract them into an FMA).
//
// Instances: the widths the models use, C = 128, 256, 512, 1024 (Swin-B's
// stages), 768 (DINOv2-B), 1024 (ViT-L) and 1280 (SAM ViT-H): bf16 or f32 in
// and out for kF32Stats, bf16 in and out for kRecipMean and kBf16Squares (the
// probe's input). Other widths are refused (the JAX kernel takes any
// C % 128 == 0; no model of either package has another).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode { kF32Stats = 0, kRecipMean = 1, kBf16Squares = 2 };

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// Elements a lane moves in one vector: 16 bytes where its share divides, else
// 8 bytes (bf16 at C = 128 * odd: 4 values a lane).
template <typename T, int kPerLane>
struct VecWidth {
  static constexpr int kBytes16 = 16 / static_cast<int>(sizeof(T));
  static constexpr int value = kPerLane % kBytes16 == 0 ? kBytes16 : 4;
};

__device__ __forceinline__ void load_vec(float* v, const float* p, int n) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[i] = f.x;
    v[i + 1] = f.y;
    v[i + 2] = f.z;
    v[i + 3] = f.w;
  }
}

__device__ __forceinline__ void unpack4(float* v, uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void load_vec(float* v, const __nv_bfloat16* p,
                                         int n) {
  if (n == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack4(v, make_uint2(u.x, u.y));
    unpack4(v + 4, make_uint2(u.z, u.w));
  } else {
    unpack4(v, *reinterpret_cast<const uint2*>(p));
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v, int n) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v,
                                          int n) {
  if (n == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                              pack2(v[2], v[3]));
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

template <typename TIn, typename TOut, int kPerLane, int kMode>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const TIn* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, TOut* __restrict__ out,
                  long long rows, float eps) {
  constexpr int C = kPerLane * 32;
  constexpr int kVec = VecWidth<TIn, kPerLane>::value;
  constexpr int kChunks = kPerLane / kVec;
  static_assert(kPerLane % kVec == 0, "a lane's share must be whole vectors");
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) {
    return;
  }
  const TIn* xr = x + row * C;
  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    load_vec(v + j * kVec, xr + (j * 32 + lane) * kVec, kVec);
  }

  float s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    s1 += v[i];
  }
  s1 = warp_sum(s1);
  const float mean = kMode == kF32Stats ? s1 / C : s1 * (1.0f / C);

  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    v[i] -= mean;
    float sq = __fmul_rn(v[i], v[i]);
    if (kMode == kBf16Squares) {
      sq = __bfloat162float(__float2bfloat16_rn(sq));
    }
    s2 += sq;
  }
  s2 = warp_sum(s2);
  const float var = kMode == kF32Stats ? s2 / C : s2 * (1.0f / C);
  const float inv = rsqrtf(var + eps);

#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int col = (j * 32 + lane) * kVec;
    float sc[kVec];
    float bi[kVec];
    load_vec(sc, scale + col, kVec);
    load_vec(bi, bias + col, kVec);
    float* w = v + j * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      w[e] = __fadd_rn(__fmul_rn(__fmul_rn(w[e], inv), sc[e]), bi[e]);
    }
    store_vec(out + row * C + col, w, kVec);
  }
}

template <typename TIn, typename TOut, int kPerLane, int kMode>
int launch(const void* x, const void* scale, const void* bias, void* out,
           long long rows, float eps, cudaStream_t st) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ln_fwd_kernel<TIn, TOut, kPerLane, kMode><<<static_cast<unsigned>(blocks),
                                              kThreads, 0, st>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TOut*>(out), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

#define LN_CASE(P)                                                       \
  case P:                                                                \
    return launch<TIn, TOut, P, kMode>(x, scale, bias, out, rows, eps, st);

// One table over the widths the models use (C / 32 values a lane).
template <typename TIn, typename TOut, int kMode>
int dispatch(int per_lane, const void* x, const void* scale, const void* bias,
             void* out, long long rows, float eps, cudaStream_t st) {
  switch (per_lane) {
    LN_CASE(4) LN_CASE(8) LN_CASE(16) LN_CASE(24) LN_CASE(32) LN_CASE(40)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef LN_CASE

}  // namespace

// x: contiguous [rows, C], dtype x_bf16 ? bf16 : f32; scale, bias: [C] f32;
// out: contiguous [rows, C], dtype out_bf16 ? bf16 : f32; mode: 0 kF32Stats,
// 1 kRecipMean, 2 kBf16Squares (1 and 2 take bf16 in and out only). All
// pointers 16-byte aligned. Launches on `stream`; returns cudaGetLastError()
// (or cudaErrorInvalidValue for a shape, dtype or mode it does not take).
extern "C" int layernorm_fwd(const void* x, const void* scale,
                             const void* bias, void* out, long long rows,
                             int C, int x_bf16, int out_bf16, int mode,
                             float eps, void* stream) {
  if (rows <= 0 || C <= 0 || C % 128 != 0 || C > 1280 ||
      (rows + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = C / 32;
  const auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (mode == kF32Stats) {
    if (x_bf16 && out_bf16) {
      return dispatch<bf16, bf16, kF32Stats>(p, x, scale, bias, out, rows,
                                             eps, st);
    }
    if (x_bf16) {
      return dispatch<bf16, float, kF32Stats>(p, x, scale, bias, out, rows,
                                              eps, st);
    }
    if (out_bf16) {
      return dispatch<float, bf16, kF32Stats>(p, x, scale, bias, out, rows,
                                              eps, st);
    }
    return dispatch<float, float, kF32Stats>(p, x, scale, bias, out, rows,
                                             eps, st);
  }
  if (!x_bf16 || !out_bf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kRecipMean) {
    return dispatch<bf16, bf16, kRecipMean>(p, x, scale, bias, out, rows, eps,
                                            st);
  }
  if (mode == kBf16Squares) {
    return dispatch<bf16, bf16, kBf16Squares>(p, x, scale, bias, out, rows,
                                              eps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
