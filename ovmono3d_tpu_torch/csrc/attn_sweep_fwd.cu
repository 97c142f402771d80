// The attention forward of the block-size sweep, for Hopper (sm_90a): bf16
// q, k, v and out at head dim 64, an online softmax over key blocks whose
// rounding points follow the swept TPU kernel's, templated on the q block,
// the key block and the softmax dtype.
//
// Replaces the TPU kernel make_kernel(sm_f32) of tools/profile_attn_sweep.py
// (behind its `flash`): kernel 2's online forward, with padded keys masked by
// an additive -1e30 and a switch that keeps the softmax in f32 or in the
// input dtype. Per (batch, head) and q row, over key blocks of kBlockK:
//
//     q'  = bf16(f32(q) * scale)                      (scale = 1 / sqrt(D))
//     s   = q' k^T in f32;  bf16 softmax: s = bf16(s)
//     s  += mask (0, or -1e30 past N; in the softmax dtype)
//     m   = max(m_prev, rowmax(s))                    (f32, from -1e30)
//     p   = exp(s - m)     bf16 softmax: bf16(exp(bf16(s - bf16(m))))
//     l   = l_prev * exp(m_prev - m) + sum(p)         (f32)
//     acc = acc * exp(m_prev - m) + bf16(p) v         (f32)
//     out = bf16(acc / max(l, 1e-30))
//
// With a bf16 softmax, p's rounding depends on the running max, and so on
// the key block: the plain version (attn_sweep_ref) runs the same recurrence
// over the same blocks. exp is expf, not exp2f with log2(e) folded into the
// scale, so the rounding matches exp on f32.
//
// What bounds it on this card: the QK^T and PV products, 4 N^2 D flops per
// (batch, head): 0.0521 ms at the probe's [1, 4097, 12, 64] on the bf16
// tensor cores, against ~25 MB of q, k, v and out (0.0075 ms at 3.35 TB/s).
//
// The TPU variants hold the whole key set in VMEM (block_k 4352-4608); at
// D = 64 that is 1.18 MB of K and V, against 227 KB of shared memory a
// block here. So the instances sweep the tiles the card holds, on the
// probe's two axes: kBlockQ in {64, 128} (4 or 8 warps, each owning 16 q
// rows), kBlockK in {64, 128} (the S tile a warp keeps in registers: 32 or
// 64 floats a thread) and the softmax in f32 or bf16. K and V tiles stream
// through shared memory double-buffered with cp.async (16-byte copies into
// rows padded to D + 8, conflict-free fragment loads); both products are
// mma.sync m16n8k16 bf16 with f32 accumulators from flash_common.cuh, V's
// fragments from ldmatrix.trans; P goes from the S registers into the PV
// product without a trip through shared memory. q, k and v are read as
// strided [B, N, H, D] views (no head-major copies); out is contiguous
// [B, N, H, D]. Rows past N load as zeros and are not stored.
//
// Not yet: wgmma, TMA, warp specialisation (the fast-kernel work of kernel 1
// applies here too).

#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

constexpr int kD = 64;
constexpr int kStride = kD + 8;            // padded smem row, elements
constexpr int kChunks = kD / 8;            // 16-byte chunks a row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy rows [row0, row0 + kRows) of one head into a padded smem tile; rows
// at or past n arrive as zeros.
template <int kRows, int kThreadsT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int n, int tid) {
  static_assert(kRows * kChunks % kThreadsT == 0, "tile loads must divide");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreadsT; ++i) {
    const int idx = tid + i * kThreadsT;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < n;
    const __nv_bfloat16* src =
        base + (valid ? static_cast<long long>(row) * row_stride + c : 0);
    cp_async_16(smem + r * kStride + c, src, valid);
  }
}

template <int kBlockQ, int kBlockK>
struct SweepSmem {
  static constexpr int kQ = kBlockQ * kStride;
  static constexpr int kKV = kBlockK * kStride;
  static constexpr int kBytes = (kQ + 4 * kKV) * 2;   // q, 2 x (k, v)
};

template <int kBlockQ, int kBlockK, bool kSoftmaxF32>
__global__ void __launch_bounds__(kBlockQ * 2)
    sweep_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int n, int heads,
                     Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int kThreadsT = kBlockQ * 2;   // one warp per 16 q rows
  constexpr int kNJ = kBlockK / 8;         // S column groups a warp holds
  using Smem = SweepSmem<kBlockQ, kBlockK>;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sq = smem;
  __nv_bfloat16* sk[2] = {smem + Smem::kQ, smem + Smem::kQ + Smem::kKV};
  __nv_bfloat16* sv[2] = {smem + Smem::kQ + 2 * Smem::kKV,
                          smem + Smem::kQ + 3 * Smem::kKV};

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  const int n_tiles = (n + kBlockK - 1) / kBlockK;

  load_rows<kBlockQ, kThreadsT>(sq, qb, qs.n, q0, n, tid);
  load_rows<kBlockK, kThreadsT>(sk[0], kb, ks.n, 0, n, tid);
  load_rows<kBlockK, kThreadsT>(sv[0], vb, vs.n, 0, n, tid);
  cp_async_commit();

  uint32_t qf[kD / 16][4];
  float o[kD / 8][4] = {};
  float m[2] = {kNegInf, kNegInf};         // running row max (rows g, g+8)
  float l[2] = {0.f, 0.f};                 // this thread's partial row sums
  // bf16(-1e30): the mask in the softmax dtype.
  const float mask = kSoftmaxF32 ? kNegInf : round_bf16(kNegInf);

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_rows<kBlockK, kThreadsT>(sk[cur ^ 1], kb, ks.n, (it + 1) * kBlockK,
                                    n, tid);
      load_rows<kBlockK, kThreadsT>(sv[cur ^ 1], vb, vs.n, (it + 1) * kBlockK,
                                    n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
      // q' = bf16(f32(q) * scale), as A fragments of this warp's 16 rows.
      const __nv_bfloat16* w = sq + warp * 16 * kStride;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* p = w + kk * 16 + 2 * t;
        const __nv_bfloat16* src[4] = {p + g * kStride, p + (g + 8) * kStride,
                                       p + g * kStride + 8,
                                       p + (g + 8) * kStride + 8};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(src[r]));
          qf[kk][r] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
    }

    // S = q' K^T for this warp's 16 rows and the tile's kBlockK keys.
    float s[kNJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const __nv_bfloat16* r = sk[cur] + (j * 8 + g) * kStride + kk * 16 +
                                 2 * t;
        mma_bf16(s[j], qf[kk], ld_u32(r), ld_u32(r + 8));
      }
    }

    // Round to the softmax dtype, add the mask, take the new row max.
    const int key0 = it * kBlockK;
    float mx0 = kNegInf;
    float mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = kSoftmaxF32 ? s[j][e] : round_bf16(s[j][e]);
        if (key0 + j * 8 + 2 * t + (e & 1) >= n) {
          x = kSoftmaxF32 ? x + mask : round_bf16(x + mask);
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float m_new0 = fmaxf(m[0], mx0);
    const float m_new1 = fmaxf(m[1], mx1);
    const float alpha0 = expf(m[0] - m_new0);
    const float alpha1 = expf(m[1] - m_new1);
    m[0] = m_new0;
    m[1] = m_new1;
    const float mb0 = kSoftmaxF32 ? m_new0 : round_bf16(m_new0);
    const float mb1 = kSoftmaxF32 ? m_new1 : round_bf16(m_new1);

    // p = exp(s - m), in the softmax dtype; its f32 row sum.
    float rs0 = 0.f;
    float rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mb = e < 2 ? mb0 : mb1;
        float p = kSoftmaxF32 ? expf(s[j][e] - mb)
                              : round_bf16(expf(round_bf16(s[j][e] - mb)));
        s[j][e] = p;
      }
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }

    // acc += bf16(p) V: P as bf16 A fragments over the tile's kBlockK keys.
    const int mat = lane >> 3;
    const int mrow = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv[cur] + (kk * 16 + (mat & 1) * 8 + mrow) *
                                           kStride +
                                 dp * 16 + (mat >> 1) * 8);
        mma_bf16(o[2 * dp], pf, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pf, b[2], b[3]);
      }
    }
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 1);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 2);
  const float den0 = fmaxf(l[0], 1e-30f);
  const float den1 = fmaxf(l[1], 1e-30f);

  const long long row_elems = static_cast<long long>(heads) * kD;
  __nv_bfloat16* ob =
      out + static_cast<long long>(batch) * n * row_elems + head * kD;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(ob + r0 * row_elems + col) =
          pack_bf16(o[dn][0] / den0, o[dn][1] / den0);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(ob + r1 * row_elems + col) =
          pack_bf16(o[dn][2] / den1, o[dn][3] / den1);
    }
  }
}

template <int kBlockQ, int kBlockK, bool kSoftmaxF32>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n, int heads, const Strides& qs, const Strides& ks,
           const Strides& vs, float scale, cudaStream_t st) {
  constexpr int kSmem = SweepSmem<kBlockQ, kBlockK>::kBytes;
  auto* kernel = sweep_fwd_kernel<kBlockQ, kBlockK, kSoftmaxF32>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kBlockQ * 2, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      n, heads, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kBlockQ, int kBlockK>
int launch_sm(bool softmax_f32, const void* q, const void* k, const void* v,
              void* out, int batch, int n, int heads, const Strides& qs,
              const Strides& ks, const Strides& vs, float scale,
              cudaStream_t st) {
  return softmax_f32
             ? launch<kBlockQ, kBlockK, true>(q, k, v, out, batch, n, heads,
                                              qs, ks, vs, scale, st)
             : launch<kBlockQ, kBlockK, false>(q, k, v, out, batch, n, heads,
                                               qs, ks, vs, scale, st);
}

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with the given batch/token/head strides (in
// elements, last stride 1, 16-byte aligned rows). out: contiguous
// [B, N, H, 64] bf16. block_q and block_k in {64, 128}; softmax_f32 0 or 1;
// scale = 1 / sqrt(D). Launches on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or instance it does not take).
extern "C" int attn_sweep_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, int batch, int n,
    int heads, int head_dim, int block_q, int block_k, int softmax_f32,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, float scale, void* stream) {
  if (n <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      head_dim != kD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const bool f32 = softmax_f32 != 0;
  if (block_q == 64 && block_k == 64) {
    return launch_sm<64, 64>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                             scale, st);
  }
  if (block_q == 64 && block_k == 128) {
    return launch_sm<64, 128>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                              scale, st);
  }
  if (block_q == 128 && block_k == 64) {
    return launch_sm<128, 64>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                              scale, st);
  }
  if (block_q == 128 && block_k == 128) {
    return launch_sm<128, 128>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                               scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
