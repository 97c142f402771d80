// Flash-attention backward for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces two TPU kernels of ovmono3d_tpu/ops/attention.py, at head dims 32
// and 64: _flash_bwd_packed_kernel, behind flash_attention_packed_bwd
// (packed [B, N, H*D]), and the head-major _flash_bwd_fused_kernel or its
// split pair _flash_bwd_dq_kernel / _flash_bwd_dkv_kernel, behind
// flash_attention_bwd ([B*H, N, D]). The TPU's tiling needs both layouts;
// these kernels take any batch/token/head strides, so one pair serves both.
// From q, k, v (strided views, e.g. of the qkv projection's output
// [B, N, 3, H, D]), the output's gradient do,
// the forward's row log-sum-exp lse ([B, H, N] f32, natural log, written by
// flash_attn_fwd.cu) and delta = rowsum(do * o) ([B, H, N] f32, a small
// reduction done outside), it rebuilds the probabilities tile by tile,
//     p  = exp(q k^T / sqrt(D) - lse)
// and computes
//     dv = p^T do,   dp = do v^T,   ds = p * (dp - delta),
//     dk = ds^T q / sqrt(D),   dq = ds k / sqrt(D).
// dq, dk and dv are written with their own strides: the packed route lands
// them straight in the three slots of one [B, N, 3, H, D] gradient of the
// qkv output, which the qkv projection's backward reads with no stack or
// copy; the head-major route writes three [B, N, H, D] tensors.
//
// What bounds it on this card: tensor-core work. The backward needs
// 10*N^2*D flops per (batch, head) (p rebuilt once, four products); this
// design spends 14*N^2*D, because both kernels rebuild s = q k^T and the dq
// kernel recomputes dp. At N = 4097, H = 12 that is 129 GFLOP of necessary
// work per trunk layer and image against O(N*D) bytes of traffic.
//
// What the design does about it: FlashAttention-2's split into two kernels,
// deterministic and free of atomics.
// - flash_bwd_dkdv_kernel: one block of 4 warps per (64-key tile, head,
//   batch); each warp owns 16 keys, keeps its K and V rows as A fragments
//   and its dk/dv accumulators in registers, and streams 64-row q/do tiles
//   (double-buffered cp.async) through shared memory. s^T = k q^T and
//   dp^T = v do^T come out in the accumulator layout, p^T and ds^T are
//   packed in registers into the A operands of dv += p^T do and
//   dk += ds^T q.
// - flash_bwd_dq_kernel: one block per (64-row q tile, head, batch); each
//   warp owns 16 q rows with their q and do rows as A fragments and dq in
//   registers, and streams 64-key k/v tiles. ds is packed in registers into
//   the A operand of dq += ds k.
// All products are mma.sync m16n8k16 (bf16 in, f32 accumulators); the
// products that contract over rows take their B fragments via
// ldmatrix.trans. p and ds are rounded to bf16 for the products, as the TPU
// kernel does.
//
// Ragged edges: rows past N load as zeros. In the dk/dv kernel, query rows
// past N get lse = +inf (so p = 0) and delta = 0; key rows past N are not
// stored. In the dq kernel keys past N get p = 0 and query rows past N are
// not stored.
//
// Not yet: wgmma, TMA, a fused single-pass variant (the TPU's
// _flash_bwd_fused_kernel), an f32 instance.

#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

struct Grad {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;        // [B, H, N], natural log
  const float* delta;      // [B, H, N]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int n, heads;
  float scale, scale_log2;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Grad a) {
  constexpr int kTile = Tile<D>::kElems;
  __shared__ __align__(16) __nv_bfloat16 sq[2][kTile];
  __shared__ __align__(16) __nv_bfloat16 sdo[2][kTile];
  __shared__ float slse[2][kBlock];       // lse in base-2 units
  __shared__ float sdelta[2][kBlock];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int n = a.n;

  const __nv_bfloat16* qb = a.q + batch * a.qs.b + head * a.qs.h;
  const __nv_bfloat16* kb = a.k + batch * a.ks.b + head * a.ks.h;
  const __nv_bfloat16* vb = a.v + batch * a.vs.b + head * a.vs.h;
  const __nv_bfloat16* dob = a.dout + batch * a.dos.b + head * a.dos.h;
  const long long row_bh = (static_cast<long long>(batch) * a.heads + head) * n;
  const float* lseb = a.lse + row_bh;
  const float* deltab = a.delta + row_bh;
  const int n_tiles = (n + kBlock - 1) / kBlock;

  auto load_rows = [&](int buf, int row0) {
    if (tid < kBlock) {
      const int row = row0 + tid;
      slse[buf][tid] = row < n ? lseb[row] * kLog2e : INFINITY;
      sdelta[buf][tid] = row < n ? deltab[row] : 0.f;
    }
  };

  // Prologue: this block's K and V tile through buffer 1 into registers,
  // the first q/do tile into buffer 0.
  load_tile<D>(sq[1], kb, a.ks.n, k0, n, tid);
  load_tile<D>(sdo[1], vb, a.vs.n, k0, n, tid);
  load_tile<D>(sq[0], qb, a.qs.n, 0, n, tid);
  load_tile<D>(sdo[0], dob, a.dos.n, 0, n, tid);
  cp_async_commit();
  load_rows(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[D / 16][4];
  uint32_t vf[D / 16][4];
  load_a_frags<D>(kf, sq[1], warp, g, t);
  load_a_frags<D>(vf, sdo[1], warp, g, t);
  __syncthreads();

  float dk[D / 8][4] = {};
  float dv[D / 8][4] = {};

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(sq[cur ^ 1], qb, a.qs.n, (it + 1) * kBlock, n, tid);
      load_tile<D>(sdo[cur ^ 1], dob, a.dos.n, (it + 1) * kBlock, n, tid);
      cp_async_commit();
      load_rows(cur ^ 1, (it + 1) * kBlock);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s^T = K Q^T for this warp's 16 keys and the tile's 64 queries, then
    // p^T = exp2(s^T * scale log2(e) - lse2[query]).
    float p[kBlock / 8][4] = {};
    mma_a_rowsT<D>(p, kf, sq[cur], g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lq = slse[cur][j * 8 + 2 * t + e];
        p[j][e] = exp2f(p[j][e] * a.scale_log2 - lq);
        p[j][2 + e] = exp2f(p[j][2 + e] * a.scale_log2 - lq);
      }
    }
    uint32_t pf[kBlock / 16][4];
    pack_a_frags(pf, p);
    mma_p_rows<D>(dv, pf, sdo[cur], lane);           // dv += p^T do

    // dp^T = V dO^T; ds^T = p^T (dp^T - delta[query]).
    float ds[kBlock / 8][4] = {};
    mma_a_rowsT<D>(ds, vf, sdo[cur], g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = sdelta[cur][j * 8 + 2 * t + e];
        ds[j][e] = p[j][e] * (ds[j][e] - dl);
        ds[j][2 + e] = p[j][2 + e] * (ds[j][2 + e] - dl);
      }
    }
    uint32_t dsf[kBlock / 16][4];
    pack_a_frags(dsf, ds);
    mma_p_rows<D>(dk, dsf, sq[cur], lane);           // dk += ds^T q
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  const int row0 = k0 + warp * 16;
  store_rows<D>(a.dk + batch * a.dks.b + head * a.dks.h, a.dks.n, dk, row0, n,
             g, t, a.scale, a.scale);
  store_rows<D>(a.dv + batch * a.dvs.b + head * a.dvs.h, a.dvs.n, dv, row0, n,
             g, t, 1.f, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Grad a) {
  constexpr int kTile = Tile<D>::kElems;
  __shared__ __align__(16) __nv_bfloat16 sk[2][kTile];
  __shared__ __align__(16) __nv_bfloat16 sv[2][kTile];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int n = a.n;

  const __nv_bfloat16* qb = a.q + batch * a.qs.b + head * a.qs.h;
  const __nv_bfloat16* kb = a.k + batch * a.ks.b + head * a.ks.h;
  const __nv_bfloat16* vb = a.v + batch * a.vs.b + head * a.vs.h;
  const __nv_bfloat16* dob = a.dout + batch * a.dos.b + head * a.dos.h;
  const long long row_bh = (static_cast<long long>(batch) * a.heads + head) * n;
  const int n_tiles = (n + kBlock - 1) / kBlock;

  // Prologue: this block's Q and dO tile through buffer 1 into registers,
  // the first K/V tile into buffer 0.
  load_tile<D>(sk[1], qb, a.qs.n, q0, n, tid);
  load_tile<D>(sv[1], dob, a.dos.n, q0, n, tid);
  load_tile<D>(sk[0], kb, a.ks.n, 0, n, tid);
  load_tile<D>(sv[0], vb, a.vs.n, 0, n, tid);
  cp_async_commit();
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const float lq0 = r0 < n ? a.lse[row_bh + r0] * kLog2e : INFINITY;
  const float lq1 = r1 < n ? a.lse[row_bh + r1] * kLog2e : INFINITY;
  const float dl0 = r0 < n ? a.delta[row_bh + r0] : 0.f;
  const float dl1 = r1 < n ? a.delta[row_bh + r1] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  load_a_frags<D>(qf, sk[1], warp, g, t);
  load_a_frags<D>(dof, sv[1], warp, g, t);
  __syncthreads();

  float dq[D / 8][4] = {};

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(sk[cur ^ 1], kb, a.ks.n, (it + 1) * kBlock, n, tid);
      load_tile<D>(sv[cur ^ 1], vb, a.vs.n, (it + 1) * kBlock, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // p = exp2(s * scale log2(e) - lse2), zero for keys past n.
    float p[kBlock / 8][4] = {};
    mma_a_rowsT<D>(p, qf, sk[cur], g, t);
    const int key0 = it * kBlock;
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = key0 + j * 8 + 2 * t + e < n;
        p[j][e] = ok ? exp2f(p[j][e] * a.scale_log2 - lq0) : 0.f;
        p[j][2 + e] = ok ? exp2f(p[j][2 + e] * a.scale_log2 - lq1) : 0.f;
      }
    }

    // dp = dO V^T; ds = p (dp - delta).
    float ds[kBlock / 8][4] = {};
    mma_a_rowsT<D>(ds, dof, sv[cur], g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - dl0);
      ds[j][1] = p[j][1] * (ds[j][1] - dl0);
      ds[j][2] = p[j][2] * (ds[j][2] - dl1);
      ds[j][3] = p[j][3] * (ds[j][3] - dl1);
    }
    uint32_t dsf[kBlock / 16][4];
    pack_a_frags(dsf, ds);
    mma_p_rows<D>(dq, dsf, sk[cur], lane);           // dq += ds k
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  store_rows<D>(a.dq + batch * a.dqs.b + head * a.dqs.h, a.dqs.n, dq,
             q0 + warp * 16, n, g, t, a.scale, a.scale);
}

template <int D>
int launch(const Grad& a, int batch, cudaStream_t st) {
  const dim3 grid((a.n + kBlock - 1) / kBlock, a.heads, batch);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout: [B, N, H, D] bf16, D in {32, 64}; dq, dk, dv: [B, N, H, D]
// bf16 outputs. Each has its own batch/token/head strides (in elements, last
// stride 1, 16-byte aligned rows), given in `strides` as 21 values: (b, n,
// h) for q, k, v, dout, dq, dk, dv in that order. lse, delta: contiguous
// [B, H, N] f32. Launches the dk/dv kernel and then the dq kernel on
// `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int batch, int n, int heads, int head_dim, const long long* strides,
    float scale, void* stream) {
  if (n <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      strides == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st3 = [&](int i) {
    return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  Grad a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.qs = st3(0);
  a.ks = st3(1);
  a.vs = st3(2);
  a.dos = st3(3);
  a.dqs = st3(4);
  a.dks = st3(5);
  a.dvs = st3(6);
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  const auto st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return launch<64>(a, batch, st);
  }
  if (head_dim == 32) {
    return launch<32>(a, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
