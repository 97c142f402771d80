// Flash-attention backward for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces two TPU kernels of ovmono3d_tpu/ops/attention.py, at head dims 32
// and 64, behind flash_attention_packed_bwd: _flash_bwd_packed_kernel
// (packed [B, N, H*D]) and the head-major _flash_bwd_fused_kernel or its
// split pair _flash_bwd_dq_kernel / _flash_bwd_dkv_kernel ([B*H, N, D]).
// The TPU's tiling needs both layouts; these kernels take any
// batch/token/head strides, so one set serves both.
// From q, k, v (strided views, e.g. of the qkv projection's output
// [B, N, 3, H, D]), the forward's output o and its gradient do, and the
// forward's row log-sum-exp lse ([B, H, N] f32, natural log, written by
// flash_attn_fwd.cu), it rebuilds the probabilities tile by tile,
//     p  = exp(q k^T / sqrt(D) - lse)
// and computes
//     dv = p^T do,   dp = do v^T,   ds = p * (dp - delta),
//     dk = ds^T q / sqrt(D),   dq = ds k / sqrt(D),
// with delta = rowsum(do * o). dq, dk and dv are written with their own
// strides: the wrapper lands them straight in the three slots of one
// [B, N, 3, H, D] gradient of the qkv output, which the qkv projection's
// backward reads with no stack or copy.
//
// What bounds it on this card: tensor-core work. The backward needs
// 10*N^2*D flops per (batch, head) (p rebuilt once, four products); the
// split design here spends 14*N^2*D, because both kernels rebuild
// s = q k^T and the dq kernel recomputes dp. At N = 4097, H = 12 that is
// 129 GFLOP of necessary work per trunk layer and image (0.130 ms at the
// bf16 peak) against O(N*D) bytes of traffic.
//
// Every launch first runs bwd_stats_kernel: delta = rowsum(do * o) from o
// and do in bf16 (f32 products and sum) and lse2 = lse * log2(e), both into
// a [B, H, n_pad] f32 scratch (n_pad = N rounded up to 128) whose rows past
// N hold delta = 0 and lse2 = +inf, so a padded query row has p = 0 and
// ds = 0.
//
// bf16 design at D = 64 (flash_bwd_sm90_kernel, the main path's instances):
// FlashAttention-2's split into a dk/dv and a dq kernel, deterministic and
// free of atomics, each on wgmma and TMA with a producer warpgroup, as
// flash_attn_fwd.cu's forward (the building blocks are sm90_common.cuh's).
// The two kernels are one template: a work unit owns 128 rows ("fixed"
// operands A1 and A2, two consumer warpgroups of 64 rows each) and streams
// 64-row tiles of the other side (B1 and B2) through a ring of 4 stages:
// - dk/dv (kDkDv = true): A1 = K, A2 = V, B1 = Q, B2 = dO, and each stage
//   also brings its 64 queries' lse2 and delta (1-D bulk copies of the
//   padded scratch). s^T = K Q^T takes K from registers (A fragments read
//   once a unit from the TMA tile) and dp^T = V dO^T both operands from
//   shared memory, B K-major; p^T and ds^T are computed in registers on the
//   accumulator layout, rounded to bf16 A fragments, and dV += P^T dO,
//   dK += dS^T Q are wgmma m64n64k16 with A from registers and the same
//   stage read as an MN-major (transposed) B, as the forward's PV reads V.
// - dq (kDkDv = false): A1 = Q, A2 = dO, B1 = K, B2 = V; s = Q K^T,
//   dp = dO V^T, then dQ += dS K. Each thread's two rows' lse2 and delta
//   are read once a unit.
// Warpgroup 0 is the producer (setmaxnreg 40; one thread issues every TMA
// load); warpgroups 1 and 2 consume (232 registers). Each consumer issues
// tile i's two products in one batch with tile i - 1's RS products and
// computes tile i's p and ds while those are in flight; P and dS are packed
// only after the RS products land, so no register of a product in flight is
// written. A stage is released after its RS products, the fixed operands
// after a unit's last product that reads them, so the producer loads the
// next unit during this one's last products and its epilogue. A persistent
// grid of one block an SM walks the units (row tile, head, batch).
// Accumulators are written straight from registers to dq, dk, dv through
// their strides. A1 in registers halves the shared-memory reads of the
// first product (an SS wgmma at N = 64 reads ~136 bytes a cycle, above the
// SM's 128); A2 stays in shared memory, as the dk/dv consumer has no
// registers left for it (measured in PERF.md).
//
// Ragged edges: TMA fills rows past N with zeros. A streamed query row past
// N has p = 0 (lse2 = +inf) and zero q and do, so it adds nothing to dk and
// dv; in the dq kernel keys past N are masked to p = 0 on the last tile, so
// a zero k row adds nothing to dq; rows past N are never stored.
//
// D = 32 (flash_bwd_dkdv_kernel / flash_bwd_dq_kernel, the earlier
// mma.sync design, which ran D = 64 too until the design above replaced
// it): one block of 4 warps per (64-row tile, head, batch); each warp owns 16 rows, keeps
// its fixed rows as A fragments and its accumulators in registers, and
// streams 64-row tiles (double-buffered cp.async) through shared memory.
// All products are mma.sync m16n8k16; the products that contract over rows
// take their B fragments via ldmatrix.trans. p and ds are rounded to bf16
// for the products, as the TPU kernel does.
//
// Not yet: a wgmma design at D = 32, an f32 instance. The fused single pass
// (the TPU's _flash_bwd_fused_kernel, FA3's design: s and dp once, dq
// reduced in f32 across key tiles) was built and measured slower than this
// pair at every trunk shape (PERF.md): the dq reductions and the
// lockstep the shared dS tile imposes on the consumers cost more than the
// saved products.

#include "flash_common.cuh"
#include "sm90_common.cuh"

#include <algorithm>
#include <cmath>

namespace {

using namespace flash;

constexpr int kStatPad = 128;               // n_pad: N rounded up to this

__host__ __device__ inline long long stat_pad(int n) {
  return (static_cast<long long>(n) + kStatPad - 1) / kStatPad * kStatPad;
}

struct Grad {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse2;       // [B, H, n_pad] row stats of bwd_stats_kernel
  const float* delta;
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
  const long long row_bh =
      (static_cast<long long>(batch) * a.heads + head) * stat_pad(n);
  const float* lseb = a.lse2 + row_bh;
  const float* deltab = a.delta + row_bh;
  const int n_tiles = (n + kBlock - 1) / kBlock;

  auto load_rows = [&](int buf, int row0) {
    if (tid < kBlock) {
      const int row = row0 + tid;
      slse[buf][tid] = row < n ? lseb[row] : INFINITY;
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
  const long long row_bh =
      (static_cast<long long>(batch) * a.heads + head) * stat_pad(n);
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
  const float lq0 = r0 < n ? a.lse2[row_bh + r0] : INFINITY;
  const float lq1 = r1 < n ? a.lse2[row_bh + r1] : INFINITY;
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
int launch_mma(const Grad& a, int batch, cudaStream_t st) {
  const dim3 grid((a.n + kBlock - 1) / kBlock, a.heads, batch);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- delta = rowsum(do * o) and lse2 = lse * log2(e), padded ----

constexpr int kStatThreads = 256;

// One row (b, h, token) per D / 8 threads, each taking 16 bytes of o and do;
// rows enumerated in [B, H, n_pad] order, so the writes are contiguous.
template <int D>
__global__ void __launch_bounds__(kStatThreads)
    bwd_stats_kernel(const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     float* __restrict__ lse2, int n, long long n_pad,
                     int heads, long long rows, Strides os, Strides dos) {
  constexpr int kLanes = D / 8;
  static_assert(32 % kLanes == 0, "a row's threads share a warp");
  const long long idx =
      static_cast<long long>(blockIdx.x) * kStatThreads + threadIdx.x;
  const long long r = idx / kLanes;
  const int c = static_cast<int>(idx % kLanes) * 8;
  long long bh = 0;
  long long token = 0;
  float sum = 0.f;
  if (r < rows) {
    bh = r / n_pad;
    token = r % n_pad;
    if (token < n) {
      const long long b = bh / heads;
      const long long h = bh % heads;
      const uint4 ov = *reinterpret_cast<const uint4*>(
          o + b * os.b + token * os.n + h * os.h + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(
          dout + b * dos.b + token * dos.n + h * dos.h + c);
      const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(o2[i]);
        const float2 y = __bfloat1622float2(d2[i]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (r < rows && c == 0) {
    const bool valid = token < n;
    delta[r] = valid ? sum : 0.f;
    lse2[r] = valid ? lse[bh * n + token] * kLog2e : INFINITY;
  }
}

template <int D>
int launch_stats(const void* o, const void* dout, const void* lse,
                 float* scratch, int batch, int n, int heads,
                 const Strides& os, const Strides& dos, cudaStream_t st) {
  const long long n_pad = stat_pad(n);
  const long long rows = static_cast<long long>(batch) * heads * n_pad;
  const long long threads = rows * (D / 8);
  const long long blocks = (threads + kStatThreads - 1) / kStatThreads;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bwd_stats_kernel<D><<<static_cast<int>(blocks), kStatThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      scratch, scratch + rows, n, n_pad, heads, rows, os, dos);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 D = 64 instances: wgmma, TMA and a producer warpgroup ----

namespace hopper {

using sm90::ex2;

constexpr int kD = 64;
constexpr int kRows = 64;                   // a box, a consumer's rows, a stage
constexpr int kConsumers = 2;               // warpgroups of 64 fixed rows
constexpr int kUnitRows = kRows * kConsumers;
constexpr int kStages = 4;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBoxBytes = kRows * kD * 2;   // one 64 x 64 bf16 box
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// setmaxnreg.inc waits until the registers it asks for are free, so the
// warpgroups' new counts must fit the block's launch allocation (168 a
// thread under __launch_bounds__(384, 1)), or the consumers never start.
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 168 * kThreads,
              "register reallocation beyond the launch allocation");
constexpr uint32_t kStageStep = kBoxBytes >> 4;    // in descriptor units
constexpr uint32_t kRowStep = 16 * 128 >> 4;       // 16 swizzled rows
static_assert(kD * 2 == 128, "a row is one 128-byte swizzle line");
static_assert(kUnitRows == kStatPad, "a unit's rows lie inside n_pad");

// Every tile is a multiple of 8 KB, so each stays 1024-byte aligned (the
// swizzle atom) when the struct is.
struct Smem {
  __nv_bfloat16 a1[kUnitRows * kD];         // K (dk/dv) or Q (dq)
  __nv_bfloat16 a2[kUnitRows * kD];         // V or dO
  __nv_bfloat16 b1[kStages][kRows * kD];    // Q or K
  __nv_bfloat16 b2[kStages][kRows * kD];    // dO or V
  float lse2[kStages][kRows];               // dk/dv: the stage's queries'
  float delta[kStages][kRows];
  uint64_t fixed_full;
  uint64_t fixed_empty;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;

struct Args {
  int batch, n, heads;
  long long n_pad;
  const float* delta;                       // [B, H, n_pad]
  const float* lse2;
  __nv_bfloat16* out_ds;                    // dk (dk/dv) or dq
  __nv_bfloat16* out_p;                     // dv (dk/dv only)
  Strides ds_st, p_st;
  float scale, scale_log2;
};

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sm90::fence_operands(f[i]);
  }
}

// The products' shared-memory descriptors are made at each wgmma from a
// base plus constants (measured no slower than pinning each descriptor in a
// register beforehand, and ptxas serialises nothing).

// This warp's 16 rows of a 64 x 64 bf16 tile laid out by TMA with the
// 128-byte swizzle (16-byte chunk k of row r at k ^ (r % 8)) as A fragments:
// f[kk] covers columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void load_frags(const __nv_bfloat16* tile,
                                           int warp, int lane,
                                           uint32_t (&f)[4][4]) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
  const int r0 = 16 * warp + (lane >> 2);
  const int r1 = r0 + 8;
  const int off = 4 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = *reinterpret_cast<const uint32_t*>(
        base + r0 * 128 + (((2 * kk) ^ (r0 & 7)) << 4) + off);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(
        base + r1 * 128 + (((2 * kk) ^ (r1 & 7)) << 4) + off);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(
        base + r0 * 128 + (((2 * kk + 1) ^ (r0 & 7)) << 4) + off);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(
        base + r1 * 128 + (((2 * kk + 1) ^ (r1 & 7)) << 4) + off);
  }
}

// x = F B^T over D: F this consumer's 64 fixed rows of A1 as A fragments in
// registers, B a stage's 64 rows, K-major (a k-step moves 32 bytes along
// the swizzled 128-byte rows). x is overwritten.
__device__ __forceinline__ void first(float (&x)[32],
                                      const uint32_t (&f)[4][4],
                                      uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    sm90::wgmma_m64n64k16_rs_kmajor(x, f[kk], desc_b + 2 * kk, kk);
  }
}

// x = A B^T over D: A this consumer's 64 fixed rows of A2 in shared memory,
// both K-major. x is overwritten.
__device__ __forceinline__ void ss(float (&x)[32], uint64_t desc_a,
                                   uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    sm90::wgmma_m64n64k16_ss(x, desc_a + 2 * kk, desc_b + 2 * kk, kk);
  }
}

// acc += F B over a stage's 64 rows: F 64 x 64 bf16 A fragments from
// registers, B the stage read MN-major (a k-step of 16 rows is 2048 bytes).
__device__ __forceinline__ void rs(float (&acc)[32], const uint32_t (&f)[4][4],
                                   uint64_t desc_bt) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    sm90::wgmma_m64n64k16_rs(acc, f[kk], desc_bt + kk * kRowStep, 1);
  }
}

// An f32 accumulator tile (64 columns) rounded to bf16 A fragments:
// f[kk] covers columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      f[kk][2 * half] = pack_bf16(x[4 * j], x[4 * j + 1]);          // row g
      f[kk][2 * half + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);  // g + 8
    }
  }
}

// dk/dv: s^T -> p^T in x1 and dp^T -> ds^T in x2, the stats per column
// (query 8j + 2t + e of the stage, from shared memory).
__device__ __forceinline__ void elementwise_cols(float (&x1)[32],
                                                 float (&x2)[32],
                                                 const float* lse2,
                                                 const float* delta, int t,
                                                 float scale_log2) {
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
    x1[4 * j] = ex2(fmaf(x1[4 * j], scale_log2, -l.x));
    x1[4 * j + 1] = ex2(fmaf(x1[4 * j + 1], scale_log2, -l.y));
    x1[4 * j + 2] = ex2(fmaf(x1[4 * j + 2], scale_log2, -l.x));
    x1[4 * j + 3] = ex2(fmaf(x1[4 * j + 3], scale_log2, -l.y));
    x2[4 * j] = x1[4 * j] * (x2[4 * j] - d.x);
    x2[4 * j + 1] = x1[4 * j + 1] * (x2[4 * j + 1] - d.y);
    x2[4 * j + 2] = x1[4 * j + 2] * (x2[4 * j + 2] - d.x);
    x2[4 * j + 3] = x1[4 * j + 3] * (x2[4 * j + 3] - d.y);
  }
}

// dq: s -> p in x1 and dp -> ds in x2, the stats per row (g and g + 8);
// keys at or past `valid` get p = 0.
__device__ __forceinline__ void elementwise_rows(float (&x1)[32],
                                                 float (&x2)[32], int valid,
                                                 int t, float l0, float l1,
                                                 float d0, float d1,
                                                 float scale_log2) {
  if (valid < kRows) {
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * t + e >= valid) {
          x1[4 * j + e] = -INFINITY;
          x1[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x1[4 * j + e] = ex2(fmaf(x1[4 * j + e], scale_log2, -l0));
      x1[4 * j + 2 + e] = ex2(fmaf(x1[4 * j + 2 + e], scale_log2, -l1));
      x2[4 * j + e] = x1[4 * j + e] * (x2[4 * j + e] - d0);
      x2[4 * j + 2 + e] = x1[4 * j + 2 + e] * (x2[4 * j + 2 + e] - d1);
    }
  }
}

// The elementwise pass of stage `s`, holding streamed tile `it`.
template <bool kDkDv>
__device__ __forceinline__ void elementwise(const Smem& sm, const Args& a,
                                            float (&x1)[32], float (&x2)[32],
                                            int s, int it, int t, float l0,
                                            float l1, float d0, float d1) {
  if constexpr (kDkDv) {
    elementwise_cols(x1, x2, sm.lse2[s], sm.delta[s], t, a.scale_log2);
  } else {
    elementwise_rows(x1, x2, a.n - it * kRows, t, l0, l1, d0, d1,
                     a.scale_log2);
  }
}

// Rows r0 and r0 + 8 of this thread (skipping rows at or past n) of one
// accumulator, times `scale`, as bf16 through the view's strides.
__device__ __forceinline__ void store(__nv_bfloat16* base, const Strides& st,
                                      int batch, int head, int r0, int n,
                                      int t, const float (&acc)[32],
                                      float scale) {
  __nv_bfloat16* p = base + batch * st.b + head * st.h;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(p + r0 * st.n + col) =
          pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(p + r1 * st.n + col) =
          pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// One consumer warpgroup: 64 fixed rows of each of the block's work units
// against every stage. The ring's position `c` runs on across units.
template <bool kDkDv>
__device__ __forceinline__ void consume(Smem& sm, const Args& a, int tiles,
                                        int units) {
  const int ctid = threadIdx.x - 128;
  const int cw = ctid / 128;                // fixed rows 64 cw .. 64 cw + 63
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int t = lane & 3;
  const int n = a.n;
  const int n_tiles = (n + kRows - 1) / kRows;

  const uint64_t desc_a2 = sm90::desc_sw128(sm.a2 + cw * kRows * kD, 16, 1024);
  const uint64_t desc_b1 = sm90::desc_sw128(sm.b1[0], 16, 1024);
  const uint64_t desc_b2 = sm90::desc_sw128(sm.b2[0], 16, 1024);
  const uint64_t desc_b1t = sm90::desc_sw128(sm.b1[0], kBoxBytes, 1024);
  const uint64_t desc_b2t = sm90::desc_sw128(sm.b2[0], kBoxBytes, 1024);

  uint32_t fa1[4][4];                       // A1's rows (K or Q)
  float x1[32];                             // s (s^T), then p
  float x2[32];                             // dp (dp^T), then ds
  uint32_t fp[4][4];                        // P^T as A fragments (dk/dv)
  uint32_t fds[4][4];                       // dS^T (dk/dv) or dS (dq)

  int c = 0;                                // stages consumed so far
  int i = 0;                                // units done
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int row0 = (u % tiles) * kUnitRows;
    const int head = (u / tiles) % a.heads;
    const int batch = u / (tiles * a.heads);
    const int r0 = row0 + cw * kRows + warp * 16 + (lane >> 2);
    float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
    if constexpr (!kDkDv) {
      // r0 + 8 < n_pad: a unit's rows lie inside the padded stats.
      const long long stat =
          (static_cast<long long>(batch) * a.heads + head) * a.n_pad;
      l0 = a.lse2[stat + r0];
      l1 = a.lse2[stat + r0 + 8];
      d0 = a.delta[stat + r0];
      d1 = a.delta[stat + r0 + 8];
    }
    float acc_ds[32];                       // dK or dQ
    float acc_p[32];                        // dV (dk/dv)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc_ds[j] = 0.f;
      acc_p[j] = 0.f;
    }

    sm90::mbar_wait(&sm.fixed_full, i & 1);
    load_frags(sm.a1 + cw * kRows * kD, warp, lane, fa1);
    fence_frags(fa1);

    // Tile 0: its two products and its elementwise pass.
    {
      const int s0 = c % kStages;
      sm90::mbar_wait(&sm.full[s0], (c / kStages) & 1);
      sm90::fence_operands(x1);
      sm90::fence_operands(x2);
      sm90::wgmma_fence();
      first(x1, fa1, desc_b1 + s0 * kStageStep);
      ss(x2, desc_a2, desc_b2 + s0 * kStageStep);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(x1);
      sm90::fence_operands(x2);
      if (lane == 0 && n_tiles == 1) {
        sm90::mbar_arrive(&sm.fixed_empty); // this warp is done with A1, A2
      }
      elementwise<kDkDv>(sm, a, x1, x2, s0, 0, t, l0, l1, d0, d1);
      if constexpr (kDkDv) {
        pack(x1, fp);
      }
      pack(x2, fds);
    }
    // Tile it's two products go out with tile it - 1's RS products; tile
    // it's elementwise pass runs while those are in flight.
    for (int it = 1; it < n_tiles; ++it) {
      const int g = c + it;
      const int s = g % kStages;
      const int sp = (g - 1) % kStages;
      sm90::mbar_wait(&sm.full[s], (g / kStages) & 1);
      sm90::fence_operands(x1);
      sm90::fence_operands(x2);
      sm90::fence_operands(acc_ds);
      fence_frags(fds);
      if constexpr (kDkDv) {
        sm90::fence_operands(acc_p);
        fence_frags(fp);
      }
      sm90::wgmma_fence();
      first(x1, fa1, desc_b1 + s * kStageStep);
      ss(x2, desc_a2, desc_b2 + s * kStageStep);
      sm90::wgmma_commit();
      rs(acc_ds, fds, desc_b1t + sp * kStageStep);  // dK += dS^T Q, dQ += dS K
      if constexpr (kDkDv) {
        rs(acc_p, fp, desc_b2t + sp * kStageStep);  // dV += P^T dO
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();                // tile it landed, RS in flight
      sm90::fence_operands(x1);
      sm90::fence_operands(x2);
      if (lane == 0 && it == n_tiles - 1) {
        sm90::mbar_arrive(&sm.fixed_empty);
      }
      elementwise<kDkDv>(sm, a, x1, x2, s, it, t, l0, l1, d0, d1);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc_ds);
      fence_frags(fds);
      if constexpr (kDkDv) {
        sm90::fence_operands(acc_p);
        fence_frags(fp);
      }
      if (lane == 0) {
        sm90::mbar_arrive(&sm.empty[sp]);   // this warp is done with stage sp
      }
      if constexpr (kDkDv) {
        pack(x1, fp);
      }
      pack(x2, fds);
    }
    // The last tile's RS products.
    {
      const int sl = (c + n_tiles - 1) % kStages;
      sm90::fence_operands(acc_ds);
      fence_frags(fds);
      if constexpr (kDkDv) {
        sm90::fence_operands(acc_p);
        fence_frags(fp);
      }
      sm90::wgmma_fence();
      rs(acc_ds, fds, desc_b1t + sl * kStageStep);
      if constexpr (kDkDv) {
        rs(acc_p, fp, desc_b2t + sl * kStageStep);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc_ds);
      if constexpr (kDkDv) {
        sm90::fence_operands(acc_p);
      }
      if (lane == 0) {
        sm90::mbar_arrive(&sm.empty[sl]);
      }
    }
    c += n_tiles;

    store(a.out_ds, a.ds_st, batch, head, r0, n, t, acc_ds, a.scale);
    if constexpr (kDkDv) {
      store(a.out_p, a.p_st, batch, head, r0, n, t, acc_p, 1.f);
    }
  }
}

// A persistent grid: block b takes the work units b, b + gridDim.x, ...
// (unit = row tile + tiles * (head + heads * batch), so the blocks in
// flight share a few heads' streamed tiles in L2).
template <bool kDkDv>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_a1,
                          const __grid_constant__ CUtensorMap tm_a2,
                          const __grid_constant__ CUtensorMap tm_b1,
                          const __grid_constant__ CUtensorMap tm_b2,
                          const sm90::MapDims m_a1, const sm90::MapDims m_a2,
                          const sm90::MapDims m_b1, const sm90::MapDims m_b2,
                          const Args a) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int tiles = (a.n + kUnitRows - 1) / kUnitRows;
  const int units = tiles * a.heads * a.batch;
  const int n_tiles = (a.n + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.fixed_full, 1);
    sm90::mbar_init(&sm.fixed_empty, kConsumers * 4);    // one per warp
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer warpgroup: one thread keeps the stages' loads in flight.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_a1);
      sm90::prefetch_tensormap(&tm_a2);
      sm90::prefetch_tensormap(&tm_b1);
      sm90::prefetch_tensormap(&tm_b2);
      constexpr uint32_t kStageBytes =
          2 * kBoxBytes + (kDkDv ? 2 * kRows * 4 : 0);
      int c = 0;                            // stages loaded so far
      int i = 0;                            // units started
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        const int row0 = (u % tiles) * kUnitRows;
        const int head = (u / tiles) % a.heads;
        const int b = u / (tiles * a.heads);
        // A fresh barrier passes a wait at parity 1: the first unit's
        // fixed rows and the first round of stages go in at once.
        sm90::mbar_wait(&sm.fixed_empty, (i & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.fixed_full, 4 * kBoxBytes);
#pragma unroll
        for (int h = 0; h < kConsumers; ++h) {
          sm90::load_box(sm.a1 + h * kRows * kD, &tm_a1, m_a1,
                         &sm.fixed_full, head, row0 + h * kRows, b);
          sm90::load_box(sm.a2 + h * kRows * kD, &tm_a2, m_a2,
                         &sm.fixed_full, head, row0 + h * kRows, b);
        }
        const long long stat =
            (static_cast<long long>(b) * a.heads + head) * a.n_pad;
        for (int it = 0; it < n_tiles; ++it, ++c) {
          const int s = c % kStages;
          sm90::mbar_wait(&sm.empty[s], ((c / kStages) & 1) ^ 1);
          sm90::mbar_expect_tx(&sm.full[s], kStageBytes);
          sm90::load_box(sm.b1[s], &tm_b1, m_b1, &sm.full[s], head,
                         it * kRows, b);
          sm90::load_box(sm.b2[s], &tm_b2, m_b2, &sm.full[s], head,
                         it * kRows, b);
          if constexpr (kDkDv) {
            sm90::bulk_load(sm.lse2[s], a.lse2 + stat + it * kRows,
                            kRows * 4, &sm.full[s]);
            sm90::bulk_load(sm.delta[s], a.delta + stat + it * kRows,
                            kRows * 4, &sm.full[s]);
          }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume<kDkDv>(sm, a, tiles, units);
  }
}

// The four maps of one kernel: A1, A2 (fixed) and B1, B2 (streamed).
struct Maps {
  CUtensorMap tm[4];
  sm90::MapDims md[4];
};

int encode(Maps& m, const void* const (&ptr)[4], const Strides (&st)[4],
           int batch, int n, int heads) {
  for (int i = 0; i < 4; ++i) {
    const int rc = sm90::encode_view_d64(&m.tm[i], &m.md[i], ptr[i], batch,
                                         n, heads, st[i].b, st[i].n, st[i].h,
                                         kRows);
    if (rc != 0) {
      return rc;
    }
  }
  return 0;
}

template <bool kDkDv>
int launch_one(const Maps& m, const Args& a, int grid, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel<kDkDv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  flash_bwd_sm90_kernel<kDkDv><<<grid, kThreads, kSmemBytes, st>>>(
      m.tm[0], m.tm[1], m.tm[2], m.tm[3], m.md[0], m.md[1], m.md[2], m.md[3],
      a);
  return static_cast<int>(cudaGetLastError());
}

// Encodes all eight tensor maps first, then launches the stats pass, the
// dk/dv kernel and the dq kernel.
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, float* scratch, void* dq,
           void* dk, void* dv, int batch, int n, int heads,
           const Strides (&st)[8], float scale, cudaStream_t stream) {
  // st: q, k, v, o, dout, dq, dk, dv.
  Maps kv, qd;
  int rc = encode(kv, {k, v, q, dout}, {st[1], st[2], st[0], st[4]}, batch,
                  n, heads);
  if (rc == 0) {
    rc = encode(qd, {q, dout, k, v}, {st[0], st[4], st[1], st[2]}, batch, n,
                heads);
  }
  if (rc != 0) {
    return rc;
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const long long units =
      static_cast<long long>((n + kUnitRows - 1) / kUnitRows) * heads * batch;
  if (units > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(std::min<long long>(units, sms));
  Args a;
  a.batch = batch;
  a.n = n;
  a.heads = heads;
  a.n_pad = stat_pad(n);
  const long long rows = static_cast<long long>(batch) * heads * a.n_pad;
  a.delta = scratch;
  a.lse2 = scratch + rows;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.out_ds = static_cast<__nv_bfloat16*>(dk);
  a.out_p = static_cast<__nv_bfloat16*>(dv);
  a.ds_st = st[6];
  a.p_st = st[7];
  rc = launch_stats<kD>(o, dout, lse, scratch, batch, n, heads, st[3], st[4],
                        stream);
  if (rc == 0) {
    rc = launch_one<true>(kv, a, grid, stream);
  }
  if (rc != 0) {
    return rc;
  }
  a.out_ds = static_cast<__nv_bfloat16*>(dq);
  a.out_p = nullptr;
  a.ds_st = st[5];
  return launch_one<false>(qd, a, grid, stream);
}

}  // namespace hopper

bool valid_shape(int batch, int n, int heads) {
  return n > 0 && batch > 0 && heads > 0 && batch <= 65535 && heads <= 65535;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// The stats pass, then the mma.sync pair at head dim D; arguments as
// flash_attn_bwd_bf16's, st: q, k, v, o, dout, dq, dk, dv.
template <int D>
int launch_mma_path(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    float* stats, void* dq, void* dk, void* dv, int batch,
                    int n, int heads, const Strides (&st)[8], float scale,
                    cudaStream_t s) {
  const int rc = launch_stats<D>(o, dout, lse, stats, batch, n, heads, st[3],
                                 st[4], s);
  if (rc != 0) {
    return rc;
  }
  Grad a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.delta = stats;
  a.lse2 = stats + static_cast<long long>(batch) * heads * stat_pad(n);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.qs = st[0];
  a.ks = st[1];
  a.vs = st[2];
  a.dos = st[4];
  a.dqs = st[5];
  a.dks = st[6];
  a.dvs = st[7];
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return launch_mma<D>(a, batch, s);
}

}  // namespace

// The f32 scratch flash_attn_bwd_bf16 and flash_attn_bwd_stats_bf16 take: delta then lse2, each [B, H, n_pad],
// n_pad = N rounded up to 128.
extern "C" long long flash_attn_bwd_scratch_floats(int batch, int n,
                                                   int heads) {
  return 2 * static_cast<long long>(batch) * heads * stat_pad(n);
}

// q, k, v, o, dout: [B, N, H, D] bf16, D in {32, 64}; dq, dk, dv: [B, N, H, D]
// bf16 outputs. Each has its own batch/token/head strides (in elements,
// last stride 1, 16-byte aligned pointer and rows), given in `strides` as 24
// values: (b, n, h) for q, k, v, o, dout, dq, dk, dv in that order. lse:
// contiguous [B, H, N] f32, natural log. scratch: flash_attn_bwd_scratch_floats
// f32, overwritten. Launches bwd_stats_kernel, then the dk/dv kernel and
// the dq kernel, on `stream` (D = 64: the wgmma + TMA design; D = 32: the
// mma.sync one). Returns cudaGetLastError(), the driver's code if a tensor
// map cannot be encoded, or cudaErrorInvalidValue for a shape it does not
// take.
extern "C" int flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int batch, int n, int heads, int head_dim,
    const long long* strides, float scale, void* stream) {
  if (!valid_shape(batch, n, heads) || strides == nullptr ||
      (head_dim != 32 && head_dim != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = strides_at(strides, i);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* stats = static_cast<float*>(scratch);
  if (head_dim == 64) {
    return hopper::launch(q, k, v, o, dout, lse, stats, dq, dk, dv, batch, n,
                          heads, st, scale, s);
  }
  return launch_mma_path<32>(q, k, v, o, dout, lse, stats, dq, dk, dv, batch,
                             n, heads, st, scale, s);
}

// bwd_stats_kernel alone, with flash_attn_bwd_bf16's arguments for o, dout,
// lse and scratch (strides: (b, n, h) for o, then dout): lets a test hold
// the stats to their plain version.
extern "C" int flash_attn_bwd_stats_bf16(const void* o, const void* dout,
                                         const void* lse, void* scratch,
                                         int batch, int n, int heads,
                                         int head_dim,
                                         const long long* strides,
                                         void* stream) {
  if (!valid_shape(batch, n, heads) || strides == nullptr ||
      (head_dim != 32 && head_dim != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* stats = static_cast<float*>(scratch);
  const Strides os = strides_at(strides, 0), dos = strides_at(strides, 1);
  return head_dim == 64 ? launch_stats<64>(o, dout, lse, stats, batch, n,
                                           heads, os, dos, s)
                        : launch_stats<32>(o, dout, lse, stats, batch, n,
                                           heads, os, dos, s);
}
