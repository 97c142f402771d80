// Flash-attention forward for Hopper (sm_90a): a bf16 instance (bf16 in and
// out, f32 softmax, an optional row log-sum-exp output for the backward) and
// an f32 instance (f32 in and out, f32 products), each at head dims 32 and 64.
//
// Replaces five TPU kernels of ovmono3d_tpu/ops/attention.py. The TPU needs a
// packed and a head-major variant of each because its (8, 128) tiling fixes
// the layout a kernel can read; these kernels take any batch/token/head
// strides, so one kernel serves both layouts, packed [B, N, H*D] and
// head-major [B*H, N, D] alike, through the same wrappers:
// - _flash_kernel_packed and _flash_kernel_single / _flash_kernel, behind
//   flash_attention_packed (inference): the bf16 launch without an lse
//   pointer, or the f32 launch;
// - _flash_kernel_packed_lse and _flash_kernel_single_lse, behind
//   flash_attention_packed_lse (training): the bf16 launch with an lse
//   pointer, a second instance of the kernel template, so the inference
//   instance carries no lse code at all.
//
// It computes
//     out = softmax(q k^T / sqrt(D)) v        for every (batch, head),
//     lse = log(sum_j exp(q k_j / sqrt(D)))   (natural log, [B, H, N] f32)
// reading q, k and v as strided views (the qkv projection's [B, N, 3, H, D]
// output has token stride 3*H*D) and writing a contiguous [B, N, H*D] that
// the output projection reads as it is. lse is stored in NATURAL-log units,
// unclamped: the TPU kernels' lse is log2 of the denominator of a softmax
// shifted by their clamp C = 50, so lse_ln = lse2 * ln 2 + C; their
// [b, h/g, g, n] and [b*h, 1, n_q] layouts are TPU tiling constraints and
// are not carried over.
//
// What bounds it on this card: the QK^T and PV products, 4*N^2*D flops per
// (batch, head) -- 51.6 GFLOP per ViT-B/14 trunk layer at N = 4097, H = 12,
// 0.052 ms at the bf16 tensor-core peak (989 TFLOP/s) -- against O(N*D)
// bytes of q/k/v/out traffic. The N x N logits never leave the SM. At
// D = 64 the softmax is as costly as the products: a 64 x 128 logit tile
// takes 1 MFLOP of QK^T and 1 of PV, about 512 tensor-core cycles of an SM,
// and 8192 exponentials, 512 cycles of the SM's 16 exp units, besides the
// scale, max, sum and conversion on the FP32 pipes. So the products have to
// run asynchronously beside the softmax of another tile, and the loads
// beside both. The f32 instance runs on the FP32 pipes (67 TFLOP/s), since
// single-pass TF32 products would keep 10 mantissa bits.
//
// bf16 design at D = 64 (flash_fwd_sm90_kernel, the main path's instances):
// a persistent grid of one block of three warpgroups an SM (384 threads at
// 168 registers and 115.8 KB of shared memory leave no room for a second),
// each block looping over work units of (128-row q tile, head, batch).
// Warpgroup 0 is the producer: it gives its registers to the others
// (setmaxnreg: 40 for it, 232 for each consumer thread) and one of its
// threads issues every TMA load. Warpgroups 1 and 2 are consumers of 64 q
// rows each. Q is loaded once a unit and released after the unit's last
// QK^T, so the next unit's loads overlap this one's last PV and its
// epilogue. K and V stream through a ring of three 128-key stages, K and V
// each with a full and an empty mbarrier, so a stage's K is refilled as
// soon as both consumers' QK^T products have read it, before their PV. The
// loads use one 4-D tensor map per operand over the caller's view (dims D,
// then H, N and B by ascending stride), a 64 x 128-row box and the 128-byte
// swizzle; rows past N arrive as zeros (TMA's out-of-bounds fill). S = Q K^T
// is wgmma m64n128k16 with both operands in shared memory; the softmax runs
// in registers on S's accumulator layout; P is rounded to bf16 in registers
// in wgmma's A-fragment layout and O += P V is wgmma m64n64k16 with V read
// as an MN-major (transposed) operand. Each consumer issues tile i's QK^T
// with tile i - 1's PV and runs tile i's softmax while that PV is in
// flight; the two consumers run unsynchronised, so one's softmax overlaps
// the other's products on the SM's tensor cores. Rows are written straight
// from the O registers, scaled by 1/l.
//
// bf16 design at D = 32 (flash_fwd_kernel, the earlier mma.sync design,
// which ran D = 64 too until the design above replaced it): one block of 4
// warps per (64-row q tile, head, batch); each warp owns 16 q rows and
// keeps its 16 x 64 logit tile in registers, turns it into bf16
// probabilities in place and feeds them back into the PV product without a
// trip through shared memory. K and V stream through shared memory in
// 64-key tiles, double-buffered with cp.async. Both products are mma.sync
// m16n8k16 (bf16 inputs, f32 accumulators); V's fragments come from
// ldmatrix.trans. Shared-memory rows are padded by 16 bytes so the fragment
// loads are free of bank conflicts.
//
// f32 design (flash_fwd_f32_kernel): FFMA, exact f32 products as the JAX
// kernel's f32 dots are (3xTF32 on the tensor cores would round each operand
// to 11-bit pieces: another result). The FP32 pipes bound it (67 TFLOP/s:
// 0.712 ms at Depth-Pro's [35, 577, 16, 64]), so the design keeps shared
// memory below them: a block of 64 q rows and 64 keys a tile, each thread
// an 8 x 4 tile of S (rows 8ty + i, keys tx + 16j) and the same 8 rows x
// D/16 columns of O, so each Q (or P) float read from shared memory feeds
// 4 FMAs and each K (or V) float 8, and a warp's two half-warps read their
// Q and P rows from disjoint banks.
// P goes through shared memory, written and read by the same warp; P stays
// f32 for PV, as the JAX kernel casts p to the input dtype. K and V have
// one buffer each, refilled by cp.async as soon as every warp is done with
// it, so V's copies overlap QK^T and K's the previous tile's PV; ~70 KB of
// shared memory at D = 64, three blocks an SM. On ragged edges
// (N = 577 = 9 * 64 + 1) warps whose rows all lie past N skip the products
// and the last key tile multiplies only the keys below N. (Measured and
// dropped: two K/V stages at two blocks an SM, an 8 x 8 thread tile over
// 128-row blocks, 32-row blocks for grids under two blocks an SM; PERF.md.)
//
// Softmax: the standard online softmax with a running row max, in base 2
// (log2(e) folded into the scale). It is exact for any logit range; the TPU
// kernels' clamped single pass is exact only inside its window. P is rounded
// to bf16 against the running max before PV, as the JAX kernel casts p to
// the input dtype; the row sum l adds the unrounded f32 values.
//
// Ragged edges (N = 4097 = 32*128 + 1): rows past N load as zeros (TMA's
// out-of-bounds fill, cp.async's zero fill in the mma.sync design), keys
// past N are set to -inf before the row max (on the last tile only), and q
// rows past N are not written.
//
// Not yet: TMA multicast of K/V across a cluster, a third consumer
// warpgroup (192-row q tiles, half the L2 traffic of K and V a row), part
// of the exponentials on the FMA pipes; a wgmma design at D = 32.

#include "flash_common.cuh"
#include "sm90_common.cuh"

#include <algorithm>
#include <cmath>

namespace {

using namespace flash;

template <int D, bool kWriteLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int n, int heads,
                     Strides qs, Strides ks, Strides vs, float scale_log2) {
  constexpr int kTile = Tile<D>::kElems;
  __shared__ __align__(16) __nv_bfloat16 sq[kTile];
  __shared__ __align__(16) __nv_bfloat16 sk[2][kTile];
  __shared__ __align__(16) __nv_bfloat16 sv[2][kTile];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;          // fragment row group
  const int t = lane & 3;           // thread in group
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  const int n_tiles = (n + kBlock - 1) / kBlock;

  load_tile<D>(sq, qb, qs.n, q0, n, tid);
  load_tile<D>(sk[0], kb, ks.n, 0, n, tid);
  load_tile<D>(sv[0], vb, vs.n, 0, n, tid);
  cp_async_commit();

  uint32_t qf[D / 16][4];                   // this warp's Q as A fragments
  float o[D / 8][4] = {};                   // O accumulators, 16 x D
  float m[2] = {-INFINITY, -INFINITY};      // running row max (rows g, g+8)
  float l[2] = {0.f, 0.f};                  // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(sk[cur ^ 1], kb, ks.n, (it + 1) * kBlock, n, tid);
      load_tile<D>(sv[cur ^ 1], vb, vs.n, (it + 1) * kBlock, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
      load_a_frags<D>(qf, sq, warp, g, t);
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlock / 8][4] = {};
    mma_a_rowsT<D>(s, qf, sk[cur], g, t);

    // Scale into base 2, mask keys past n, take the new row max.
    const int key0 = it * kBlock;
    float mx0 = m[0];
    float mx1 = m[1];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = key0 + j * 8 + 2 * t + e < n;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile holds at least one key < n, so mx0/mx1 are finite here and
    // exp2f(-inf - mx) = 0 on the first tile.
    const float alpha0 = exp2f(m[0] - mx0);
    const float alpha1 = exp2f(m[1] - mx1);
    m[0] = mx0;
    m[1] = mx1;

    // P = exp2(S - max), packed straight into bf16 A fragments for PV.
    float rs0 = 0.f;
    float rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    uint32_t pf[kBlock / 16][4];
    pack_a_frags(pf, s);
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }

    // O += P V.
    mma_p_rows<D>(o, pf, sv[cur], lane);
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  // Row sums live split over the 4 threads of each row group.
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 1);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 2);

  const long long row_elems = static_cast<long long>(heads) * D;
  __nv_bfloat16* ob = out + static_cast<long long>(batch) * n * row_elems +
                      head * D;
  const int row0 = q0 + warp * 16;
  store_rows<D>(ob, row_elems, o, row0, n, g, t, 1.f / l[0], 1.f / l[1]);

  if constexpr (kWriteLse) {
    // log(sum_j exp(s_j)) = ln2 * (m + log2(l)), m and s in base-2 units.
    float* lb = lse + (static_cast<long long>(batch) * heads + head) * n;
    if (t == 0 && row0 + g < n) {
      lb[row0 + g] = (m[0] + log2f(l[0])) * kLn2;
    }
    if (t == 0 && row0 + g + 8 < n) {
      lb[row0 + g + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
  }
}

// ---- the f32 instance ----

namespace f32 {

constexpr int kKeys = 64;                   // keys a K/V stage
constexpr int kPStride = kKeys + 4;         // P rows, in floats
// Q's and P's 8-row groups start 16 floats past a multiple of 32: the two
// half-warps of a warp read rows of two groups, which then fall in
// disjoint banks (8 padded rows alone span a multiple of 32 floats).
constexpr int kGroupPad = 16;

// A block of 64 q rows: 8 row groups of 16 threads.
constexpr int kRows = 64;
constexpr int kThreads = kRows / 8 * 16;

template <int D>
struct Cfg {
  static constexpr int kStride = D + 4;     // floats; 16-byte rows
  static constexpr int kCols = D / 16;      // O columns a thread owns
  static constexpr int kQGroup = 8 * kStride + kGroupPad;
  static constexpr int kPGroup = 8 * kPStride + kGroupPad;
  static constexpr int kQ = kRows / 8 * kQGroup;
  static constexpr int kKV = kKeys * kStride;
  static constexpr int kSmemBytes =
      (kQ + 2 * kKV + kRows / 8 * kPGroup) * static_cast<int>(sizeof(float));
};

// Copy rows [row0, row0 + kN) of one head (row stride `row_stride` floats)
// into a padded smem tile (rows of D + 4 floats, kPad more after every 8),
// 4 floats a cp.async; rows at or past n arrive as zeros.
template <int D, int kN, int kThreadsT, int kPad>
__device__ __forceinline__ void load_rows(float* smem, const float* base,
                                          long long row_stride, int row0,
                                          int n, int tid) {
  constexpr int kChunks = D / 4;
  static_assert(kN * kChunks % kThreadsT == 0, "tile loads must divide");
#pragma unroll
  for (int i = 0; i < kN * kChunks / kThreadsT; ++i) {
    const int idx = tid + i * kThreadsT;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int row = row0 + r;
    const bool valid = row < n;
    const float* src =
        base + (valid ? static_cast<long long>(row) * row_stride + c : 0);
    cp_async_16(smem + r * (D + 4) + r / 8 * kPad + c, src, valid);
  }
}

// S = Q K^T for the thread's rows 8ty + i and keys tx + 16j, j < kJ (the
// last key tile computes only the key groups that hold a key below N).
// Every 4-wide d step reads 8 + kJ float4 for 32 kJ FMAs.
template <int D, int kJ>
__device__ __forceinline__ void qk(float (&s)[8][4], const float* sq,
                                   const float* sk) {
  constexpr int kS = D + 4;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[8];
    float4 kv[kJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(sq + i * kS + d);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(sk + 16 * j * kS + d);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
    }
  }
}

// The kCols consecutive floats at p, as one vector load.
template <int kCols>
__device__ __forceinline__ void load_cols(float (&r)[kCols], const float* p) {
  if constexpr (kCols == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  } else {
    static_assert(kCols == 2, "D is 32 or 64");
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x;
    r[1] = x.y;
  }
}

// The online softmax of the thread's 8 rows x 4 keys of one tile in
// base 2: keys at or past `valid` to -inf, the row max over the 16 threads
// of the row group, O and the row sums l rescaled, P into the row group's
// shared-memory rows (f32, as the JAX kernel casts p to the input dtype).
template <int kCols>
__device__ __forceinline__ void softmax_rows(float (&s)[8][4], float (&m)[8],
                                             float (&l)[8],
                                             float (&o)[8][kCols],
                                             float* p_rows, int tx, int valid,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = tx + 16 * j < valid ? s[i][j] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    // Every tile holds a key < n: mx is finite, exp2f(-inf - mx) = 0.
    const float alpha = exp2f(m[i] - mx);
    m[i] = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = exp2f(s[i][j] - mx);
      rs += p;
      p_rows[i * kPStride + tx + 16 * j] = p;
    }
    l[i] = l[i] * alpha + rs;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      o[i][c] *= alpha;
    }
  }
}

// O += P V for the thread's 8 rows and kCols columns over the keys below N,
// rounded up to 4 (P is 0 past N and V's rows there are zeros). Every
// 4-key step reads 8 + 4 vectors for 32 kCols FMAs.
template <int kS, int kCols>
__device__ __forceinline__ void pv_rows(float (&o)[8][kCols],
                                        const float* p_rows,
                                        const float* v_cols, int valid) {
  const int key_end = valid >= kKeys ? kKeys : (valid + 3) & ~3;
#pragma unroll 2
  for (int key = 0; key < key_end; key += 4) {
    float4 pv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(p_rows + i * kPStride + key);
    }
    float vr[4][kCols];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      load_cols<kCols>(vr[e], v_cols + (key + e) * kS);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        o[i][c] = fmaf(pv[i].x, vr[0][c], o[i][c]);
        o[i][c] = fmaf(pv[i].y, vr[1][c], o[i][c]);
        o[i][c] = fmaf(pv[i].z, vr[2][c], o[i][c]);
        o[i][c] = fmaf(pv[i].w, vr[3][c], o[i][c]);
      }
    }
  }
}

// FFMA, exact f32 products. Thread (ty, tx) of a block owns q rows
// 8ty .. 8ty + 7 of its tile: in each 64-key tile the logits of keys
// tx + 16j (j < 4), and O's columns kCols tx .. kCols tx + kCols - 1. The
// 16 threads of a row group are one half-warp, so a row's max and sum
// reduce with 4 shuffles, and the P rows a warp writes are the rows it
// reads back for PV. K and V have one shared-memory buffer each, and each
// is refilled as soon as every warp is done with it: tile i's V copies
// (cp.async) go out at the barrier that opens tile i and land during its
// QK^T and softmax, tile i + 1's K copies at the barrier before tile i's
// PV and land during it. Two barriers a tile; ~70 KB of shared memory, so
// three blocks an SM. Warps whose rows all lie past N
// skip the products, and the last key tile computes and multiplies only
// the keys below N (rounded up to 16 for QK^T, to 4 for PV).
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int n, int heads, Strides qs, Strides ks, Strides vs,
                         float scale_log2) {
  using C = Cfg<D>;
  constexpr int kS = C::kStride;
  constexpr int kCols = C::kCols;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + C::kQ;
  float* sv = sk + C::kKV;
  float* sp = sv + C::kKV;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  // A warp's rows are 16 (tid / 32) .. 16 (tid / 32) + 15.
  const bool active = q0 + 16 * (tid / 32) < n;

  const float* qb = q + batch * qs.b + head * qs.h;
  const float* kb = k + batch * ks.b + head * ks.h;
  const float* vb = v + batch * vs.b + head * vs.h;
  const int n_tiles = (n + kKeys - 1) / kKeys;

  load_rows<D, kRows, kThreads, kGroupPad>(sq, qb, qs.n, q0, n, tid);
  load_rows<D, kKeys, kThreads, 0>(sk, kb, ks.n, 0, n, tid);
  cp_async_commit();

  float o[8][kCols] = {};
  float m[8];
  float l[8] = {};                          // this thread's partial row sums
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
  }
  const float* q_rows = sq + ty * C::kQGroup;
  float* p_rows = sp + ty * C::kPGroup;
  const float* k_rows = sk + tx * kS;
  const float* v_cols = sv + kCols * tx;

  for (int it = 0; it < n_tiles; ++it) {
    const int valid = n - it * kKeys;      // keys of this tile below N
    cp_async_wait<0>();
    __syncthreads();   // K of tile it has landed; every warp is done with V
    load_rows<D, kKeys, kThreads, 0>(sv, vb, vs.n, it * kKeys, n, tid);
    cp_async_commit();
    if (active) {
      float s[8][4] = {};
      if (valid > 48) {
        qk<D, 4>(s, q_rows, k_rows);
      } else if (valid > 32) {
        qk<D, 3>(s, q_rows, k_rows);
      } else if (valid > 16) {
        qk<D, 2>(s, q_rows, k_rows);
      } else {
        qk<D, 1>(s, q_rows, k_rows);
      }
      softmax_rows(s, m, l, o, p_rows, tx, valid, scale_log2);
    }
    cp_async_wait<0>();
    __syncthreads();   // V of tile it has landed; every warp is done with K
    if (it + 1 < n_tiles) {
      load_rows<D, kKeys, kThreads, 0>(sk, kb, ks.n, (it + 1) * kKeys, n,
                                          tid);
      cp_async_commit();
    }
    if (active) {
      pv_rows<kS, kCols>(o, p_rows, v_cols, valid);
    }
  }

  const long long row_elems = static_cast<long long>(heads) * D;
  float* ob = out + static_cast<long long>(batch) * n * row_elems + head * D +
              kCols * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      li += __shfl_xor_sync(0xffffffffu, li, off);
    }
    const int row = q0 + 8 * ty + i;
    if (row < n) {
      const float inv = 1.f / li;
      float* dst = ob + row * row_elems;
      if constexpr (kCols == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
      } else {
        *reinterpret_cast<float2*>(dst) =
            make_float2(o[i][0] * inv, o[i][1] * inv);
      }
    }
  }
}

}  // namespace f32

// ---- the bf16 D = 64 instances: wgmma, TMA and a producer warpgroup ----

namespace hopper {

constexpr int kD = 64;
constexpr int kRows = 128;                  // q rows a block
constexpr int kKeys = 128;                  // keys a K/V stage
constexpr int kStages = 3;
constexpr int kConsumers = 2;               // warpgroups of 64 q rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileBytes = kKeys * kD * 2;  // one 128 x 64 bf16 box
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;          // 128 * 40 + 256 * 232 <= 65536
static_assert(kRows == kKeys, "one TMA box shape serves Q, K and V");
static_assert(kD * 2 == 128, "a row is one 128-byte swizzle line");

// Every tile is 16 KB, so each stays 1024-byte aligned (the swizzle atom)
// when the struct is.
struct Smem {
  __nv_bfloat16 q[kRows * kD];
  __nv_bfloat16 k[kStages][kKeys * kD];
  __nv_bfloat16 v[kStages][kKeys * kD];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_full[kStages];
  uint64_t v_empty[kStages];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;

using sm90::ex2;
using sm90::load_box;
using sm90::MapDims;

// The descriptors of one tile's products, each pinned in its register: QK^T
// takes four k-steps of 16 over D (a step moves both descriptors 32 bytes
// along the swizzled 128-byte rows); PV eight k-steps of 16 keys (V's stage
// is MN-major, rows are keys: a step moves 16 rows = 2048 bytes).
struct Descs {
  uint64_t q[kD / 16], k[kD / 16], v[kKeys / 16];
};

__device__ __forceinline__ void qk_descs(Descs& d, uint64_t desc_q,
                                         const __nv_bfloat16* k_tile) {
  const uint64_t desc_k = sm90::desc_sw128(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    d.q[kk] = desc_q + 2 * kk;
    d.k[kk] = desc_k + 2 * kk;
  }
  sm90::fence_operands(d.q);
  sm90::fence_operands(d.k);
}

__device__ __forceinline__ void pv_descs(Descs& d,
                                         const __nv_bfloat16* v_tile) {
  const uint64_t desc_v = sm90::desc_sw128(v_tile, kTileBytes, 1024);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    d.v[kk] = desc_v + kk * (16 * 128 >> 4);
  }
  sm90::fence_operands(d.v);
}

// S = Q K^T, one warpgroup: 64 rows x 128 keys (S is overwritten).
__device__ __forceinline__ void qk(float (&s)[64], const Descs& d) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    sm90::wgmma_m64n128k16_ss(s, d.q[kk], d.k[kk], kk);
  }
}

// O += P V, one warpgroup: P 64 x 128 from registers.
__device__ __forceinline__ void pv(float (&o)[32],
                                   const uint32_t (&p)[kKeys / 16][4],
                                   const Descs& d) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    sm90::wgmma_m64n64k16_rs(o, p[kk], d.v[kk], 1);
  }
}

__device__ __forceinline__ void fence_p(uint32_t (&p)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    sm90::fence_operands(p[kk]);
  }
}

// The maximum (kMax) or the sum of r[0..16) as a tree of four levels, in
// registers: short dependency chains where a loop would chain 16 steps.
template <bool kMax>
__device__ __forceinline__ float tree16(float (&r)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r[j] = kMax ? fmaxf(r[j], r[j + 8]) : r[j] + r[j + 8];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = kMax ? fmaxf(r[j], r[j + 4]) : r[j] + r[j + 4];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    r[j] = kMax ? fmaxf(r[j], r[j + 2]) : r[j] + r[j + 2];
  }
  return kMax ? fmaxf(r[0], r[1]) : r[0] + r[1];
}

// The online softmax of one logit tile in place, rows g and g + 8 of the
// thread's warp: keys at or past `valid` to -inf, the new running max (m,
// raw logits), alpha = exp2((m_old - m_new) * scale) for O, S replaced by
// P = exp2(S * scale - m * scale) in f32, and the row sums l rescaled and
// increased by this tile's f32 probabilities.
__device__ __forceinline__ void softmax_tile(float (&s)[64], int valid,
                                             int t, float scale_log2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0,
                                             float& alpha1) {
  if (valid < kKeys) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * t + e >= valid) {
          s[4 * j + e] = -INFINITY;
          s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
  }
  // Row maxima as trees, then over the quad.
  static_assert(kKeys / 8 == 16, "tree16 reduces a row's 16 pairs");
  float r0[kKeys / 8];
  float r1[kKeys / 8];
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    r0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
    r1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
  float mx0 = fmaxf(m0, tree16<true>(r0));
  float mx1 = fmaxf(m1, tree16<true>(r1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // Every tile holds a key < n, so mx0/mx1 are finite here and the first
  // tile's alpha is exp2(-inf) = 0.
  alpha0 = ex2((m0 - mx0) * scale_log2);
  alpha1 = ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float ms0 = mx0 * scale_log2;
  const float ms1 = mx1 * scale_log2;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -ms0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -ms0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -ms1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -ms1));
    r0[j] = s[4 * j] + s[4 * j + 1];
    r1[j] = s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + tree16<false>(r0);    // row sums as trees too
  l1 = l1 * alpha1 + tree16<false>(r1);
}

// P (f32, S's accumulator layout) rounded to bf16 A fragments for PV:
// p[kk] covers keys 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      p[kk][2 * half] = pack_bf16(s[4 * j], s[4 * j + 1]);          // row g
      p[kk][2 * half + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);  // g + 8
    }
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// One consumer warpgroup: 64 q rows of each of the block's work units
// (q tile, head, batch) against every K/V stage. Tile i's QK^T and tile
// i - 1's PV go out in one batch and tile i's softmax runs while that PV is
// in flight; P is packed and O rescaled once the PV has landed, so no
// register of a product in flight is written. The two consumers run
// unsynchronised, so one's softmax runs beside the other's products. The
// K/V ring's position `c` runs on across units; Q is released after a
// unit's last QK^T, so the producer loads the next unit's Q and first
// stages during this one's last PV and epilogue.
template <bool kWriteLse>
__device__ __forceinline__ void consume(Smem& sm,
                                        __nv_bfloat16* __restrict__ out,
                                        float* __restrict__ lse, int n,
                                        int heads, int q_tiles, int units,
                                        float scale_log2) {
  const int ctid = threadIdx.x - 128;
  const int cw = ctid / 128;                // rows 64 cw .. 64 cw + 63
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int t = lane & 3;
  const int n_tiles = (n + kKeys - 1) / kKeys;

  const uint64_t desc_q = sm90::desc_sw128(sm.q + cw * 64 * kD, 16, 1024);
  float sacc[64];
  uint32_t p[kKeys / 16][4];
  Descs d;

  int c = 0;                                // K/V tiles consumed so far
  int i = 0;                                // units done
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int q0 = (u % q_tiles) * kRows;
    const int head = (u / q_tiles) % heads;
    const int batch = u / (q_tiles * heads);
    float o[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[j] = 0.f;
    }
    float m0 = -INFINITY;                   // running max of the raw logits,
    float m1 = -INFINITY;                   // rows g and g + 8
    float l0 = 0.f;                         // this thread's partial row sums
    float l1 = 0.f;
    float alpha0, alpha1;

    sm90::mbar_wait(&sm.q_full, i & 1);
    // Tile 0: S and its softmax; its PV goes out with tile 1's QK^T.
    const int s0 = c % kStages;
    sm90::mbar_wait(&sm.k_full[s0], (c / kStages) & 1);
    qk_descs(d, desc_q, sm.k[s0]);
    sm90::fence_operands(sacc);
    sm90::wgmma_fence();
    qk(sacc, d);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sacc);
    if (lane == 0) {
      sm90::mbar_arrive(&sm.k_empty[s0]);   // this warp is done with K
      if (n_tiles == 1) {
        sm90::mbar_arrive(&sm.q_empty);     // and with Q
      }
    }
    softmax_tile(sacc, n, t, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    pack_p(sacc, p);
    for (int it = 1; it < n_tiles; ++it) {
      const int g = c + it;
      const int s = g % kStages;
      const int sp = (g - 1) % kStages;
      sm90::mbar_wait(&sm.k_full[s], (g / kStages) & 1);
      sm90::mbar_wait(&sm.v_full[sp], ((g - 1) / kStages) & 1);
      qk_descs(d, desc_q, sm.k[s]);
      pv_descs(d, sm.v[sp]);
      sm90::fence_operands(sacc);
      sm90::fence_operands(o);
      fence_p(p);
      sm90::wgmma_fence();
      qk(sacc, d);
      sm90::wgmma_commit();
      pv(o, p, d);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();                // QK^T landed, PV in flight
      sm90::fence_operands(sacc);
      if (lane == 0) {
        sm90::mbar_arrive(&sm.k_empty[s]);
        if (it == n_tiles - 1) {
          sm90::mbar_arrive(&sm.q_empty);
        }
      }
      softmax_tile(sacc, n - it * kKeys, t, scale_log2, m0, m1, l0, l1,
                   alpha0, alpha1);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      fence_p(p);
      if (lane == 0) {
        sm90::mbar_arrive(&sm.v_empty[sp]);
      }
      rescale(o, alpha0, alpha1);
      pack_p(sacc, p);
    }
    const int gl = c + n_tiles - 1;
    const int sl = gl % kStages;
    sm90::mbar_wait(&sm.v_full[sl], (gl / kStages) & 1);
    pv_descs(d, sm.v[sl]);
    sm90::fence_operands(o);
    fence_p(p);
    sm90::wgmma_fence();
    pv(o, p, d);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);
    if (lane == 0) {
      sm90::mbar_arrive(&sm.v_empty[sl]);
    }
    c += n_tiles;

    // Row sums live split over the 4 threads of each row group.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;

    const long long row_elems = static_cast<long long>(heads) * kD;
    __nv_bfloat16* ob =
        out + static_cast<long long>(batch) * n * row_elems + head * kD;
    const int r0 = q0 + cw * 64 + warp * 16 + (lane >> 2);
    const int r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r0 < n) {
        *reinterpret_cast<uint32_t*>(ob + r0 * row_elems + col) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      }
      if (r1 < n) {
        *reinterpret_cast<uint32_t*>(ob + r1 * row_elems + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }

    if constexpr (kWriteLse) {
      // log(sum_j exp(s_j)) = ln2 * (m * scale_log2 + log2(l)).
      float* lb = lse + (static_cast<long long>(batch) * heads + head) * n;
      if (t == 0 && r0 < n) {
        lb[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;
      }
      if (t == 0 && r1 < n) {
        lb[r1] = (m1 * scale_log2 + log2f(l1)) * kLn2;
      }
    }
  }
}

// A persistent grid: block b takes the work units b, b + gridDim.x, ...
// (unit = q tile + q_tiles * (head + heads * batch), so the blocks in
// flight share a few heads' K and V in L2).
template <bool kWriteLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const MapDims dq, const MapDims dk,
                          const MapDims dv, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int batch, int n,
                          int heads, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int q_tiles = (n + kRows - 1) / kRows;
  const int units = q_tiles * heads * batch;
  const int n_tiles = (n + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    sm90::mbar_init(&sm.q_empty, kConsumers * 4);        // one per warp
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.k_empty[s], kConsumers * 4);
      sm90::mbar_init(&sm.v_empty[s], kConsumers * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer warpgroup: one thread keeps the stages' loads in flight.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      int c = 0;                            // K/V tiles loaded so far
      int i = 0;                            // units started
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        const int q0 = (u % q_tiles) * kRows;
        const int head = (u / q_tiles) % heads;
        const int b = u / (q_tiles * heads);
        // A fresh barrier passes a wait at parity 1: the first unit's Q
        // and the first round of stages go in at once.
        sm90::mbar_wait(&sm.q_empty, (i & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.q_full, kRows * kD * 2);
        load_box(sm.q, &tm_q, dq, &sm.q_full, head, q0, b);
        for (int it = 0; it < n_tiles; ++it, ++c) {
          const int s = c % kStages;
          const uint32_t parity = ((c / kStages) & 1) ^ 1;
          sm90::mbar_wait(&sm.k_empty[s], parity);
          sm90::mbar_expect_tx(&sm.k_full[s], kTileBytes);
          load_box(sm.k[s], &tm_k, dk, &sm.k_full[s], head, it * kKeys, b);
          sm90::mbar_wait(&sm.v_empty[s], parity);
          sm90::mbar_expect_tx(&sm.v_full[s], kTileBytes);
          load_box(sm.v[s], &tm_v, dv, &sm.v_full[s], head, it * kKeys, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume<kWriteLse>(sm, out, lse, n, heads, q_tiles, units, scale_log2);
  }
}

template <bool kWriteLse>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int n, int heads, const Strides& qs, const Strides& ks,
           const Strides& vs, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  MapDims mq, mk, mv;
  int rc = sm90::encode_view_d64(&tq, &mq, q, batch, n, heads, qs.b, qs.n,
                                 qs.h, kRows);
  if (rc == 0) {
    rc = sm90::encode_view_d64(&tk, &mk, k, batch, n, heads, ks.b, ks.n,
                               ks.h, kKeys);
  }
  if (rc == 0) {
    rc = sm90::encode_view_d64(&tv, &mv, v, batch, n, heads, vs.b, vs.n,
                               vs.h, kKeys);
  }
  if (rc != 0) {
    return rc;
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<kWriteLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // One block an SM (its shared memory and registers allow no second),
  // each looping over work units.
  const long long units = static_cast<long long>((n + kRows - 1) / kRows) *
                          heads * batch;
  if (units > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(std::min<long long>(units, sms));
  flash_fwd_sm90_kernel<kWriteLse><<<grid, kThreads, kSmemBytes, st>>>(
      tq, tk, tv, mq, mk, mv, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), batch, n, heads, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

bool valid_shape(int batch, int n, int heads) {
  return n > 0 && batch > 0 && heads > 0 && batch <= 65535 && heads <= 65535;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int batch, int n, int heads, const Strides& qs,
                const Strides& ks, const Strides& vs, float scale,
                cudaStream_t st) {
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (lse == nullptr) {
    flash_fwd_kernel<D, false><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, nullptr, n, heads, qs, ks, vs, scale * kLog2e);
  } else {
    flash_fwd_kernel<D, true><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, static_cast<float*>(lse), n, heads, qs, ks, vs,
        scale * kLog2e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int batch, int n, int heads, const Strides& qs,
               const Strides& ks, const Strides& vs, float scale,
               cudaStream_t st) {
  constexpr int kSmem = f32::Cfg<D>::kSmemBytes;
  auto* kernel = f32::flash_fwd_f32_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid((n + f32::kRows - 1) / f32::kRows, heads, batch);
  kernel<<<grid, f32::kThreads, kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, heads, qs, ks,
      vs, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: [B, N, H, D] bf16, D in {32, 64}, with the given batch/token/head
// strides (in elements, last stride 1, 16-byte aligned pointer and strides).
// out: contiguous [B, N, H * D] bf16. lse: contiguous [B, H, N] f32
// (natural log), or null for the inference launch. D = 64 runs the wgmma +
// TMA design, D = 32 the mma.sync one. Launches on `stream`; returns
// cudaGetLastError(), the driver's code if a tensor map cannot be encoded,
// or cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int n, int heads, int head_dim, long long q_sb, long long q_sn,
    long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale,
    void* stream) {
  if (!valid_shape(batch, n, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  if (head_dim == 64) {
    return lse == nullptr
               ? hopper::launch<false>(q, k, v, out, nullptr, batch, n, heads,
                                       qs, ks, vs, scale, st)
               : hopper::launch<true>(q, k, v, out, lse, batch, n, heads, qs,
                                      ks, vs, scale, st);
  }
  if (head_dim == 32) {
    return launch_bf16<32>(q, k, v, out, lse, batch, n, heads, qs, ks, vs,
                           scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 instance: q, k, v [B, N, H, D] f32, D in {32, 64}, strides as
// above (16-byte aligned rows: multiples of 4 floats). out: contiguous
// [B, N, H * D] f32. Inference only (no lse). Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attn_fwd_f32(
    const void* q, const void* k, const void* v, void* out, int batch, int n,
    int heads, int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, void* stream) {
  if (!valid_shape(batch, n, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  if (head_dim == 64) {
    return launch_f32<64>(q, k, v, out, batch, n, heads, qs, ks, vs, scale,
                          st);
  }
  if (head_dim == 32) {
    return launch_f32<32>(q, k, v, out, batch, n, heads, qs, ks, vs, scale,
                          st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

