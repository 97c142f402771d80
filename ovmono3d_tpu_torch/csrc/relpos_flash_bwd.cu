// Decomposed relative-position flash attention, backward, for Hopper
// (sm_90a): bf16 q/k/v/out/dout and dq/dk/dv, f32 bias factors, their f32
// gradients, f32 math.
//
// Replaces no TPU kernel: the JAX package's backward of rel-pos attention
// (`_rpa_bwd` in ovmono3d_tpu/models/vit.py) differentiates the XLA path
// `_rel_pos_attention_fast`, whose [B, H, N, N] f32 logits, probabilities
// and their gradients take 6.4 GB each at a SAM ViT-B global block of 8
// images. This kernel keeps them on the SM, as kernels 4 and 6 do for plain
// attention. From q, k, v (strided views of the qkv projection's output
// [B, N, 3, H, D]), the forward's output o and its gradient do, the bias
// factors qrh [B, N, H, gh] and qrw [B, N, H, gw] and the forward's row
// log-sum-exp lse ([B, H, N] f32, natural log, relpos_flash_fwd.cu's lse
// instance), with
//
//     s_ij = scale q_i.k_j + qrh[i, j / gw] + qrw[i, j % gw]
//     p = exp(s - lse),  delta = rowsum(do * o),  dS = p * (do v^T - delta)
//
// it writes dv = p^T do, dk = scale dS^T q and dq = scale dS k (bf16, with
// their own strides: the packed route lands them in the three slots of one
// [B, N, 3, H, D] gradient) and dqrh[i, a] = sum over the keys j of key row
// a of dS_ij, dqrw[i, c] = the same over key column c (f32, the factors'
// shapes; unscaled, as the bias terms are). D is 64 or 80 (SAM ViT-B/L and
// ViT-H); gh + gw <= 128 and gw <= 64.
//
// What bounds it on this card: tensor-core work, 10 N^2 D flops per
// (batch, head) at the global blocks (1.04 ms for SAM ViT-B's 8 images at
// the bf16 peak); the bytes of the operands and the bias factors at the
// 14x14 windowed ones. The design is kernel 4's mma.sync pair
// (csrc/flash_attn_bwd.cu's D = 32 kernels, on csrc/flash_common.cuh), a
// simple design that is right; its wgmma + TMA redesign is later work.
//
// 1. relpos_bwd_stats_kernel: delta = rowsum(do * o) and lse2 = lse log2(e)
//    into a [2, B, H, n_pad] f32 scratch (n_pad = N rounded up to 64);
//    past N, delta = 0 and lse2 = +inf, so a padded query row has p = 0
//    and dS = 0.
// 2. relpos_bwd_dkdv_kernel: a block of 4 warps owns 64 keys of one (head,
//    batch), each warp 16 as A fragments of K and V in registers, and
//    streams 64-query tiles of Q and dO (double-buffered cp.async) with the
//    tile's bias rows: every grid column and its keys' grid rows (at most
//    63 / gw + 2 of them), a table of 64 rows in shared memory (16-byte
//    copies where gw is a multiple of 4). s^T = K
//    Q^T, p^T, dv += p^T dO, dp^T = V dO^T, dS^T, dk += dS^T Q, all
//    m16n8k16.
// 3. relpos_bwd_dq_kernel: a block owns 64 queries (their Q and dO as A
//    fragments, their bias rows in one shared table) and streams key tiles
//    that hold whole grid rows: kpt = 64 / gw grid rows, kpt * gw keys a
//    tile. So a key's place x in a tile fixes its grid column (x % gw) and
//    its row within the tile (x / gw) for every tile. dq += dS K as in
//    kernel 4; and it owns its rows' dqrh and dqrw, deterministically and
//    without atomics:
//    - dqrh: each grid row lies in one tile. For each of the tile's kpt
//      rows, a thread sums its own dS entries of that row (in order), the 4
//      threads of a row's quad add theirs by two xor shuffles, and one
//      thread writes the entry.
//    - dqrw: each thread keeps the sum over tiles of dS at each of its 16
//      places of a row (registers, as an accumulator); after the last tile
//      the warp stages them in shared memory and each entry c is the sum of
//      places c, c + gw, ..., in order.
//    Two launches on the same inputs give the same bits.
//
// Edges: tiles arrive with rows past N zeroed (cp.async's zero fill); the
// bias table rows of queries past N are zeros. Keys past N, and a tile's
// places past kpt * gw, get p = 0 in the dq kernel; the dk/dv kernel's keys
// past N read the bias of key N - 1 and are never stored. Zero-padded
// tokens of the window partition are real tokens inside N.

#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

constexpr int kStatPad = kBlock;            // n_pad: N rounded up to this
constexpr int kMaxBias = 128;               // gh + gw
constexpr int kMaxGw = 64;                  // a grid row fits one key tile

__host__ __device__ inline long long stat_pad(int n) {
  return (static_cast<long long>(n) + kStatPad - 1) / kStatPad * kStatPad;
}

struct Grad {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* qrh;        // [B, N, H, gh]
  const float* qrw;        // [B, N, H, gw]
  const float* lse2;       // [B, H, n_pad] row stats of the stats kernel
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dqrh;             // [B, N, H, gh]
  float* dqrw;             // [B, N, H, gw]
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int n, heads, gh, gw;
  int kv_rows;             // grid rows a dk/dv table holds: 63 / gw + 2
  int kpt;                 // grid rows a dq key tile holds: 64 / gw
  float scale, scale_log2, inv_gw;
};

// Floats between two rows of a bias table of `width` entries: a multiple
// of 4 (16-byte rows for cp.async) that is 4 more than a multiple of 8, so
// the 4 threads of a quad (queries 2 apart) and the 8 row groups of a warp
// (neighbouring grid columns) read 32 different banks.
__host__ __device__ inline int table_stride(int width) {
  const int s = (width + 3) / 4 * 4;
  return s % 8 == 0 ? s + 4 : s;
}

// Copies 4 bytes from global `src` to shared `dst` asynchronously, or
// writes zeros when `valid` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 2^x (ex2.approx; 2^-inf = 0), as the forward's softmax computes it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Starts the copies of a bias table: for the 64 query rows row0 .. of
// (batch, head), the gw column terms qrw[row, ..], then the `nh` row terms
// qrh[row, h0 ..] (those below gh); rows past n and row terms past gh are
// zeros. Table row r at tab + r * stride. The copies are numbered over the
// whole table, the threads taking every 128th: the column terms as 16-byte
// copies when gw is a multiple of 4 (a row of qrw is then 16-byte
// aligned), else 4 bytes a term, and the row terms 4 bytes each. A copy's
// row is its number over the row's copies by an f32 reciprocal (exact for
// these small integers).
__device__ __forceinline__ void fill_bias(float* tab, const Grad& a,
                                          int batch, int head, int row0,
                                          int h0, int nh, int tid) {
  const int gw = a.gw;
  const int stride = table_stride(gw + nh);
  const long long tok0 =
      (static_cast<long long>(batch) * a.n + row0) * a.heads + head;
  const float* w_base = a.qrw + tok0 * gw;       // row r: + r * heads * gw
  const float* h_base = a.qrh + tok0 * a.gh + h0;
  const int w_step = a.heads * gw;
  const int h_step = a.heads * a.gh;
  const int rows = min(kBlock, a.n - row0);      // rows past n: zeros
  const int vec = gw % 4 == 0 ? 4 : 1;           // column terms a copy
  const int w_copies = gw / vec;                 // a row's column copies
  const float inv_w = 1.f / w_copies;
  for (int i = tid; i < kBlock * w_copies; i += kThreads) {
    const int r = static_cast<int>((i + 0.5f) * inv_w);
    const int c = (i - r * w_copies) * vec;
    const bool valid = r < rows;
    const float* src = valid ? w_base + r * w_step + c : a.qrw;
    if (vec == 4) {
      cp_async_16(tab + r * stride + c, src, valid);
    } else {
      cp_async_4(tab + r * stride + c, src, valid);
    }
  }
  const float inv_h = 1.f / nh;
  for (int i = tid; i < kBlock * nh; i += kThreads) {
    const int r = static_cast<int>((i + 0.5f) * inv_h);
    const int c = i - r * nh;
    const bool valid = r < rows && h0 + c < a.gh;
    cp_async_4(tab + r * stride + gw + c,
               valid ? h_base + r * h_step + c : a.qrh, valid);
  }
}

// The grid row of key (or place) x: x / gw by an f32 reciprocal, exact for
// x < 2^21.
__device__ __forceinline__ int grid_row(int x, float inv_gw) {
  return static_cast<int>((x + 0.5f) * inv_gw);
}

template <int D>
__global__ void __launch_bounds__(kThreads) relpos_bwd_dkdv_kernel(Grad a) {
  constexpr int kTile = Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* sq = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][kTile]
  __nv_bfloat16* sdo = sq + 2 * kTile;                  // [2][kTile]
  auto* slse = reinterpret_cast<float*>(sdo + 2 * kTile);  // [2][64], base 2
  float* sdelta = slse + 2 * kBlock;                    // [2][64]
  float* stab = sdelta + 2 * kBlock;                    // [2][64 * stride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int n = a.n;
  const int width = a.kv_rows + a.gw;
  const int stride = table_stride(width);

  const __nv_bfloat16* qb = a.q + batch * a.qs.b + head * a.qs.h;
  const __nv_bfloat16* kb = a.k + batch * a.ks.b + head * a.ks.h;
  const __nv_bfloat16* vb = a.v + batch * a.vs.b + head * a.vs.h;
  const __nv_bfloat16* dob = a.dout + batch * a.dos.b + head * a.dos.h;
  const long long row_bh =
      (static_cast<long long>(batch) * a.heads + head) * stat_pad(n);
  const float* lseb = a.lse2 + row_bh;
  const float* deltab = a.delta + row_bh;
  const int n_tiles = (n + kBlock - 1) / kBlock;
  // The table's first grid row, and this thread's two keys' places in a
  // table row (keys past n take key n - 1's bias; they are never stored).
  const int h0 = grid_row(k0, a.inv_gw);
  const int key_a = min(k0 + warp * 16 + g, n - 1);
  const int key_b = min(k0 + warp * 16 + g + 8, n - 1);
  const int ra = grid_row(key_a, a.inv_gw);
  const int rb = grid_row(key_b, a.inv_gw);
  const int ha = a.gw + ra - h0;
  const int hb = a.gw + rb - h0;
  const int wa = key_a - ra * a.gw;
  const int wb = key_b - rb * a.gw;

  auto load_rows = [&](int buf, int row0) {
    if (tid < kBlock) {
      const int row = row0 + tid;
      slse[buf * kBlock + tid] = row < n ? lseb[row] : INFINITY;
      sdelta[buf * kBlock + tid] = row < n ? deltab[row] : 0.f;
    }
  };

  // Prologue: this block's K and V tile through buffer 1 into registers,
  // the first Q/dO tile and its bias rows into buffer 0.
  load_tile<D>(sq + kTile, kb, a.ks.n, k0, n, tid);
  load_tile<D>(sdo + kTile, vb, a.vs.n, k0, n, tid);
  load_tile<D>(sq, qb, a.qs.n, 0, n, tid);
  load_tile<D>(sdo, dob, a.dos.n, 0, n, tid);
  fill_bias(stab, a, batch, head, 0, h0, a.kv_rows, tid);
  cp_async_commit();
  load_rows(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[D / 16][4];
  uint32_t vf[D / 16][4];
  load_a_frags<D>(kf, sq + kTile, warp, g, t);
  load_a_frags<D>(vf, sdo + kTile, warp, g, t);
  __syncthreads();

  float dk[D / 8][4] = {};
  float dv[D / 8][4] = {};

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const int nxt = cur ^ 1;
    if (it + 1 < n_tiles) {
      const int row0 = (it + 1) * kBlock;
      load_tile<D>(sq + nxt * kTile, qb, a.qs.n, row0, n, tid);
      load_tile<D>(sdo + nxt * kTile, dob, a.dos.n, row0, n, tid);
      fill_bias(stab + nxt * kBlock * stride, a, batch, head, row0, h0,
                a.kv_rows, tid);
      cp_async_commit();
      load_rows(nxt, row0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sqc = sq + cur * kTile;
    const __nv_bfloat16* sdoc = sdo + cur * kTile;
    const float* tab = stab + cur * kBlock * stride;
    const float* lq = slse + cur * kBlock;
    const float* dl = sdelta + cur * kBlock;

    // s^T = K Q^T for this warp's 16 keys and the tile's 64 queries, then
    // p^T = exp2(s^T scale log2(e) + bias log2(e) - lse2[query]).
    float p[kBlock / 8][4] = {};
    mma_a_rowsT<D>(p, kf, sqc, g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const float* tq = tab + col * stride;
        const float ba = (tq[ha] + tq[wa]) * kLog2e - lq[col];
        const float bb = (tq[hb] + tq[wb]) * kLog2e - lq[col];
        p[j][e] = ex2(fmaf(p[j][e], a.scale_log2, ba));
        p[j][2 + e] = ex2(fmaf(p[j][2 + e], a.scale_log2, bb));
      }
    }
    uint32_t pf[kBlock / 16][4];
    pack_a_frags(pf, p);
    mma_p_rows<D>(dv, pf, sdoc, lane);               // dv += p^T do

    // dp^T = V dO^T; dS^T = p^T (dp^T - delta[query]).
    float ds[kBlock / 8][4] = {};
    mma_a_rowsT<D>(ds, vf, sdoc, g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = dl[j * 8 + 2 * t + e];
        ds[j][e] = p[j][e] * (ds[j][e] - d);
        ds[j][2 + e] = p[j][2 + e] * (ds[j][2 + e] - d);
      }
    }
    uint32_t dsf[kBlock / 16][4];
    pack_a_frags(dsf, ds);
    mma_p_rows<D>(dk, dsf, sqc, lane);               // dk += dS^T q
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  const int row0 = k0 + warp * 16;
  store_rows<D>(a.dk + batch * a.dks.b + head * a.dks.h, a.dks.n, dk, row0, n,
                g, t, a.scale, a.scale);
  store_rows<D>(a.dv + batch * a.dvs.b + head * a.dvs.h, a.dvs.n, dv, row0, n,
                g, t, 1.f, 1.f);
}

// Rows of the dqrw staging area: 64 places and one float of padding.
constexpr int kStageStride = kBlock + 1;

template <int D>
__global__ void __launch_bounds__(kThreads) relpos_bwd_dq_kernel(Grad a) {
  constexpr int kTile = Tile<D>::kElems;
  static_assert(2 * kTile * 2 >= kBlock * kStageStride * 4,
                "the dqrw staging fits the K buffers");
  extern __shared__ __align__(16) unsigned char smem[];
  auto* sk = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][kTile]
  __nv_bfloat16* sv = sk + 2 * kTile;                   // [2][kTile]
  auto* tab = reinterpret_cast<float*>(sv + 2 * kTile);  // [64 * stride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int n = a.n;
  const int gh = a.gh;
  const int gw = a.gw;
  const int stride = table_stride(gh + gw);
  const int keys = a.kpt * gw;              // keys a tile
  const int n_tiles = (gh + a.kpt - 1) / a.kpt;

  const __nv_bfloat16* qb = a.q + batch * a.qs.b + head * a.qs.h;
  const __nv_bfloat16* kb = a.k + batch * a.ks.b + head * a.ks.h;
  const __nv_bfloat16* vb = a.v + batch * a.vs.b + head * a.vs.h;
  const __nv_bfloat16* dob = a.dout + batch * a.dos.b + head * a.dos.h;
  const long long row_bh =
      (static_cast<long long>(batch) * a.heads + head) * stat_pad(n);

  // Prologue: this block's Q and dO tile through buffer 1 into registers,
  // the first K/V tile into buffer 0, the rows' bias into the table.
  load_tile<D>(sk + kTile, qb, a.qs.n, q0, n, tid);
  load_tile<D>(sv + kTile, dob, a.dos.n, q0, n, tid);
  load_tile<D>(sk, kb, a.ks.n, 0, n, tid);
  load_tile<D>(sv, vb, a.vs.n, 0, n, tid);
  fill_bias(tab, a, batch, head, q0, 0, gh, tid);
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
  load_a_frags<D>(qf, sk + kTile, warp, g, t);
  load_a_frags<D>(dof, sv + kTile, warp, g, t);
  __syncthreads();
  const float* t0 = tab + (warp * 16 + g) * stride;
  const float* t1 = t0 + 8 * stride;

  float dq[D / 8][4] = {};
  float accw[kBlock / 8][4] = {};           // dS summed over tiles, by place

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const int key0 = it * keys;
    if (it + 1 < n_tiles) {
      const int nxt = cur ^ 1;
      load_tile<D>(sk + nxt * kTile, kb, a.ks.n, key0 + keys, n, tid);
      load_tile<D>(sv + nxt * kTile, vb, a.vs.n, key0 + keys, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* skc = sk + cur * kTile;
    const __nv_bfloat16* svc = sv + cur * kTile;
    const int hr0 = it * a.kpt;             // the tile's first grid row

    // p = exp2(s scale log2(e) + bias log2(e) - lse2); 0 past the tile's
    // whole grid rows and past n.
    float p[kBlock / 8][4] = {};
    mma_a_rowsT<D>(p, qf, skc, g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = j * 8 + 2 * t + e;
        const bool ok = x < keys && key0 + x < n;
        const int xr = grid_row(ok ? x : 0, a.inv_gw);
        const int hi = gw + hr0 + xr;
        const int wi = (ok ? x : 0) - xr * gw;
        const float b0 = (t0[hi] + t0[wi]) * kLog2e - lq0;
        const float b1 = (t1[hi] + t1[wi]) * kLog2e - lq1;
        p[j][e] = ok ? ex2(fmaf(p[j][e], a.scale_log2, b0)) : 0.f;
        p[j][2 + e] = ok ? ex2(fmaf(p[j][2 + e], a.scale_log2, b1)) : 0.f;
      }
    }

    // dp = dO V^T; dS = p (dp - delta).
    float ds[kBlock / 8][4] = {};
    mma_a_rowsT<D>(ds, dof, svc, g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - dl0);
      ds[j][1] = p[j][1] * (ds[j][1] - dl0);
      ds[j][2] = p[j][2] * (ds[j][2] - dl1);
      ds[j][3] = p[j][3] * (ds[j][3] - dl1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        accw[j][c] += ds[j][c];
      }
    }

    // dqrh of the tile's grid rows: this thread's entries of each row in
    // order, then the quad's by two xor shuffles; one thread writes. (A tile
    // of one grid row, gw > 32, sums every entry.)
    for (int hr = 0; hr < a.kpt; ++hr) {
      float s0 = 0.f;
      float s1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = a.kpt == 1 ||
                          grid_row(j * 8 + 2 * t + e, a.inv_gw) == hr;
          s0 += in ? ds[j][e] : 0.f;
          s1 += in ? ds[j][2 + e] : 0.f;
        }
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const int row_h = hr0 + hr;
      if (t == 0 && row_h < gh) {
        const long long base =
            (static_cast<long long>(batch) * n) * a.heads + head;
        if (r0 < n) {
          a.dqrh[(base + static_cast<long long>(r0) * a.heads) * gh + row_h] =
              s0;
        }
        if (r1 < n) {
          a.dqrh[(base + static_cast<long long>(r1) * a.heads) * gh + row_h] =
              s1;
        }
      }
    }

    uint32_t dsf[kBlock / 16][4];
    pack_a_frags(dsf, ds);
    mma_p_rows<D>(dq, dsf, skc, lane);               // dq += dS k
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  store_rows<D>(a.dq + batch * a.dqs.b + head * a.dqs.h, a.dqs.n, dq,
                q0 + warp * 16, n, g, t, a.scale, a.scale);

  // dqrw: the warp's 16 rows of place sums staged in the K buffers (free
  // after the loop's last barrier), then entry c of a row = the sum of its
  // places c, c + gw, ... in order, lanes along c.
  float* stage = reinterpret_cast<float*>(sk) + warp * 16 * kStageStride;
#pragma unroll
  for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      stage[g * kStageStride + j * 8 + 2 * t + e] = accw[j][e];
      stage[(g + 8) * kStageStride + j * 8 + 2 * t + e] = accw[j][2 + e];
    }
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row >= n) {
      break;
    }
    float* dst = a.dqrw +
                 ((static_cast<long long>(batch) * n + row) * a.heads + head) *
                     gw;
    for (int c = lane; c < gw; c += 32) {
      float s = 0.f;
      for (int m = 0; m < a.kpt; ++m) {
        s += stage[r * kStageStride + c + m * gw];
      }
      dst[c] = s;
    }
  }
}

// ---- delta = rowsum(do * o) and lse2 = lse * log2(e), padded ----

constexpr int kStatThreads = 256;
constexpr int kStatLanes = 8;               // threads a row

// One row (b, h, token) per 8 threads, each taking D / 8 elements of o and
// do as bf16 pairs; rows enumerated in [B, H, n_pad] order, so the writes
// are contiguous.
template <int D>
__global__ void __launch_bounds__(kStatThreads)
    relpos_bwd_stats_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta,
                            float* __restrict__ lse2, int n, long long n_pad,
                            int heads, long long rows, Strides os,
                            Strides dos) {
  constexpr int kPer = D / kStatLanes;       // 8 or 10 elements
  static_assert(kPer % 2 == 0, "bf16 pairs");
  const long long idx =
      static_cast<long long>(blockIdx.x) * kStatThreads + threadIdx.x;
  const long long r = idx / kStatLanes;
  const int c = static_cast<int>(idx % kStatLanes) * kPer;
  long long bh = 0;
  long long token = 0;
  float sum = 0.f;
  if (r < rows) {
    bh = r / n_pad;
    token = r % n_pad;
    if (token < n) {
      const long long b = bh / heads;
      const long long h = bh % heads;
      const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(
          o + b * os.b + token * os.n + h * os.h + c);
      const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(
          dout + b * dos.b + token * dos.n + h * dos.h + c);
#pragma unroll
      for (int i = 0; i < kPer / 2; ++i) {
        const float2 x = __bfloat1622float2(o2[i]);
        const float2 y = __bfloat1622float2(d2[i]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kStatLanes; off <<= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (r < rows && c == 0) {
    const bool valid = token < n;
    delta[r] = valid ? sum : 0.f;
    lse2[r] = valid ? lse[bh * n + token] * kLog2e : INFINITY;
  }
}

template <int D>
int launch(const Grad& a, const void* o, const void* lse, float* scratch,
           int batch, const Strides& os, cudaStream_t st) {
  const long long n_pad = stat_pad(a.n);
  const long long rows = static_cast<long long>(batch) * a.heads * n_pad;
  const long long stat_blocks =
      (rows * kStatLanes + kStatThreads - 1) / kStatThreads;
  if (stat_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  relpos_bwd_stats_kernel<D>
      <<<static_cast<int>(stat_blocks), kStatThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(o), a.dout,
          static_cast<const float*>(lse), scratch, scratch + rows, a.n, n_pad,
          a.heads, rows, os, a.dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  constexpr int kTileBytes = Tile<D>::kElems * 2;
  const int kv_smem =
      4 * kTileBytes +
      4 * (4 * kBlock + kBlock * table_stride(a.kv_rows + a.gw) * 2);
  const int q_smem = 4 * kTileBytes + 4 * kBlock * table_stride(a.gh + a.gw);
  err = cudaFuncSetAttribute(relpos_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(relpos_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_smem);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid((a.n + kBlock - 1) / kBlock, a.heads, batch);
  relpos_bwd_dkdv_kernel<D><<<grid, kThreads, kv_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  relpos_bwd_dq_kernel<D><<<grid, kThreads, q_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 scratch the backward needs: [2, B, H, n_pad] (delta, lse2).
extern "C" long long relpos_flash_bwd_scratch_floats(int batch, int n,
                                                     int heads) {
  return 2LL * batch * heads * stat_pad(n);
}

// q, k, v, o, dout: [B, N, H, D] bf16, D in {64, 80}, with batch/token/head
// strides (in elements, last stride 1, 16-byte aligned pointers and
// strides); qrh [B, N, H, gh] and qrw [B, N, H, gw] contiguous f32; lse
// [B, H, N] contiguous f32 (natural log); N = gh * gw, gh + gw <= 128, gw
// <= 64. `strides` holds 24 values: (batch, token, head) of q, k, v, o,
// dout, dq, dk and dv in that order. Writes dq, dk, dv (bf16, those
// strides) and dqrh, dqrw (contiguous f32, the factors' shapes); `scratch`
// holds relpos_flash_bwd_scratch_floats(B, N, H) floats. Launches three
// kernels on `stream`; returns cudaGetLastError() or cudaErrorInvalidValue
// for a shape it does not take.
extern "C" int relpos_flash_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* qrh, const void* qrw, const void* lse,
    void* scratch, void* dq, void* dk, void* dv, void* dqrh, void* dqrw,
    int batch, int n, int heads, int head_dim, int gh, int gw,
    const long long* strides, float scale, void* stream) {
  if (n <= 0 || n >= (1 << 21) || batch <= 0 || batch > 65535 ||
      heads <= 0 || heads > 65535 || gh <= 0 || gw <= 0 || gh * gw != n ||
      gh + gw > kMaxBias || gw > kMaxGw ||
      (head_dim != 64 && head_dim != 80)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = [&](int i) {
    return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  const int kv_rows = 63 / gw + 2;
  Grad a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v),
         static_cast<const __nv_bfloat16*>(dout),
         static_cast<const float*>(qrh),
         static_cast<const float*>(qrw),
         nullptr,
         nullptr,
         static_cast<__nv_bfloat16*>(dq),
         static_cast<__nv_bfloat16*>(dk),
         static_cast<__nv_bfloat16*>(dv),
         static_cast<float*>(dqrh),
         static_cast<float*>(dqrw),
         s(0), s(1), s(2), s(4), s(5), s(6), s(7),
         n, heads, gh, gw,
         kv_rows < gh ? kv_rows : gh,
         kBlock / gw,
         scale, scale * kLog2e, 1.f / gw};
  auto* sc = static_cast<float*>(scratch);
  const long long rows =
      static_cast<long long>(batch) * heads * stat_pad(n);
  a.delta = sc;
  a.lse2 = sc + rows;
  const auto st = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? launch<64>(a, o, lse, sc, batch, s(3), st)
                        : launch<80>(a, o, lse, sc, batch, s(3), st);
}
