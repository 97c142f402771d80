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
// shapes; unscaled, as the bias terms are). p and dS are rounded to bf16
// for the products only. D is 64 or 80 (SAM ViT-B/L and ViT-H); gh + gw <=
// 128 and gw <= 64.
//
// What bounds it on this card: tensor-core work, 10 N^2 D flops per
// (batch, head) at the global blocks (1.04 ms for SAM ViT-B's 8 images at
// the bf16 peak); the bytes of the operands and the bias factors at the
// 14x14 windowed ones (N = 196), where 128-row units also leave ~35% of
// each unit's rows empty, and the short streams (4 tiles a unit) leave the
// ring's fill and each unit's epilogue exposed.
//
// The design is kernel 4's wgmma + TMA pair (flash_bwd_sm90_kernel in
// csrc/flash_attn_bwd.cu, on csrc/sm90_common.cuh) with the bias added on
// the accumulator layout:
//
// 1. relpos_bwd_stats_kernel: delta = rowsum(do * o) and lse2 = lse log2(e)
//    into a [2, B, H, n_pad] f32 scratch (n_pad = N rounded up to 128, a
//    unit's rows); past N, delta = 0 and lse2 = +inf, so a padded query row
//    has p = 0 and dS = 0.
// 2. relpos_bwd_dkdv_kernel<D> and relpos_bwd_dq_kernel<D>, one body: a
//    persistent grid of one block an SM walks work units of (128 fixed
//    rows, head, batch). Warpgroup 0 produces (setmaxnreg 40 in the dq
//    kernel, 56 in the dk/dv kernel); warpgroups 1 and 2 consume (232,
//    224 registers), 64 fixed rows each. The fixed rows (A1, A2) load once
//    a unit; 64-row tiles of the other side (B1, B2) stream through a ring
//    of 3 stages with full / empty mbarriers. Every
//    Q, K, V and dO tile is stored as D / 16 blocks of 16 columns under the
//    32-byte swizzle (a 160-byte row fits no 128-byte swizzle line; kernel
//    7's layout), each block one 16 x 64 TMA box: the first products are
//    D / 16 k16 steps, and dV += P^T dO, dK += dS^T Q and dQ += dS K read
//    their B MN-major across the blocks (m64nDk16). Both first products
//    read A from shared memory: kernel 4 holds A1 as register fragments,
//    which here cost registers the bias work needs (spills) and measured
//    slower in both kernels (PERF.md). The operands' descriptors are made
//    at each tile from one shared-memory base. A dq consumer issues tile
//    i's first products with tile i - 1's RS products and adds tile i's
//    bias, exponentials and dS while those are in flight, as kernel 4's
//    does. A dk/dv consumer, whose two D-wide accumulators leave no
//    registers for that, lets tile i - 1's RS products land before it
//    issues tile i's first products, their first k-step writing S^T and
//    dP^T only, so it holds the P^T / dS^T fragments or the new S^T / dP^T
//    and never both (and it measured faster than the overlap, PERF.md);
//    the other consumer keeps the tensor cores busy meanwhile.
//    - dk/dv: A1 = K, A2 = V, B1 = Q, B2 = dO. A stage also brings its 64
//      queries' lse2 and delta (1-D bulk copies of the scratch) and their
//      bias tables: every grid column qrw[q, 0..gw) and qrh[q, a] at the
//      grid rows a of the unit's 128 keys (at most 127 / gw + 2 of them,
//      `kv_rows`), a query's terms in a row padded to 4 more than a
//      multiple of 8 floats, so a warp's reads (4 queries 2 apart, 8
//      neighbouring keys) hit 32 banks. qrw's rows are 56 bytes at gw = 14,
//      no TMA box, but as a 2-D [B * N, H * gw] view (a token's heads side
//      by side) its rows are 16-byte aligned whenever H * gw % 4 = 0 (every
//      SAM shape): each table is then one TMA box of 64 tokens from column
//      head * gw, rounded down to 16 bytes (a box that starts elsewhere in
//      its inner dimension faults with an illegal instruction on this
//      card; the neighbouring heads' terms ride along unused), issued with
//      the stage's lse2 and delta by a second producer warp. Other shapes
//      (small odd grids at H = 2) take that warp's loads and stores. (A
//      first version copied every table with 4-byte cp.async, 4,288 copies
//      a stage at gw = 64 from 128 threads: the copies, not the products,
//      set the pace, 2.4x the mma.sync pair's time.)
//    - dq: A1 = Q, A2 = dO, B1 = K, B2 = V. Key tiles hold whole grid rows:
//      kpt = 64 / gw grid rows, kpt * gw keys a tile, the box's other rows
//      masked to p = 0 (a TMA box may start at any key). So a key's place x
//      in a tile fixes its grid column (x % gw) and its row within the tile
//      (x / gw) for every tile. Each consumer holds its 64 rows' gh + gw
//      bias terms once a unit (kernel 7's table: rows g and g + 8 side by
//      side); each warp loads its own 16 rows (asked of L2 a unit ahead)
//      and stores them while its unit's first products run, so no barrier
//      is needed. dqrh and dqrw, deterministically and without
//      atomics: for each of a tile's kpt grid rows, a thread sums its own
//      dS entries of that row in order, the 4 threads of a row's quad add
//      theirs by two xor shuffles, and one writes dqrh; the dS at each of a
//      thread's 16 places stays summed over tiles in registers, staged in
//      shared memory after the unit's last tile, and dqrw[c] is the sum of
//      places c, c + gw, ..., in order.
//    Accumulators are written from registers to dq, dk, dv through their
//    strides. Two launches on the same inputs give the same bits.
//
// Edges: TMA fills rows past N with zeros; the bias table rows of queries
// past N hold zeros or the next image's terms, never used. A streamed
// query row past N has p = 0 (lse2 = +inf);
// the dk/dv kernel's keys past N read the bias of key N - 1 and are never
// stored; the dq kernel's keys past N, and a tile's places past kpt * gw,
// get p = 0. Zero-padded tokens of the window partition are real tokens
// inside N.
//
// Not done yet: the bias factors' f32 einsums (qrh, qrw from q and the
// tables, and their backward from dqrh, dqrw) stay outside the kernels,
// as the interface of the JAX kernel has them; fewer shared-memory reads
// of the bias; windowed units sized to N = 196.

#include "flash_common.cuh"
#include "sm90_common.cuh"

#include <algorithm>
#include <cmath>
#include <cstddef>

namespace {

using flash::kLog2e;
using flash::pack_bf16;
using flash::Strides;
using sm90::ex2;
using sm90::MapDims;

constexpr int kRows = 64;                   // a box, a consumer's rows, a stage
constexpr int kConsumers = 2;               // warpgroups of 64 fixed rows
constexpr int kUnitRows = kRows * kConsumers;
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlk = 16;                    // columns a 32-byte swizzle block
constexpr int kBlkBytes = kRows * kBlk * 2; // one 16 x 64 box: 2 KB
constexpr int kMaxD = 80;
constexpr int kTileElems = kRows * kMaxD;   // a tile: D / 16 blocks
constexpr int kStatPad = kUnitRows;         // n_pad: N rounded up to this
constexpr int kMaxBias = 128;               // gh + gw
constexpr int kMaxGw = 64;                  // a grid row fits one key tile
// A bias table. dq: 32 row pairs, each 2 (gh + gw) floats padded to 16
// more than a multiple of 32 (pair_stride). dk/dv: 64 queries of tab_w +
// tab_h floats (table_stride), at most 136 (gw = 1).
constexpr int kBiasFloats = 32 * (2 * kMaxBias + 16);
constexpr int kStageStride = kRows + 1;     // dqrw staging: 64 places + 1
// Registers a thread after setmaxnreg. The dk/dv producer's warp 1 runs
// the table copies, and its consumers, which wait for their RS products
// before the bias work, need fewer than the dq kernel's.
template <bool kDkDv>
constexpr int kProducerRegs = kDkDv ? 56 : 40;
template <bool kDkDv>
constexpr int kConsumerRegs = kDkDv ? 224 : 232;
// The launch gives every thread 168 registers (65536 / 384, in steps of
// 8); setmaxnreg asking the warpgroups for more than that in all waits
// forever.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
static_assert(128 * kProducerRegs<true> +
                      128 * kConsumers * kConsumerRegs<true> <=
                  kLaunchRegs * kThreads &&
                  128 * kProducerRegs<false> +
                          128 * kConsumers * kConsumerRegs<false> <=
                      kLaunchRegs * kThreads,
              "setmaxnreg beyond the launch allocation waits forever");
constexpr uint32_t kBlkStep = kBlkBytes >> 4;         // one block
constexpr uint32_t kRowStep = 16 * kBlk * 2 >> 4;     // 16 rows of a block

__host__ __device__ inline long long stat_pad(int n) {
  return (static_cast<long long>(n) + kStatPad - 1) / kStatPad * kStatPad;
}

// Every tile is 10 KB and every block 2 KB, so each stays aligned to the
// 256-byte swizzle atom when the struct is.
template <bool kDkDv>
struct Smem {
  __nv_bfloat16 a1[kConsumers][kTileElems];   // K (dk/dv) or Q (dq)
  __nv_bfloat16 a2[kConsumers][kTileElems];   // V or dO
  __nv_bfloat16 b1[kStages][kTileElems];      // Q or K
  __nv_bfloat16 b2[kStages][kTileElems];      // dO or V
  // dk/dv: a stage's queries' table; dq: a consumer's rows' table.
  float bias[kDkDv ? kStages : kConsumers][kBiasFloats];
  float lse2[kStages][kRows];                 // dk/dv: a stage's queries'
  float delta[kStages][kRows];
  float stage_w[kDkDv ? 1 : kConsumers * 4][16 * kStageStride];  // dq
  uint64_t fixed_full;
  uint64_t fixed_empty;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <bool kDkDv>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<kDkDv>)) + 1024;
}

// The maps of one kernel: A1, A2 (fixed) and B1, B2 (streamed), boxes of
// 16 columns x 64 rows with the 32-byte swizzle; for the dk/dv kernel's
// bias tables also qrw and qrh as 2-D f32 [B * N, H * w] views, boxes of
// tab_w (tab_h) columns x 64 tokens.
struct Maps {
  CUtensorMap a1, a2, b1, b2, w, h;
};
struct Dims {
  MapDims a1, a2, b1, b2;
};

struct Args {
  int batch, n, heads, gh, gw;
  int kv_rows;             // dk/dv: grid rows of a unit's keys in a table
  int tab_w, tab_h;        // dk/dv: floats a query takes in each table
  int bias_tma;            // dk/dv: the tables come by TMA (else copied)
  int kpt;                 // dq: grid rows a key tile holds, 64 / gw
  long long n_pad;
  const float* delta;      // [B, H, n_pad]
  const float* lse2;
  const float* qrh;        // [B, N, H, gh]
  const float* qrw;        // [B, N, H, gw]
  __nv_bfloat16* out_ds;   // dk (dk/dv) or dq
  __nv_bfloat16* out_p;    // dv (dk/dv only)
  float* dqrh;             // [B, N, H, gh] (dq only)
  float* dqrw;             // [B, N, H, gw]
  Strides ds_st, p_st;
  float scale, scale_log2, inv_gw;
};

// The grid row of key (or place) x: x / gw by an f32 reciprocal, exact for
// x < 2^21.
__device__ __forceinline__ int grid_row(int x, float inv_gw) {
  return static_cast<int>((x + 0.5f) * inv_gw);
}

// The floats between two row pairs of a bias table of `width` terms: 16
// more than a multiple of 32, so the 8-byte reads of a warp (4 pairs of a
// row group, 8 neighbouring terms) and the 16-byte reads of a quarter warp
// fall on different banks.
__host__ __device__ inline int pair_stride(int width) {
  return (2 * width + 31) / 32 * 32 + 16;
}

// The floats a query takes in a dk/dv table of `width` terms: a multiple
// of 4 (16-byte TMA box rows) that is 4 more than a multiple of 8, so the 4
// threads of a quad (queries 2 apart) and the 8 row groups of a warp
// (neighbouring keys) read 32 different banks.
__host__ __device__ inline int table_stride(int width) {
  const int s = (width + 3) / 4 * 4;
  return s % 8 == 0 ? s + 4 : s;
}

// The dk/dv kernel's bias tables, the 64 queries q0 .. of (batch, head):
// the column terms qrw[q, 0..gw) at tab + q * tab_w and the row terms
// qrh[q, h0 + e] (e < kv_rows) at tab + 64 tab_w + q * tab_h, each after
// bias_offsets' floats. TMA brings them where the [B * N, H * w] views'
// rows are 16-byte aligned (the neighbouring heads' terms, and rows past
// n, are read and never used): every SAM shape. Else one warp copies them
// with loads and stores, lanes along the terms (no offsets; zeros past gh
// and for queries past n): slow, and only for small odd grids.
__device__ __forceinline__ void copy_stage_bias(float* tab, const Args& a,
                                                int batch, int head, int q0,
                                                int h0, int lane) {
  // Not unrolled: a few registers, as the producer has few.
#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    const bool row_ok = q0 + r < a.n;
    const long long tok =
        (static_cast<long long>(batch) * a.n + q0 + r) * a.heads + head;
    const float* w_src = a.qrw + tok * a.gw;
    float* w_dst = tab + r * a.tab_w;
#pragma unroll 1
    for (int e = lane; e < a.gw; e += 32) {
      w_dst[e] = row_ok ? w_src[e] : 0.f;
    }
    const float* h_src = a.qrh + tok * a.gh + h0;
    float* h_dst = tab + kRows * a.tab_w + r * a.tab_h;
#pragma unroll 1
    for (int e = lane; e < a.kv_rows; e += 32) {
      h_dst[e] = row_ok && h0 + e < a.gh ? h_src[e] : 0.f;
    }
  }
}

// The floats that precede (batch, head)'s first column term and the unit's
// first row term (grid row h0) in a dk/dv table: TMA boxes start at a
// column rounded down to 16 bytes (a box whose first coordinate falls
// elsewhere raises an illegal-instruction fault on this card); the copied
// tables start at the terms themselves.
__host__ __device__ inline int2 bias_offsets(const Args& a, int head,
                                             int h0) {
  return a.bias_tma ? make_int2(head * a.gw % 4, (head * a.gh + h0) % 4)
                    : make_int2(0, 0);
}

// dq: a consumer's bias table holds its 64 rows' terms as kernel 7's does:
// term e (e < gh the row terms, then the gw column terms) of local row
// r = 16 w + 8 h + g at tab[(8 w + g) * ps + 2 e + h], so a thread's rows g
// and g + 8 sit side by side. Warp w reads only its own 16 rows, so it
// writes them itself, under its unit's first products: pass p of its lanes
// takes the terms e = lane + 32 p. This loads pass p of the rows row0 ..
// row0 + 15 of (batch, head) into `v` (zeros past n and past the terms).
__device__ __forceinline__ void load_row_terms(float (&v)[16], const Args& a,
                                               int batch, int head, int row0,
                                               int e) {
  const bool in = e < a.gh + a.gw;
  const bool is_h = e < a.gh;
  const int w = is_h ? a.gh : a.gw;
  const float* src =
      (is_h ? a.qrh + e : a.qrw + (e - a.gh)) +
      ((static_cast<long long>(batch) * a.n + row0) * a.heads + head) * w;
  const long long step = static_cast<long long>(a.heads) * w;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    v[i] = in && row0 + i < a.n ? __ldg(src + i * step) : 0.f;
  }
}

// Stores `v` (load_row_terms' pass for term e) into warp w's rows; lanes
// past the terms store nothing.
__device__ __forceinline__ void store_row_terms(const float (&v)[16],
                                                float* tab, int ps, int warp,
                                                int e, int width) {
  if (e >= width) {
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tab[(8 * warp + (i & 7)) * ps + 2 * e + (i >> 3)] = v[i];
  }
}

// Writes warp w's 16 rows (row0 ..) of (batch, head) into its consumer's
// table, pass by pass; the warp's earlier reads of the table are done.
__device__ __forceinline__ void fill_rows(float* tab, int ps, const Args& a,
                                          int batch, int head, int row0,
                                          int warp, int lane) {
  const int width = a.gh + a.gw;
  float v[16];
  __syncwarp();
  for (int e = lane; e - lane < width; e += 32) {
    load_row_terms(v, a, batch, head, row0, e);
    store_row_terms(v, tab, ps, warp, e, width);
  }
  __syncwarp();
}

// Asks L2 for warp w's 16 rows of a unit's terms (rows row0 .. of (batch,
// head)) ahead of fill_rows: lane i < 16 the row terms of row i, lane
// 16 + i its column terms.
__device__ __forceinline__ void prefetch_rows(const Args& a, int batch,
                                              int head, int row0, int lane) {
  const int i = lane & 15;
  if (row0 + i >= a.n) {
    return;
  }
  const int w = lane < 16 ? a.gh : a.gw;
  const char* p = reinterpret_cast<const char*>(
      (lane < 16 ? a.qrh : a.qrw) +
      ((static_cast<long long>(batch) * a.n + row0 + i) * a.heads + head) *
          w);
  for (int off = 0; off < w * 4; off += 128) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
  }
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p + w * 4 - 4));
}

// A 32-byte-swizzle wgmma descriptor (sm90::desc_sw32's) of the operand at
// shared-memory address `addr`: `lbo` 16 for a K-major operand, the block
// stride for an MN-major one; 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t sw32(uint32_t addr, uint32_t lbo) {
  return (static_cast<uint64_t>((256u >> 4) | (3u << 30)) << 32) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sm90::fence_operands(f[i]);
  }
}

// x = A B^T over D (x overwritten): A this consumer's 64 fixed rows (A1
// or A2), B a stage's 64 rows, both in shared memory, K-major, a k16 step
// a block.
template <int D>
__device__ __forceinline__ void ss(float (&x)[32], uint64_t desc_a,
                                   uint64_t desc_b) {
#pragma unroll
  for (int b = 0; b < D / 16; ++b) {
    sm90::wgmma_m64n64k16_ss(x, desc_a + b * kBlkStep, desc_b + b * kBlkStep,
                             b);
  }
}

// d (64 x 64, f32) = A B^T over one k16 step, both in shared memory,
// K-major (sm90::wgmma_m64n64k16_ss with scale-d 0): d is written only, so
// the compiler need not keep its old values alive up to the product.
__device__ __forceinline__ void wgmma_m64n64k16_ss_fresh(float (&d)[32],
                                                         uint64_t desc_a,
                                                         uint64_t desc_b) {
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
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),
        "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
        "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d (64 x 64, f32) += A B^T over k16 step `kStep` of a tile: both
// descriptors advanced by kStep blocks inside the instruction's own
// registers, so the compiler holds only the tile's two base descriptors
// while it issues the steps.
template <int kStep>
__device__ __forceinline__ void wgmma_m64n64k16_ss_step(float (&d)[32],
                                                        uint64_t desc_a,
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "add.s64 da, %32, %34;\n"
      "add.s64 db, %33, %34;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " da, db, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "n"(kStep * kBlkStep), "r"(1));
}

// x = A B^T over D as `ss`, its first step writing x only (dk/dv: x's
// registers are free between a tile's pack and the next tile's products).
template <int D>
__device__ __forceinline__ void ss_fresh(float (&x)[32], uint64_t desc_a,
                                         uint64_t desc_b) {
  wgmma_m64n64k16_ss_fresh(x, desc_a, desc_b);
  wgmma_m64n64k16_ss_step<1>(x, desc_a, desc_b);
  wgmma_m64n64k16_ss_step<2>(x, desc_a, desc_b);
  wgmma_m64n64k16_ss_step<3>(x, desc_a, desc_b);
  if constexpr (D == 80) {
    wgmma_m64n64k16_ss_step<4>(x, desc_a, desc_b);
  }
}

// acc (64 x D) += F B over a stage's 64 rows: F 64 x 64 bf16 A fragments
// from registers, B the stage read MN-major (a k16 step is 16 rows of every
// block; the descriptor's leading offset is the block stride).
template <int D>
__device__ __forceinline__ void rs(float (&acc)[D / 2],
                                   const uint32_t (&f)[4][4],
                                   uint64_t desc_bt) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    if constexpr (D == 80) {
      sm90::wgmma_m64n80k16_rs(acc, f[kk], desc_bt + kk * kRowStep, 1);
    } else {
      sm90::wgmma_m64n64k16_rs(acc, f[kk], desc_bt + kk * kRowStep, 1);
    }
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

// dk/dv: s^T -> p^T in x1 and dp^T -> dS^T in x2 for the thread's keys a
// (row g) and b (row g + 8) and the stage's queries 8 j + 2 t + e: `tw` and
// `th` are the stage's tables at the thread's first query (2 t), `wa`, `wb`
// the keys' columns and `ha`, `hb` their grid rows less the unit's first.
__device__ __forceinline__ void bias_cols(float (&x1)[32], float (&x2)[32],
                                          const float* tw, int tab_w,
                                          const float* th, int tab_h,
                                          const float* lse2,
                                          const float* delta, int t, int wa,
                                          int wb, int ha, int hb,
                                          float scale_log2) {
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    // Opaque to the compiler, which would otherwise compute every j's
    // addresses ahead and hold them in registers.
    int ow = 8 * j * tab_w;
    int oh = 8 * j * tab_h;
    asm volatile("" : "+r"(ow), "+r"(oh));
    const float* w0 = tw + ow;              // query 8 j + 2 t, then + 1
    const float* h0 = th + oh;
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
    // Key a (row g), then key b (row g + 8), each its 4 reads.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int wk = k ? wb : wa;
      const int hk = k ? hb : ha;
      const float b0 = w0[wk] + h0[hk];
      const float b1 = w0[tab_w + wk] + h0[tab_h + hk];
      float& p0 = x1[4 * j + 2 * k];
      float& p1 = x1[4 * j + 2 * k + 1];
      p0 = ex2(fmaf(p0, scale_log2, fmaf(b0, kLog2e, -l.x)));
      p1 = ex2(fmaf(p1, scale_log2, fmaf(b1, kLog2e, -l.y)));
      x2[4 * j + 2 * k] = p0 * (x2[4 * j + 2 * k] - d.x);
      x2[4 * j + 2 * k + 1] = p1 * (x2[4 * j + 2 * k + 1] - d.y);
      asm volatile("" ::: "memory");
    }
    // The compiler may not hoist later reads above here: a tile's reads in
    // flight at once would take more registers than the consumer has.
    asm volatile("" ::: "memory");
  }
}

// dq: s -> p in x1 and dp -> dS in x2 for the thread's rows g and g + 8
// (`tab` at their pair) and the tile's places x = 8 j + 2 t + e, whose grid
// row is hr0 + x / gw and column x % gw; places at or past `valid` get
// p = 0. The dS join `accw`, their sums over tiles by place. With gh and gw
// even (kEven), a thread's two places of a j share their grid row and have
// neighbouring columns: one 8-byte read of the row terms and one 16-byte
// read of the column terms serve the 4 logits. Else each place takes two
// 8-byte reads.
template <bool kEven>
__device__ __forceinline__ void bias_rows(float (&x1)[32], float (&x2)[32],
                                          float (&accw)[32], const float* tab,
                                          int hr0, int valid, int gh, int gw,
                                          float inv_gw, int t,
                                          float scale_log2, float l0,
                                          float l1, float d0, float d1) {
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    // Opaque, so the places' grid rows and columns are computed here and
    // not held in registers across tiles.
    int x = 8 * j + 2 * t;
    asm volatile("" : "+r"(x));
    float b[4];                   // (g, x + e) at e, (g + 8, x + e) at 2 + e
    if constexpr (kEven) {
      // valid is even (whole grid rows of an even width); clamped to an
      // even place below it.
      const int xc = min(x, (valid - 1) & ~1);
      const int xr = grid_row(xc, inv_gw);
      const float2 bh =
          *reinterpret_cast<const float2*>(tab + 2 * (hr0 + xr));
      const float4 bw = *reinterpret_cast<const float4*>(
          tab + 2 * (gh + xc - xr * gw));
      b[0] = bh.x + bw.x;
      b[1] = bh.x + bw.z;
      b[2] = bh.y + bw.y;
      b[3] = bh.y + bw.w;
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int xc = min(x + e, valid - 1);
        const int xr = grid_row(xc, inv_gw);
        const float2 bh =
            *reinterpret_cast<const float2*>(tab + 2 * (hr0 + xr));
        const float2 bw = *reinterpret_cast<const float2*>(
            tab + 2 * (gh + xc - xr * gw));
        b[e] = bh.x + bw.x;
        b[2 + e] = bh.y + bw.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = x + e < valid;
      const float p0 = ex2(fmaf(x1[4 * j + e], scale_log2,
                                fmaf(b[e], kLog2e, -l0)));
      const float p1 = ex2(fmaf(x1[4 * j + 2 + e], scale_log2,
                                fmaf(b[2 + e], kLog2e, -l1)));
      x1[4 * j + e] = ok ? p0 : 0.f;
      x1[4 * j + 2 + e] = ok ? p1 : 0.f;
      x2[4 * j + e] = x1[4 * j + e] * (x2[4 * j + e] - d0);
      x2[4 * j + 2 + e] = x1[4 * j + 2 + e] * (x2[4 * j + 2 + e] - d1);
      accw[4 * j + e] += x2[4 * j + e];
      accw[4 * j + 2 + e] += x2[4 * j + 2 + e];
    }
    asm volatile("" ::: "memory");
  }
}

// dq: dqrh of a tile's kpt grid rows (hr0 ..) for the thread's rows r0 and
// r0 + 8 from its dS: for each grid row, the thread's entries of that row in
// order (`places` holds each entry's grid row within the tile), then the
// quad's by two xor shuffles; the quad's first thread writes. (A tile of
// one grid row, gw > 32, sums every entry.)
__device__ __forceinline__ void row_grads(const float (&ds)[32],
                                          const uint32_t (&places)[4],
                                          const Args& a, int batch, int head,
                                          int hr0, int r0, int t) {
  for (int hr = 0; hr < a.kpt; ++hr) {
    float s0 = 0.f;
    float s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in =
            a.kpt == 1 ||
            static_cast<int>((places[j / 2] >> (8 * (2 * (j % 2) + e))) &
                             0xff) == hr;
        s0 += in ? ds[4 * j + e] : 0.f;
        s1 += in ? ds[4 * j + 2 + e] : 0.f;
      }
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const int row_h = hr0 + hr;
    if (t == 0 && row_h < a.gh) {
      const long long base =
          (static_cast<long long>(batch) * a.n + r0) * a.heads + head;
      if (r0 < a.n) {
        a.dqrh[base * a.gh + row_h] = s0;
      }
      if (r0 + 8 < a.n) {
        a.dqrh[(base + 8LL * a.heads) * a.gh + row_h] = s1;
      }
    }
  }
}

// dq: the unit's dqrw from the place sums of the warp's 16 rows (row0 ..),
// staged in shared memory; entry c of a row is the sum of its places c,
// c + gw, ... in order, lanes along c.
__device__ __forceinline__ void column_grads(const float (&accw)[32],
                                             float* stage, const Args& a,
                                             int batch, int head, int row0,
                                             int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      stage[g * kStageStride + 8 * j + 2 * t + e] = accw[4 * j + e];
      stage[(g + 8) * kStageStride + 8 * j + 2 * t + e] = accw[4 * j + 2 + e];
    }
  }
  __syncwarp();
  for (int r = 0; r < 16 && row0 + r < a.n; ++r) {
    float* dst = a.dqrw + ((static_cast<long long>(batch) * a.n + row0 + r) *
                               a.heads + head) * a.gw;
    for (int c = lane; c < a.gw; c += 32) {
      float s = 0.f;
      for (int m = 0; m < a.kpt; ++m) {
        s += stage[r * kStageStride + c + m * a.gw];
      }
      dst[c] = s;
    }
  }
  __syncwarp();                             // the next unit restages
}

// Rows r0 and r0 + 8 of this thread (skipping rows at or past n) of one
// accumulator (64 x D), times `scale`, as bf16 through the view's strides.
template <int D>
__device__ __forceinline__ void store(__nv_bfloat16* base, const Strides& st,
                                      int batch, int head, int r0, int n,
                                      int t, const float (&acc)[D / 2],
                                      float scale) {
  __nv_bfloat16* p = base + batch * st.b + head * st.h;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
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

// A consumer thread's view of its unit: its rows r0 and r0 + 8 and what
// the elementwise pass needs of them.
struct Rows {
  int batch, head, r0;
  // dk/dv: the keys' columns (wa | wb << 16) and grid rows (ha | hb <<
  // 16) in the tables, two registers held across the unit.
  uint32_t wab, hab;
  float l0, l1, d0, d1;         // dq: the rows' lse2 and delta
  const float* tab;             // dq: the rows' pair of the table
};

// The elementwise pass of stage s, holding streamed tile `it`: the bias,
// p and dS (dk/dv: transposed); in the dq kernel also dqrh and the place
// sums `accw`. `ps` is the dq table's pair stride, `keys` the rows a
// streamed tile adds, `even` whether gh and gw are even.
template <bool kDkDv>
__device__ __forceinline__ void elementwise(Smem<kDkDv>& sm, const Args& a,
                                            const Rows& w, float (&x1)[32],
                                            float (&x2)[32],
                                            float (&accw)[kDkDv ? 1 : 32],
                                            const uint32_t (&places)
                                                [kDkDv ? 1 : 4],
                                            int s, int it, int t, int ps,
                                            int keys, bool even) {
  if constexpr (kDkDv) {
    const float* tw = sm.bias[s] + 2 * t * a.tab_w;
    const float* th = sm.bias[s] + kRows * a.tab_w + 2 * t * a.tab_h;
    // Unpacked here, opaque: not held apart across the tiles.
    uint32_t wab = w.wab;
    uint32_t hab = w.hab;
    asm volatile("" : "+r"(wab), "+r"(hab));
    bias_cols(x1, x2, tw, a.tab_w, th, a.tab_h, sm.lse2[s], sm.delta[s], t,
              static_cast<int>(wab & 0xffff), static_cast<int>(wab >> 16),
              static_cast<int>(hab & 0xffff), static_cast<int>(hab >> 16),
              a.scale_log2);
  } else {
    // Opaque to the compiler, which would otherwise compute the first
    // tile's places ahead, across the waits.
    int key0 = it * keys;
    asm volatile("" : "+r"(key0));
    const int valid = min(keys, a.n - key0);
    const int hr0 = it * a.kpt;
    if (even) {
      bias_rows<true>(x1, x2, accw, w.tab, hr0, valid, a.gh, a.gw, a.inv_gw,
                      t, a.scale_log2, w.l0, w.l1, w.d0, w.d1);
    } else {
      bias_rows<false>(x1, x2, accw, w.tab, hr0, valid, a.gh, a.gw,
                       a.inv_gw, t, a.scale_log2, w.l0, w.l1, w.d0, w.d1);
    }
    row_grads(x2, places, a, w.batch, w.head, hr0, w.r0, t);
  }
}

// One consumer warpgroup: 64 fixed rows of each of the block's work units
// against every stage. The ring's position `c` runs on across units.
template <int D, bool kDkDv>
__device__ __forceinline__ void consume(Smem<kDkDv>& sm, const Args& a,
                                        int tiles, int units, int n_tiles) {
  // Whether a tile's elementwise pass runs beside the previous tile's RS
  // products (the dk/dv consumers lack the registers, and measured faster
  // without).
  constexpr bool kOverlap = !kDkDv;
  const int ctid = threadIdx.x - 128;
  const int cw = ctid / 128;                // fixed rows 64 cw .. 64 cw + 63
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n = a.n;
  const int gw = a.gw;
  const int ps = pair_stride(a.gh + gw);    // dq
  const int keys = kDkDv ? kRows : a.kpt * gw;  // rows a streamed tile adds
  const bool even = ((a.gh | gw) & 1) == 0;

  // The operands' descriptors are made at each tile from the shared-memory
  // base (held opaque, so the compiler does not keep six 64-bit values) as
  // the products take them, as kernel 4's are.
  constexpr uint32_t kOffA1 = offsetof(Smem<kDkDv>, a1);
  constexpr uint32_t kOffA2 = offsetof(Smem<kDkDv>, a2);
  constexpr uint32_t kOffB1 = offsetof(Smem<kDkDv>, b1);
  constexpr uint32_t kOffB2 = offsetof(Smem<kDkDv>, b2);
  constexpr uint32_t kTileStride = kTileElems * 2;
  const uint32_t fixed = cw * kTileStride;
  const uint32_t smem = sm90::smem_u32(&sm);

  float x1[32];                             // s (s^T), then p
  float x2[32];                             // dp (dp^T), then dS
  uint32_t fp[4][4];                        // P^T as A fragments (dk/dv)
  uint32_t fds[4][4];                       // dS^T (dk/dv) or dS (dq)
  float accw[kDkDv ? 1 : 32];               // dq: dS summed over tiles

  float* tab_rows = sm.bias[kDkDv ? 0 : cw];  // dq: this consumer's table
  uint32_t places[kDkDv ? 1 : 4];           // dq: the places' grid rows
  if constexpr (!kDkDv) {
    // The grid row within a tile of each of the thread's 16 places
    // 8 j + 2 t + e, a byte each (place / gw < 64), for row_grads.
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      places[q] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = 8 * (2 * q + k / 2) + 2 * t + k % 2;
        places[q] |= static_cast<uint32_t>(grid_row(x, a.inv_gw)) << (8 * k);
      }
    }
  }

  int c = 0;                                // stages consumed so far
  int i = 0;                                // units done
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int row0 = (u % tiles) * kUnitRows;
    const int head = (u / tiles) % a.heads;
    const int batch = u / (tiles * a.heads);
    Rows w{};
    w.batch = batch;
    w.head = head;
    w.r0 = row0 + cw * kRows + warp * 16 + g;
    // dk/dv: the keys' columns and grid rows in the tables (keys past n
    // take key n - 1's; they are never stored). dq: the rows' stats (r0 + 8
    // < n_pad: a unit's rows lie inside the padded stats).
    if constexpr (kDkDv) {
      const int h0 = grid_row(row0, a.inv_gw);
      const int ka = min(w.r0, n - 1);
      const int kb = min(w.r0 + 8, n - 1);
      const int ra = grid_row(ka, a.inv_gw);
      const int rb = grid_row(kb, a.inv_gw);
      // A TMA box starts on 16 bytes: the tables begin up to 3 floats
      // before the head's first term (bias_offsets).
      const int2 off = bias_offsets(a, head, h0);
      w.wab = static_cast<uint32_t>(off.x + ka - ra * gw) |
              static_cast<uint32_t>(off.x + kb - rb * gw) << 16;
      w.hab = static_cast<uint32_t>(off.y + ra - h0) |
              static_cast<uint32_t>(off.y + rb - h0) << 16;
    } else {
      const long long stat =
          (static_cast<long long>(batch) * a.heads + head) * a.n_pad;
      w.l0 = a.lse2[stat + w.r0];
      w.l1 = a.lse2[stat + w.r0 + 8];
      w.d0 = a.delta[stat + w.r0];
      w.d1 = a.delta[stat + w.r0 + 8];
      w.tab = tab_rows + (8 * warp + g) * ps;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        accw[j] = 0.f;
      }
    }
    float acc_ds[D / 2];                    // dK or dQ
    float acc_p[kDkDv ? D / 2 : 1];         // dV (dk/dv)
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      acc_ds[j] = 0.f;
      if constexpr (kDkDv) {
        acc_p[j] = 0.f;
      }
    }

    sm90::mbar_wait(&sm.fixed_full, i & 1);

    // Tile 0: its two products and its elementwise pass.
    {
      const int s0 = c % kStages;
      uint32_t base = smem;
      asm volatile("" : "+r"(base));
      uint64_t d_a1 = sw32(base + kOffA1 + fixed, 16);
      uint64_t d_a2 = sw32(base + kOffA2 + fixed, 16);
      uint64_t d_b1 = sw32(base + kOffB1 + s0 * kTileStride, 16);
      uint64_t d_b2 = sw32(base + kOffB2 + s0 * kTileStride, 16);
      sm90::mbar_wait(&sm.full[s0], (c / kStages) & 1);
      if constexpr (kOverlap) {
        sm90::fence_operands(x1);
        sm90::fence_operands(x2);
        sm90::wgmma_fence();
        ss<D>(x1, d_a1, d_b1);
        ss<D>(x2, d_a2, d_b2);
      } else {
        sm90::wgmma_fence();
        ss_fresh<D>(x1, d_a1, d_b1);
        ss_fresh<D>(x2, d_a2, d_b2);
      }
      sm90::wgmma_commit();
      if constexpr (!kDkDv) {
        // The unit's bias rows under its first products; the next unit's
        // asked of L2 ahead.
        const int rows = row0 + cw * kRows + warp * 16;
        fill_rows(tab_rows, ps, a, batch, head, rows, warp, lane);
        const int un = u + static_cast<int>(gridDim.x);
        if (un < units) {
          prefetch_rows(a, un / (tiles * a.heads), (un / tiles) % a.heads,
                        (un % tiles) * kUnitRows + cw * kRows + warp * 16,
                        lane);
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(x1);
      sm90::fence_operands(x2);
      if (lane == 0 && n_tiles == 1) {
        sm90::mbar_arrive(&sm.fixed_empty); // this warp is done with A1, A2
      }
      elementwise(sm, a, w, x1, x2, accw, places, s0, 0, t, ps, keys, even);
      if constexpr (kDkDv) {
        pack(x1, fp);
      }
      pack(x2, fds);
    }
    // dq: tile it's two products go out with tile it - 1's RS products;
    // tile it's elementwise pass runs while those are in flight. dk/dv:
    // tile it - 1's RS products land before tile it's two products take
    // their registers, so a consumer holds one of the two sets at a time.
    for (int it = 1; it < n_tiles; ++it) {
      const int gi = c + it;
      const int s = gi % kStages;
      const int sp = (gi - 1) % kStages;
      uint32_t base = smem;
      asm volatile("" : "+r"(base));
      if constexpr (!kOverlap) {
        const uint64_t d_b1t =
            sw32(base + kOffB1 + sp * kTileStride, kBlkBytes);
        const uint64_t d_b2t =
            sw32(base + kOffB2 + sp * kTileStride, kBlkBytes);
        sm90::fence_operands(acc_ds);
        sm90::fence_operands(acc_p);
        fence_frags(fds);
        fence_frags(fp);
        sm90::wgmma_fence();
        rs<D>(acc_ds, fds, d_b1t);          // dK += dS^T Q
        rs<D>(acc_p, fp, d_b2t);            // dV += P^T dO
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operands(acc_ds);
        sm90::fence_operands(acc_p);
        fence_frags(fds);
        fence_frags(fp);
        if (lane == 0) {
          sm90::mbar_arrive(&sm.empty[sp]); // this warp is done with sp
        }
        const uint64_t d_a1 = sw32(base + kOffA1 + fixed, 16);
        const uint64_t d_a2 = sw32(base + kOffA2 + fixed, 16);
        const uint64_t d_b1 = sw32(base + kOffB1 + s * kTileStride, 16);
        const uint64_t d_b2 = sw32(base + kOffB2 + s * kTileStride, 16);
        sm90::mbar_wait(&sm.full[s], (gi / kStages) & 1);
        sm90::wgmma_fence();
        ss_fresh<D>(x1, d_a1, d_b1);
        ss_fresh<D>(x2, d_a2, d_b2);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operands(x1);
        sm90::fence_operands(x2);
        if (lane == 0 && it == n_tiles - 1) {
          sm90::mbar_arrive(&sm.fixed_empty);
        }
        elementwise(sm, a, w, x1, x2, accw, places, s, it, t, ps, keys,
                    even);
        pack(x1, fp);
        pack(x2, fds);
        continue;
      }
      uint64_t d_a1 = sw32(base + kOffA1 + fixed, 16);
      uint64_t d_a2 = sw32(base + kOffA2 + fixed, 16);
      uint64_t d_b1 = sw32(base + kOffB1 + s * kTileStride, 16);
      uint64_t d_b2 = sw32(base + kOffB2 + s * kTileStride, 16);
      uint64_t d_b1t = sw32(base + kOffB1 + sp * kTileStride, kBlkBytes);
      sm90::mbar_wait(&sm.full[s], (gi / kStages) & 1);
      sm90::fence_operands(x1);
      sm90::fence_operands(x2);
      sm90::fence_operands(acc_ds);
      fence_frags(fds);
      sm90::wgmma_fence();
      ss<D>(x1, d_a1, d_b1);
      ss<D>(x2, d_a2, d_b2);
      sm90::wgmma_commit();
      rs<D>(acc_ds, fds, d_b1t);            // dQ += dS K
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();                // tile it landed, RS in flight
      sm90::fence_operands(x1);
      sm90::fence_operands(x2);
      if (lane == 0 && it == n_tiles - 1) {
        sm90::mbar_arrive(&sm.fixed_empty);
      }
      elementwise(sm, a, w, x1, x2, accw, places, s, it, t, ps, keys, even);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc_ds);
      fence_frags(fds);
      if (lane == 0) {
        sm90::mbar_arrive(&sm.empty[sp]);   // this warp is done with stage sp
      }
      pack(x2, fds);
    }
    // The last tile's RS products.
    {
      const int sl = (c + n_tiles - 1) % kStages;
      uint32_t base = smem;
      asm volatile("" : "+r"(base));
      uint64_t d_b1t = sw32(base + kOffB1 + sl * kTileStride, kBlkBytes);
      uint64_t d_b2t = sw32(base + kOffB2 + sl * kTileStride, kBlkBytes);
      sm90::fence_operands(acc_ds);
      fence_frags(fds);
      if constexpr (kDkDv) {
        sm90::fence_operands(acc_p);
        fence_frags(fp);
      }
      sm90::wgmma_fence();
      rs<D>(acc_ds, fds, d_b1t);
      if constexpr (kDkDv) {
        rs<D>(acc_p, fp, d_b2t);
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

    if constexpr (kDkDv) {
      // The unit's place from u anew (opaque), not held across its tiles.
      int uu = u;
      asm volatile("" : "+r"(uu));
      const int ub = uu / (tiles * a.heads);
      const int uh = (uu / tiles) % a.heads;
      const int ur = (uu % tiles) * kUnitRows + cw * kRows + warp * 16 + g;
      store<D>(a.out_ds, a.ds_st, ub, uh, ur, n, t, acc_ds, a.scale);
      store<D>(a.out_p, a.p_st, ub, uh, ur, n, t, acc_p, 1.f);
    } else {
      store<D>(a.out_ds, a.ds_st, batch, head, w.r0, n, t, acc_ds, a.scale);
      column_grads(accw, sm.stage_w[cw * 4 + warp], a, batch, head,
                   row0 + cw * kRows + warp * 16, lane);
    }
  }
}

// A tile (64 rows from `row`) as its D / 16 boxes of 16 columns.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          const MapDims& md, uint64_t* bar,
                                          int head, int row, int batch) {
#pragma unroll
  for (int b = 0; b < D / kBlk; ++b) {
    sm90::load_box(dst + b * kRows * kBlk, map, md, bar, head, row, batch,
                   b * kBlk);
  }
}

// The dk/dv kernel's producer warp 1: for each stage, lane 0 brings its
// queries' lse2 and delta (1-D bulk copies) and, kTma, the bias tables (two
// 2-D boxes); else the lanes copy the tables first. Every lane arrives on
// the stage's full barrier.
template <bool kTma>
__device__ __forceinline__ void table_loop(Smem<true>& sm, const Maps& maps,
                                           const Args& a, int tiles,
                                           int units, int n_tiles,
                                           int lane) {
  int c = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int head = (u / tiles) % a.heads;
    const int b = u / (tiles * a.heads);
    const int h0 = grid_row((u % tiles) * kUnitRows, a.inv_gw);
    for (int it = 0; it < n_tiles; ++it, ++c) {
      const int s = c % kStages;
      sm90::mbar_wait(&sm.empty[s], ((c / kStages) & 1) ^ 1);
      if constexpr (!kTma) {
        copy_stage_bias(sm.bias[s], a, b, head, it * kRows, h0, lane);
      }
      if (lane != 0) {
        sm90::mbar_arrive(&sm.full[s]);
        continue;
      }
      const long long stat =
          (static_cast<long long>(b) * a.heads + head) * a.n_pad +
          it * kRows;
      sm90::mbar_expect_tx(
          &sm.full[s], kRows * 4 * (2 + (kTma ? a.tab_w + a.tab_h : 0)));
      sm90::bulk_load(sm.lse2[s], a.lse2 + stat, kRows * 4, &sm.full[s]);
      sm90::bulk_load(sm.delta[s], a.delta + stat, kRows * 4, &sm.full[s]);
      if constexpr (kTma) {
        const int cw = head * a.gw;
        const int ch = head * a.gh + h0;
        sm90::tma_load_2d(sm.bias[s], &maps.w, &sm.full[s], cw - cw % 4,
                          b * a.n + it * kRows);
        sm90::tma_load_2d(sm.bias[s] + kRows * a.tab_w, &maps.h,
                          &sm.full[s], ch - ch % 4, b * a.n + it * kRows);
      }
    }
  }
}

// The producer warpgroup. Thread 0 issues the TMA loads of the fixed rows
// once a unit, then of each stage's B1 and B2 tiles. In the dk/dv kernel
// warp 1 brings each stage's queries' lse2 and delta (1-D bulk copies)
// and bias tables (two 2-D boxes, or its lanes' loads and stores where
// those cannot be boxes), all its lanes arriving on the stage's full
// barrier. Two short loops keep each thread within
// the producer's registers. A persistent grid: block b takes the work
// units b, b + gridDim.x, ... (unit = row tile + tiles * (head + heads *
// batch), so the blocks in flight share a few heads' streamed tiles in
// L2).
template <int D, bool kDkDv>
__device__ __forceinline__ void produce(Smem<kDkDv>& sm, const Maps& maps,
                                        const Dims& md, const Args& a,
                                        int tiles, int units, int n_tiles) {
  constexpr uint32_t kTileBytes = kRows * D * 2;
  if constexpr (kDkDv) {
    if (threadIdx.x >= 32) {
      // Warp 1: each stage's lse2, delta and tables, all its lanes
      // arriving on the stage's full barrier; the two ways to the tables
      // in two loops.
      const int lane = threadIdx.x - 32;
      if (a.bias_tma) {
        table_loop<true>(sm, maps, a, tiles, units, n_tiles, lane);
      } else {
        table_loop<false>(sm, maps, a, tiles, units, n_tiles, lane);
      }
      return;
    }
  }
  const int keys = kDkDv ? kRows : a.kpt * a.gw;
  sm90::prefetch_tensormap(&maps.a1);
  sm90::prefetch_tensormap(&maps.a2);
  sm90::prefetch_tensormap(&maps.b1);
  sm90::prefetch_tensormap(&maps.b2);
  constexpr uint32_t kStageBytes = 2 * kTileBytes;
  int c = 0;                                // stages loaded so far
  int i = 0;                                // units started
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int row0 = (u % tiles) * kUnitRows;
    const int head = (u / tiles) % a.heads;
    const int b = u / (tiles * a.heads);
    // A fresh barrier passes a wait at parity 1: the first unit's fixed
    // rows and the first round of stages go in at once.
    sm90::mbar_wait(&sm.fixed_empty, (i & 1) ^ 1);
    sm90::mbar_expect_tx(&sm.fixed_full, 2 * kConsumers * kTileBytes);
#pragma unroll
    for (int h = 0; h < kConsumers; ++h) {
      load_tile<D>(sm.a1[h], &maps.a1, md.a1, &sm.fixed_full, head,
                   row0 + h * kRows, b);
      load_tile<D>(sm.a2[h], &maps.a2, md.a2, &sm.fixed_full, head,
                   row0 + h * kRows, b);
    }
    for (int it = 0; it < n_tiles; ++it, ++c) {
      const int s = c % kStages;
      const int r = it * keys;
      sm90::mbar_wait(&sm.empty[s], ((c / kStages) & 1) ^ 1);
      sm90::mbar_expect_tx(&sm.full[s], kStageBytes);
      load_tile<D>(sm.b1[s], &maps.b1, md.b1, &sm.full[s], head, r, b);
      load_tile<D>(sm.b2[s], &maps.b2, md.b2, &sm.full[s], head, r, b);
    }
  }
}

template <int D, bool kDkDv>
__device__ __forceinline__ void body(const Maps& maps, const Dims& md,
                                     const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  Smem<kDkDv>& sm = *reinterpret_cast<Smem<kDkDv>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int tiles = (a.n + kUnitRows - 1) / kUnitRows;
  const int units = tiles * a.heads * a.batch;
  const int n_tiles = kDkDv ? (a.n + kRows - 1) / kRows
                            : (a.gh + a.kpt - 1) / a.kpt;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.fixed_full, 1);
    sm90::mbar_init(&sm.fixed_empty, kConsumers * 4);    // one per warp
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      // Thread 0's arrival and, in the dk/dv kernel, warp 1's.
      sm90::mbar_init(&sm.full[s], kDkDv ? 1 + 32 : 1);
      sm90::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::setmaxnreg_dec<kProducerRegs<kDkDv>>();
    if (threadIdx.x == 0 || (kDkDv && threadIdx.x / 32 == 1)) {
      produce<D, kDkDv>(sm, maps, md, a, tiles, units, n_tiles);
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs<kDkDv>>();
    consume<D, kDkDv>(sm, a, tiles, units, n_tiles);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    relpos_bwd_dkdv_kernel(const __grid_constant__ Maps maps, const Dims md,
                           const Args a) {
  body<D, true>(maps, md, a);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    relpos_bwd_dq_kernel(const __grid_constant__ Maps maps, const Dims md,
                         const Args a) {
  body<D, false>(maps, md, a);
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

template <typename Kernel>
int launch_one(Kernel kernel, int smem, const Maps& maps, const Dims& md,
               const Args& a, int grid, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(maps, md, a);
  return static_cast<int>(cudaGetLastError());
}

// The stats pass, then the dk/dv kernel and the dq kernel, one persistent
// block an SM each. `a` holds everything but the outputs; st: q, k, v, o,
// dout, dq, dk, dv.
template <int D>
int launch(const Maps& kv, const Dims& kv_md, const Maps& qd,
           const Dims& qd_md, Args a, const void* o, const void* dout,
           const void* lse, float* scratch, void* dq, void* dk, void* dv,
           const Strides (&st)[8], cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.batch) * a.heads * a.n_pad;
  const long long stat_blocks =
      (rows * kStatLanes + kStatThreads - 1) / kStatThreads;
  const long long units = static_cast<long long>(
                              (a.n + kUnitRows - 1) / kUnitRows) *
                          a.heads * a.batch;
  if (stat_blocks > 0x7fffffffLL || units > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const int grid = static_cast<int>(std::min<long long>(units, sms));
  relpos_bwd_stats_kernel<D>
      <<<static_cast<int>(stat_blocks), kStatThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), scratch, scratch + rows, a.n,
          a.n_pad, a.heads, rows, st[3], st[4]);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) {
    return rc;
  }
  a.out_ds = static_cast<__nv_bfloat16*>(dk);
  a.out_p = static_cast<__nv_bfloat16*>(dv);
  a.ds_st = st[6];
  a.p_st = st[7];
  rc = launch_one(relpos_bwd_dkdv_kernel<D>, smem_bytes<true>(), kv, kv_md,
                  a, grid, stream);
  if (rc != 0) {
    return rc;
  }
  a.out_ds = static_cast<__nv_bfloat16*>(dq);
  a.out_p = nullptr;
  a.ds_st = st[5];
  return launch_one(relpos_bwd_dq_kernel<D>, smem_bytes<false>(), qd, qd_md,
                    a, grid, stream);
}

// The tensor map of a contiguous [rows, cols] f32 matrix (a row 16-byte
// aligned): boxes of `box_cols` x 64 rows, no swizzle; columns and rows
// past the extents read as zeros. Returns cuTensorMapEncodeTiled's result.
int encode_bias(CUtensorMap* map, const void* base, int rows, int cols,
                int box_cols) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) {
    return static_cast<int>(cudaErrorSymbolNotFound);
  }
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t gstride[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), kRows};
  const cuuint32_t estride[2] = {1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), gdim,
      gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace

// The f32 scratch the backward needs: [2, B, H, n_pad] (delta, lse2), n_pad
// = N rounded up to 128.
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
// kernels on `stream`; returns cudaGetLastError(), cuTensorMapEncodeTiled's
// result if a tensor map cannot be encoded, or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int relpos_flash_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* qrh, const void* qrw, const void* lse,
    void* scratch, void* dq, void* dk, void* dv, void* dqrh, void* dqrw,
    int batch, int n, int heads, int head_dim, int gh, int gw,
    const long long* strides, float scale, void* stream) {
  if (n <= 0 || n >= (1 << 21) || batch <= 0 || batch > 65535 ||
      heads <= 0 || heads > 65535 || gh <= 0 || gw <= 0 || gh * gw != n ||
      gh + gw > kMaxBias || gw > kMaxGw || strides == nullptr ||
      (head_dim != 64 && head_dim != 80)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  // Boxes of 16 columns x 64 rows with the 32-byte swizzle: A1, A2, B1, B2
  // of the dk/dv kernel (K, V, Q, dO) and of the dq kernel (Q, dO, K, V).
  const void* ptr[5] = {q, k, v, nullptr, dout};
  const auto encode = [&](Maps& m, Dims& md, const int (&which)[4]) {
    CUtensorMap* maps[4] = {&m.a1, &m.a2, &m.b1, &m.b2};
    MapDims* dims[4] = {&md.a1, &md.a2, &md.b1, &md.b2};
    for (int i = 0; i < 4; ++i) {
      const Strides& s = st[which[i]];
      const int rc = sm90::encode_view(maps[i], dims[i], ptr[which[i]], batch,
                                       n, heads, s.b, s.n, s.h, head_dim,
                                       kBlk, kRows, CU_TENSOR_MAP_SWIZZLE_32B);
      if (rc != 0) {
        return rc;
      }
    }
    return 0;
  };
  Maps kv, qd;
  Dims kv_md, qd_md;
  int rc = encode(kv, kv_md, {1, 2, 0, 4});
  if (rc == 0) {
    rc = encode(qd, qd_md, {0, 4, 1, 2});
  }
  if (rc != 0) {
    return rc;
  }
  Args a{};
  a.batch = batch;
  a.n = n;
  a.heads = heads;
  a.gh = gh;
  a.gw = gw;
  a.kv_rows = std::min(127 / gw + 2, gh);
  // Room for the up to 3 floats a TMA box starts before the terms.
  a.tab_w = table_stride(gw + 3);
  a.tab_h = table_stride(a.kv_rows + 3);
  if (kRows * (a.tab_w + a.tab_h) > kBiasFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The dk/dv tables by TMA where the [B * N, H * w] f32 views' rows are
  // 16-byte aligned and their token coordinates fit an int.
  a.bias_tma = heads * gw % 4 == 0 && heads * gh % 4 == 0 &&
               reinterpret_cast<uintptr_t>(qrw) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(qrh) % 16 == 0 &&
               static_cast<long long>(batch) * n + kRows < (1LL << 31);
  if (a.bias_tma) {
    rc = encode_bias(&kv.w, qrw, batch * n, heads * gw, a.tab_w);
    if (rc == 0) {
      rc = encode_bias(&kv.h, qrh, batch * n, heads * gh, a.tab_h);
    }
    if (rc != 0) {
      return rc;
    }
  }
  a.kpt = kRows / gw;
  a.n_pad = stat_pad(n);
  auto* sc = static_cast<float*>(scratch);
  a.delta = sc;
  a.lse2 = sc + static_cast<long long>(batch) * heads * a.n_pad;
  a.qrh = static_cast<const float*>(qrh);
  a.qrw = static_cast<const float*>(qrw);
  a.dqrh = static_cast<float*>(dqrh);
  a.dqrw = static_cast<float*>(dqrw);
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.inv_gw = 1.f / gw;
  const auto s = static_cast<cudaStream_t>(stream);
  return head_dim == 64
             ? launch<64>(kv, kv_md, qd, qd_md, a, o, dout, lse, sc, dq, dk,
                          dv, st, s)
             : launch<80>(kv, kv_md, qd, qd_md, a, o, dout, lse, sc, dq, dk,
                          dv, st, s);
}
