// Swin window attention, forward, for Hopper (sm_90a): bf16 q/k/v/out, an
// f32 relative-position bias, per-token region ids for the shifted-window
// mask, f32 softmax.
//
// Replaces the TPU kernel _window_kernel of ovmono3d_tpu/ops/attention.py
// (behind window_attention_pallas), the attention of every block of
// GroundingDINO's Swin trunk (models/gdino/swin.py WindowAttention). Per
// (window b, head h), over the window's N tokens:
//
//     s_ij  = scale * q_i.k_j + bias[h, i, j] + m_ij,
//     m_ij  = ids_b[i] == ids_b[j] ? 0 : -1e9
//     out_i = sum_j softmax_j(s_ij) v_j
//
// with scale = D^-1/2 and ids_b = ids[b % nw] (nw windows an image, the
// batch's images one after the other); without ids there is no mask (the
// unshifted blocks). q, k and v are strided views of the qkv projection's
// output [BW, N, 3, H, D]; out is a contiguous [BW, N, H * D] that the
// output projection reads as it is. D = 32 (every Swin-B stage).
//
// What bounds it on this card: bytes. At Swin-B's 12 x 12 windows (N = 144,
// D = 32) a (window, head) is 4 N^2 D = 2.65 MFLOP against 4 N D bf16 (37 KB)
// moved: 72 flops a byte, a quarter of the ~295 at which the tensor cores
// would bound it. The N x N logits, the bias's expansion over the windows and
// the mask never reach device memory; the bias [H, N, N] (at most 2.65 MB, at
// Swin-B's last stage) is read from L2 once a head a block.
//
// What the design does about it (window_fwd_sm90_kernel<masked>, N <= 144):
// a persistent grid of one block an SM on csrc/sm90_common.cuh's wgmma +
// TMA blocks. Work units are (window, head) pairs in head-major order (unit
// = h * BW + b); each block takes a contiguous range of them, so it holds one
// head's bias for many windows and changes heads once or twice.
// - Warpgroup 0 produces. Its warp 0 loads each unit's Q, K and V by TMA
//   (two 16-column blocks of 144 rows each, 32-byte swizzle, on rank-4 maps
//   (D, H, N, BW) of the caller's strides: rows past N arrive as zeros) and
//   the window's region ids, with whether they are all equal (then the mask
//   adds nothing and the unit takes the unmasked softmax), into one of two
//   stages. Its warps 1-3 fill one of two 81 KB bias buffers a head: 18 TMA
//   boxes of 8 columns x 144 rows at N = 144, else cp.async rows with keys
//   past N set to -inf. A buffer holds 8-column groups of [144 rows][8], so
//   a warp's 8-byte reads of 8 rows hit every bank once a half warp.
// - Warpgroups 1 and 2 take rows 0-63 and 64-127 of every unit; warpgroup 3
//   rows 120-183, whose warp 0 keeps rows 128-135 and warp 1 rows 136-143
//   (one row of each thread's pair): the 16 rows past 128 split over two
//   warp schedulers, so none runs three full softmaxes a unit.
// - S = Q K^T is two wgmma m64n144k16 per warpgroup (both operands K-major
//   in shared memory). Each warp then takes the exact softmax of its rows
//   in registers (72 logits a thread: scale, bias and mask added, row max,
//   ex2.approx, row sum, P normalised before its bf16 rounding, as
//   window_attention_ref rounds it; no online rescaling: a row is one tile)
//   and O = P V on mma.sync m16n8k16 with P from registers and V by
//   ldmatrix.trans from the swizzled blocks (a wgmma m64n32k16 chain cost
//   more: PERF.md §6), then releases the stage.
// - O goes out as bf16 through a per-warp staging buffer and a TMA store,
//   issued while the warpgroup's next QK^T runs.
// Shared memory: two Q/K/V stages (27 KB each), two bias buffers (162 KB),
// nine 1 KB staging buffers, two id rows: 227 KB.
//
// Past N = 144 (no Swin stage gives more; the entry takes up to 1024) the
// earlier design runs: window_fwd_kernel below, one block of 4 warps a
// (64-row q tile, head, window), mma.sync m16n8k16 through
// csrc/flash_common.cuh, an online softmax over 64-key tiles double-buffered
// with cp.async, the bias read from global memory per key.
//
// The mask is the reference's additive -1e9, not -inf: the row's own key is
// never masked, so the row max is finite and every masked key's
// exponential is 0, as in the reference.

#include "flash_common.cuh"
#include "sm90_common.cuh"

#include <cmath>

namespace {

constexpr int kD = 32;
constexpr int kMaxTokens = 1024;

// ---- the wgmma + TMA design, N <= 144 ----
namespace w90 {

using flash::kLog2e;
using flash::pack_bf16;

constexpr int kN = 144;                     // a window's rows, padded
constexpr int kBlk = 16;                    // columns a 32-byte block
constexpr int kBlkElems = kN * kBlk;        // one block of Q, K or V: 4608 B
constexpr int kBlkBytes = kBlkElems * 2;
constexpr int kConsumers = 3;               // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kFillThreads = 96;            // the producer's warps 1-3
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 152;
// The launch gives every thread 128 registers (65536 / 512); setmaxnreg
// asking the warpgroups for more than that in all waits forever.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  kLaunchRegs * kThreads,
              "setmaxnreg beyond the launch allocation waits forever");
constexpr float kMaskAdd = -1e9f;

constexpr int kOutRows = 16;                // a warp's rows, one TMA store
constexpr int kOutSlots = kN / kOutRows;    // warps with rows below 144

struct Smem {
  __nv_bfloat16 qkv[2][3][2][kBlkElems];    // stage, q/k/v, 16-column block
  float bias[2][kN * kN];                   // bias_at's layout
  __nv_bfloat16 out[kOutSlots][2][kOutRows * kBlk];  // a warp's O, staged
  int ids[2][kN];
  int uniform[2];                           // a stage's ids all equal
  uint64_t full[2];                         // a stage's Q, K, V and ids
  uint64_t empty[2];
  uint64_t bias_full[2];
  uint64_t bias_empty[2];
};
// The 32-byte swizzle's atoms are 256 bytes: the struct is placed at the
// next multiple of 256 of the dynamic shared memory.
constexpr int kAlign = 256;
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + kAlign;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can have");

// Where bias entry (r, c) sits in a buffer: groups of 8 columns, each
// [kN rows][8] (the box of one TMA load). A warp's 8-byte reads of 8
// consecutive rows at 4 column pairs of one group cover 64 words: every
// half warp hits 32 banks.
__device__ __forceinline__ int bias_at(int r, int c) {
  return (c >> 3) * (kN * 8) + r * 8 + (c & 7);
}

// Q, K and V: boxes of 16 columns x 144 rows; out: 16 columns x 16 rows;
// bias (at N = 144, as [H N, N] f32): 8 columns x 144 rows.
struct Maps {
  CUtensorMap q, k, v, out, bias;
};
struct Dims {
  sm90::MapDims q, k, v, out;
};

struct Problem {
  const float* bias;
  const int* ids;
  int bias_tma;                             // the bias by TMA (N = 144)
  int n, heads, bw, nw, units;
  float scale;
};

// The first unit of block `block` (block + 1: one past its last): a
// contiguous share of the head-major units. Each role computes its own
// range after setmaxnreg, so nothing stays live across it.
__device__ __forceinline__ int unit_begin(const Problem& pr, int block) {
  return static_cast<int>(static_cast<long long>(block) * pr.units /
                          gridDim.x);
}

// Producer warp 0: each unit's Q, K and V by TMA (lane 0) and the window's
// ids (every lane, with whether they are all equal: then the mask adds
// nothing) into stage i % 2, once the consumers have released it.
template <bool kMasked>
__device__ __forceinline__ void load_units(Smem& sm, const Maps& maps,
                                           const Dims& md, const Problem& pr,
                                           int lane) {
  const int u0 = unit_begin(pr, blockIdx.x);
  const int u1 = unit_begin(pr, blockIdx.x + 1);
  if (lane == 0) {
    sm90::prefetch_tensormap(&maps.q);
    sm90::prefetch_tensormap(&maps.k);
    sm90::prefetch_tensormap(&maps.v);
  }
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    const int s = i & 1;
    const int head = u / pr.bw;
    const int b = u - head * pr.bw;
    // A fresh barrier passes a wait at parity 1: the second unit goes in
    // once the first has landed (the first unit and the first head's bias
    // are what every block waits for at the start), then the rest as the
    // consumers release their stages.
    if (i == 1) {
      sm90::mbar_wait(&sm.full[0], 0);
    }
    sm90::mbar_wait(&sm.empty[s], ((i >> 1) & 1) ^ 1);
    if (lane == 0) {
      uint64_t* bar = &sm.full[s];
      sm90::mbar_expect_tx(bar, 3 * 2 * kBlkBytes);
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        sm90::load_box(sm.qkv[s][0][blk], &maps.q, md.q, bar, head, 0, b,
                       blk * kBlk);
        sm90::load_box(sm.qkv[s][1][blk], &maps.k, md.k, bar, head, 0, b,
                       blk * kBlk);
        sm90::load_box(sm.qkv[s][2][blk], &maps.v, md.v, bar, head, 0, b,
                       blk * kBlk);
      }
    }
    if (kMasked) {
      const int* src = pr.ids + static_cast<long long>(b % pr.nw) * pr.n;
      const int first = src[0];
      bool same = true;
      for (int j = lane; j < pr.n; j += 32) {
        const int id = src[j];
        sm.ids[s][j] = id;
        same = same && id == first;
      }
      same = __all_sync(0xffffffffu, same);
      if (lane == 0) {
        sm.uniform[s] = same;
      }
    }
    sm90::mbar_arrive(&sm.full[s]);         // after the stores
  }
}

// Producer warps 1-3 (thread ft of 96): the bias of the block's k-th head
// into buffer k % 2, once the consumers have released it. At N = 144 (and a
// 16-byte aligned bias) the first thread loads it by TMA, 18 boxes of 8
// columns; else the warps copy
// it a row a warp at a time (16-byte copies when every row starts 16-byte
// aligned, else 4-byte ones) and set keys past n to -inf. Each thread
// arrives twice: the barrier counts 2 x 96.
__device__ __forceinline__ void fill_bias(Smem& sm, const Maps& maps,
                                          const Problem& pr, int ft) {
  const int u0 = unit_begin(pr, blockIdx.x);
  const int u1 = unit_begin(pr, blockIdx.x + 1);
  const int n = pr.n;
  const int h0 = u0 / pr.bw;
  const int heads = (u1 - 1) / pr.bw - h0 + 1;
  const int fw = ft / 32;
  const int lane = ft % 32;
  const bool wide =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(pr.bias) % 16 == 0;
  if (pr.bias_tma && ft == 0) {
    sm90::prefetch_tensormap(&maps.bias);
  }
  for (int kh = 0; kh < heads; ++kh) {
    const int buf = kh & 1;
    uint64_t* bar = &sm.bias_full[buf];
    sm90::mbar_wait(&sm.bias_empty[buf], ((kh >> 1) & 1) ^ 1);
    float* dst = sm.bias[buf];
    if (pr.bias_tma) {
      if (ft == 0) {
        sm90::mbar_expect_tx(bar, kN * kN * 4);
#pragma unroll 1
        for (int c = 0; c < kN; c += 8) {
          sm90::tma_load_2d(dst + bias_at(0, c), &maps.bias, bar, c,
                            (h0 + kh) * kN);
        }
      } else {
        sm90::mbar_arrive(bar);
      }
      sm90::mbar_arrive(bar);
      continue;
    }
    for (int r = fw; r < n; r += kFillThreads / 32) {
      const float* src =
          pr.bias + (static_cast<long long>(h0 + kh) * n + r) * n;
      if (wide) {
        for (int c = 4 * lane; c < n; c += 128) {
          sm90::cp_async_16(dst + bias_at(r, c), src + c);
        }
      } else {
        for (int c = lane; c < n; c += 32) {
          sm90::cp_async_4(dst + bias_at(r, c), src + c);
        }
      }
      for (int c = n + lane; c < kN; c += 32) {
        dst[bias_at(r, c)] = -INFINITY;
      }
    }
    sm90::mbar_arrive(bar);                 // after the stores
    sm90::cp_async_mbar_arrive(bar);        // when the copies land
  }
  sm90::cp_async_wait_all();
}

// The softmax of one row of a thread's pair (kRow 0: r0, 1: r0 + 8) over
// all kN keys, in place: S's accumulator layout (s[4 j + 2 kRow + e]: key
// 8 j + 2 t + e) in, P = softmax(scale S + bias + mask) out, normalised in
// f32. `bias` points at the row's first pair, bias_at(row, 2 t); `id` is
// the row's region id.
template <bool kMasked, int kRow>
__device__ __forceinline__ void softmax_row(float (&s)[72],
                                            const float* __restrict__ bias,
                                            const int* __restrict__ ids,
                                            int id, int t, float scale) {
  constexpr int c = 2 * kRow;
  float a[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(bias + j * (kN * 8));
    float v0 = fmaf(s[4 * j + c], scale, bj.x);
    float v1 = fmaf(s[4 * j + c + 1], scale, bj.y);
    if (kMasked) {
      const int2 ic = *reinterpret_cast<const int2*>(ids + 8 * j + 2 * t);
      v0 = ic.x == id ? v0 : v0 + kMaskAdd;
      v1 = ic.y == id ? v1 : v1 + kMaskAdd;
    }
    s[4 * j + c] = v0;
    s[4 * j + c + 1] = v1;
    a[j & 1] = fmaxf(a[j & 1], fmaxf(v0, v1));
  }
  float mx = fmaxf(a[0], a[1]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  // The row's own key is never masked, so mx is finite for a row below n
  // (rows past n are never stored).
  const float ms = mx * kLog2e;
  a[0] = a[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    s[4 * j + c] = sm90::ex2(fmaf(s[4 * j + c], kLog2e, -ms));
    s[4 * j + c + 1] = sm90::ex2(fmaf(s[4 * j + c + 1], kLog2e, -ms));
    a[j & 1] += s[4 * j + c] + s[4 * j + c + 1];
  }
  float l = a[0] + a[1];
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float inv = __frcp_rn(l);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    s[4 * j + c] *= inv;
    s[4 * j + c + 1] *= inv;
  }
}

// The softmax of the rows of a thread's pair that its warp keeps (`keep`:
// bit 0 row r0, bit 1 row r0 + 8); `bias` at bias_at(r0, 2 t).
template <bool kMasked>
__device__ __forceinline__ void softmax_rows(float (&s)[72],
                                             const float* __restrict__ bias,
                                             const int* __restrict__ ids,
                                             int keep, int r0, int t, int n,
                                             float scale) {
  const int id0 = kMasked ? ids[min(r0, n - 1)] : 0;
  const int id1 = kMasked ? ids[min(r0 + 8, n - 1)] : 0;
  if (keep & 1) {
    softmax_row<kMasked, 0>(s, bias, ids, id0, t, scale);
  }
  if (keep & 2) {
    softmax_row<kMasked, 1>(s, bias + 8 * 8, ids, id1, t, scale);
  }
}

// Ends the live range of an accumulator before a product that overwrites
// it (scale_d = 0): the asm that pins it would otherwise keep the previous
// unit's values alive across the loop.
template <int N>
__device__ __forceinline__ void discard(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "=f"(r[i]));
  }
}

// P (S's accumulator layout) rounded to bf16 A fragments for PV, in place:
// the fragment of keys 16 kk .. 16 kk + 15 goes to s[8 kk .. 8 kk + 3]
// (bit patterns), from the 8 values at s[8 kk .. 8 kk + 7].
__device__ __forceinline__ void pack_p(float (&s)[72]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint32_t p0 = pack_bf16(s[8 * kk], s[8 * kk + 1]);      // row r0
    const uint32_t p1 = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // + 8
    const uint32_t p2 = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    const uint32_t p3 = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    s[8 * kk] = __uint_as_float(p0);
    s[8 * kk + 1] = __uint_as_float(p1);
    s[8 * kk + 2] = __uint_as_float(p2);
    s[8 * kk + 3] = __uint_as_float(p3);
  }
}

// O = P V for one warp's 16 rows (o[j]: the m16n8k16 accumulator of
// columns 8 j .. 8 j + 7, the layout of S's), P from pack_p, V from the
// stage's two 32-byte-swizzled blocks: each 16-key step takes one
// ldmatrix.trans of each block (the B fragments of 2 column groups) and 4
// mma.sync. Element (key r, column 16 b + c) of V sits at byte b * 4608 +
// 32 r + 16 ((c / 8) ^ ((r / 4) % 2)) + 2 (c % 8).
__device__ __forceinline__ void pv_rows(float (&o)[4][4],
                                        const float (&s)[72],
                                        const __nv_bfloat16* v, int lane) {
  const int mat = lane >> 3;                // ldmatrix's 8x8 matrix
  const int r = (mat & 1) * 8 + (lane & 7); // its key within a step
  const uint32_t base =
      sm90::smem_u32(v) + r * 32 + (((mat >> 1) ^ ((r >> 2) & 1)) << 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint32_t a[4] = {
        __float_as_uint(s[8 * kk]), __float_as_uint(s[8 * kk + 1]),
        __float_as_uint(s[8 * kk + 2]), __float_as_uint(s[8 * kk + 3])};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      uint32_t f[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
          : "r"(base + b * kBlkBytes + kk * 16 * 32));
      flash::mma_bf16(o[2 * b], a, f[0], f[1]);
      flash::mma_bf16(o[2 * b + 1], a, f[2], f[3]);
    }
  }
}

// The kept rows of a warp's O (op[2 j + h]: the bf16 pair of columns
// 8 j + 2 t of row r0 + 8 h) into a staging buffer (two blocks of 16
// columns x 16 rows), row r0 + 8 h at buffer row g + 8 h + shift, in the
// 32-byte swizzle that TMA stores from.
__device__ __forceinline__ void stage_rows(const uint32_t (&op)[8],
                                           __nv_bfloat16* stage, int keep,
                                           int shift, int g, int t) {
  const uint32_t base = sm90::smem_u32(stage) + 4 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keep & (1 << h)) {
      const int rr = g + 8 * h + shift;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t addr = base + (j >> 1) * (kOutRows * 32) + rr * 32 +
                              (((j & 1) ^ ((rr >> 2) & 1)) << 4);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                     "r"(op[2 * j + h])
                     : "memory");
      }
    }
  }
}

// One consumer warpgroup of the block's units. Warpgroups 0 and 1 take
// rows 0-63 and 64-127; warpgroup 2 rows 120-183, of which its warp 0
// keeps 128-135 (the second row of each thread's pair) and its warp 1
// 136-143 (the first): the 16 rows past 128 are split over two warps, so
// no warp scheduler runs three full softmaxes a unit. The QK^T is the
// warpgroup's; from the softmax on, each warp goes on alone: PV on
// mma.sync (the stage is released once it has read V), then O packed to
// bf16 in registers and staged and stored by TMA while the next unit's
// QK^T runs.
template <bool kMasked>
__device__ __forceinline__ void consume(Smem& sm, const Maps& maps,
                                        const Dims& md, const Problem& pr) {
  const int u0 = unit_begin(pr, blockIdx.x);
  const int u1 = unit_begin(pr, blockIdx.x + 1);
  const int ctid = threadIdx.x - 128;
  const int cw = ctid / 128;
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n = pr.n;
  const bool last_wg = cw == kConsumers - 1;
  const int slab = last_wg ? 120 : 64 * cw;
  const bool wg_rows = last_wg ? n > 128 : slab < n;
  const int row0 = slab + 16 * warp;
  const int r0 = row0 + g;                  // and r0 + 8
  // Which rows of its pairs the warp keeps (bit 0 r0, bit 1 r0 + 8), and
  // where they are staged: warpgroup 2's warps 0 and 1 share the buffer of
  // rows 128-143 and store it together (named barrier 1 over `pair`
  // threads).
  int keep = row0 < n ? 3 : 0;
  int shift = 0;
  if (last_wg) {
    keep = warp == 0 ? (n > 128 ? 2 : 0) : warp == 1 ? (n > 136 ? 1 : 0) : 0;
    shift = warp == 0 ? -8 : 8;
  }
  const int pair = n > 136 ? 64 : 32;
  const int store_row = last_wg ? 128 : row0;
  __nv_bfloat16* stage = sm.out[store_row / kOutRows][0];
  const bool issuer = keep != 0 && lane == 0 && (!last_wg || warp == 0);
  const int h0 = u0 / pr.bw;
  float sacc[72];
  uint32_t op[8];                           // the previous unit's O, bf16

  // Stage the previous unit's O and store it by TMA.
  const auto store = [&](int head, int b) {
    if (issuer) {
      sm90::bulk_wait_read<0>();            // the store before it
    }
    if (last_wg) {
      sm90::named_barrier(1, pair);
    } else {
      __syncwarp();
    }
    stage_rows(op, stage, keep, shift, g, t);
    sm90::fence_proxy_async();              // the stores, before TMA reads
    if (last_wg) {
      sm90::named_barrier(1, pair);
    } else {
      __syncwarp();
    }
    if (issuer) {
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        sm90::store_box(&maps.out, md.out, stage + blk * kOutRows * kBlk,
                        head, store_row, b, blk * kBlk);
      }
      sm90::bulk_commit();
    }
  };

  int prev_head = -1;
  int prev_b = 0;
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    const int s = i & 1;
    const int head = u / pr.bw;
    const int b = u - head * pr.bw;
    const int kh = head - h0;               // the block's kh-th head
    sm90::mbar_wait(&sm.full[s], (i >> 1) & 1);
    if (wg_rows) {
      uint64_t dq = sm90::desc_sw32(sm.qkv[s][0][0] + slab * kBlk, 16, 256);
      uint64_t dk = sm90::desc_sw32(sm.qkv[s][1][0], 16, 256);
      sm90::fence_operand(dq);
      sm90::fence_operand(dk);
      discard(sacc);
      sm90::fence_operands(sacc);
      sm90::wgmma_fence();
      sm90::wgmma_m64n144k16_ss(sacc, dq, dk, 0);
      sm90::wgmma_m64n144k16_ss(sacc, dq + (kBlkBytes >> 4),
                                dk + (kBlkBytes >> 4), 1);
      sm90::wgmma_commit();
    }
    if (keep != 0 && prev_head >= 0) {
      store(prev_head, prev_b);
    }
    if (wg_rows) {
      sm90::wgmma_wait<0>();
      sm90::fence_operands(sacc);
    }
    sm90::mbar_wait(&sm.bias_full[kh & 1], (kh >> 1) & 1);
    if (keep != 0) {
      const float* bias = sm.bias[kh & 1] + bias_at(r0, 2 * t);
      if (kMasked && !sm.uniform[s]) {
        softmax_rows<true>(sacc, bias, sm.ids[s], keep, r0, t, n, pr.scale);
      } else {
        softmax_rows<false>(sacc, bias, sm.ids[s], keep, r0, t, n,
                            pr.scale);
      }
      pack_p(sacc);
    }
    __syncwarp();
    if (lane == 0 && (u + 1 == u1 || (u + 1) % pr.bw == 0)) {
      sm90::mbar_arrive(&sm.bias_empty[kh & 1]);  // the head's last unit
    }
    if (keep != 0) {
      float o[4][4];
      pv_rows(o, sacc, sm.qkv[s][2][0], lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        op[2 * j] = pack_bf16(o[j][0], o[j][1]);
        op[2 * j + 1] = pack_bf16(o[j][2], o[j][3]);
      }
    }
    __syncwarp();
    if (lane == 0) {
      sm90::mbar_arrive(&sm.empty[s]);      // this warp is done with stage s
    }
    prev_head = head;
    prev_b = b;
  }
  if (keep != 0) {
    store(prev_head, prev_b);
  }
  if (issuer) {
    sm90::bulk_wait<0>();                   // the last stores have landed
  }
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
    window_fwd_sm90_kernel(const __grid_constant__ Maps maps, const Dims md,
                           const Problem pr) {
  extern __shared__ unsigned char smem_raw[];
  // Aligned by an offset from the shared array (not through an integer),
  // so the compiler knows every access below is to shared memory.
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw +
      ((kAlign - (sm90::smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1)));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&sm.full[s], 1 + 32);  // expect_tx + warp 0's ids
      sm90::mbar_init(&sm.empty[s], kConsumers * 4);
      sm90::mbar_init(&sm.bias_full[s], 2 * kFillThreads);
      sm90::mbar_init(&sm.bias_empty[s], kConsumers * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      load_units<kMasked>(sm, maps, md, pr, threadIdx.x);
    } else {
      fill_bias(sm, maps, pr, threadIdx.x - 32);
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume<kMasked>(sm, maps, md, pr);
  }
}

// The map of one [BW, N, H, 32] view: boxes of 16 columns x `box_rows`
// rows with the 32-byte swizzle. Returns cuTensorMapEncodeTiled's result, 0
// on success.
int view_map(CUtensorMap* map, sm90::MapDims* md, const void* base,
             int batch, int n, int heads, long long sb, long long sn,
             long long sh, int box_rows) {
  return sm90::encode_view(map, md, base, batch, n, heads, sb, sn, sh, kD,
                           kBlk, box_rows, CU_TENSOR_MAP_SWIZZLE_32B);
}

// The map of a contiguous f32 bias [H, 144, 144] as [H 144, 144]: boxes of
// 8 columns x 144 rows (one head's column group), no swizzle.
int bias_map(CUtensorMap* map, const void* bias, int heads) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) {
    return static_cast<int>(cudaErrorSymbolNotFound);
  }
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(kN),
                              static_cast<cuuint64_t>(heads) * kN};
  const cuuint64_t gstride[1] = {kN * 4};
  const cuuint32_t box[2] = {8, kN};
  const cuuint32_t estride[2] = {1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(bias), gdim,
      gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <bool kMasked>
int launch(const Maps& maps, const Dims& md, const Problem& pr,
           cudaStream_t stream) {
  auto* kernel = window_fwd_sm90_kernel<kMasked>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  // One block an SM (its shared memory allows no second), each taking a
  // contiguous range of units.
  kernel<<<std::min(pr.units, sms), kThreads, kSmemBytes, stream>>>(maps, md,
                                                                   pr);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* q, const void* k, const void* v, const void* bias,
        const void* ids, void* out, int batch, int n, int heads, int nw,
        const flash::Strides& qs, const flash::Strides& ks,
        const flash::Strides& vs, float scale, cudaStream_t stream) {
  const long long units = static_cast<long long>(heads) * batch;
  if (units > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps;
  Dims md;
  const long long row = static_cast<long long>(heads) * kD;
  int rc = view_map(&maps.q, &md.q, q, batch, n, heads, qs.b, qs.n, qs.h,
                    kN);
  if (rc == 0) {
    rc = view_map(&maps.k, &md.k, k, batch, n, heads, ks.b, ks.n, ks.h, kN);
  }
  if (rc == 0) {
    rc = view_map(&maps.v, &md.v, v, batch, n, heads, vs.b, vs.n, vs.h, kN);
  }
  if (rc == 0) {
    rc = view_map(&maps.out, &md.out, out, batch, n, heads, n * row, row,
                  kD, kOutRows);
  }
  // The bias by TMA at N = 144 (else by cp.async, rows of N floats).
  const bool bias_tma =
      n == kN && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  if (rc == 0 && bias_tma) {
    rc = bias_map(&maps.bias, bias, heads);
  }
  if (rc != 0) {
    return rc;
  }
  const Problem pr{static_cast<const float*>(bias),
                   static_cast<const int*>(ids),
                   bias_tma ? 1 : 0,
                   n,
                   heads,
                   batch,
                   ids != nullptr ? nw : 1,
                   static_cast<int>(units),
                   scale};
  return ids != nullptr ? launch<true>(maps, md, pr, stream)
                        : launch<false>(maps, md, pr, stream);
}

}  // namespace w90

// ---- the earlier mma.sync design, 144 < N <= 1024 ----
namespace mma {

using namespace flash;

constexpr float kMaskedLog2 = -1e9f * kLog2e;

__global__ void __launch_bounds__(kThreads)
    window_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      const int* __restrict__ ids,
                      __nv_bfloat16* __restrict__ out, int n, int heads,
                      int nw, Strides qs, Strides ks, Strides vs,
                      float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = Tile<kD>::kElems;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kTile;           // two buffers
  __nv_bfloat16* sv = sk + 2 * kTile;       // two buffers
  int* sid = reinterpret_cast<int*>(sv + 2 * kTile);  // [n] when masked

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int win = blockIdx.z;
  const bool masked = ids != nullptr;

  const __nv_bfloat16* qb = q + win * qs.b + head * qs.h;
  const __nv_bfloat16* kb = k + win * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + win * vs.b + head * vs.h;
  const int n_tiles = (n + kBlock - 1) / kBlock;

  load_tile<kD>(sq, qb, qs.n, q0, n, tid);
  load_tile<kD>(sk, kb, ks.n, 0, n, tid);
  load_tile<kD>(sv, vb, vs.n, 0, n, tid);
  cp_async_commit();

  // The window's region ids; visible to every warp after the first
  // __syncthreads of the loop.
  if (masked) {
    const int* wid = ids + static_cast<long long>(win % nw) * n;
    for (int i = tid; i < n; i += kThreads) {
      sid[i] = wid[i];
    }
  }

  // This thread's two q rows (g and g + 8 of the warp's 16); rows past n
  // read row n - 1 and are never stored.
  const int row0 = min(q0 + warp * 16 + g, n - 1);
  const int row1 = min(q0 + warp * 16 + g + 8, n - 1);
  const float* bias0 = bias + (static_cast<long long>(head) * n + row0) * n;
  const float* bias1 = bias + (static_cast<long long>(head) * n + row1) * n;
  int id0 = 0;
  int id1 = 0;

  uint32_t qf[kD / 16][4];
  float o[kD / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<kD>(sk + (cur ^ 1) * kTile, kb, ks.n, (it + 1) * kBlock, n,
                    tid);
      load_tile<kD>(sv + (cur ^ 1) * kTile, vb, vs.n, (it + 1) * kBlock, n,
                    tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
      load_a_frags<kD>(qf, sq, warp, g, t);
      if (masked) {
        id0 = sid[row0];
        id1 = sid[row1];
      }
    }

    float s[kBlock / 8][4] = {};
    mma_a_rowsT<kD>(s, qf, sk + cur * kTile, g, t);

    // Scale into base 2, add the bias and the mask, set keys past n to
    // -inf, take the row max.
    const int key0 = it * kBlock;
    float mx0 = m[0];
    float mx1 = m[1];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + 2 * t + e;
        const bool ok = key < n;
        const int kk = min(key, n - 1);
        float add0 = __ldg(bias0 + kk) * kLog2e;
        float add1 = __ldg(bias1 + kk) * kLog2e;
        if (masked) {
          const int idk = sid[kk];
          add0 += idk == id0 ? 0.f : kMaskedLog2;
          add1 += idk == id1 ? 0.f : kMaskedLog2;
        }
        s[j][e] = ok ? fmaf(s[j][e], scale_log2, add0) : -INFINITY;
        s[j][2 + e] = ok ? fmaf(s[j][2 + e], scale_log2, add1) : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile holds a key < n, whose logit is finite (masked or not), so
    // mx0/mx1 are finite here.
    const float alpha0 = exp2f(m[0] - mx0);
    const float alpha1 = exp2f(m[1] - mx1);
    m[0] = mx0;
    m[1] = mx1;

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
    for (int dn = 0; dn < kD / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }

    mma_p_rows<kD>(o, pf, sv + cur * kTile, lane);
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 1);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 2);

  const long long row_elems = static_cast<long long>(heads) * kD;
  store_rows<kD>(out + static_cast<long long>(win) * n * row_elems + head * kD,
                 row_elems, o, q0 + warp * 16, n, g, t, 1.f / l[0],
                 1.f / l[1]);
}

}  // namespace mma

}  // namespace

// q, k, v: [BW, N, H, 32] bf16 with the given window/token/head strides (in
// elements, last stride 1, 16-byte aligned pointers and strides),
// 1 <= N <= 1024. bias: contiguous [H, N, N] f32. ids: contiguous [nw, N]
// int32 with BW a multiple of nw, or null for no mask. out: contiguous
// [BW, N, H * 32] bf16. N <= 144 runs window_fwd_sm90_kernel, larger N the
// mma.sync window_fwd_kernel. Launches on `stream`; returns
// cudaGetLastError(), cuTensorMapEncodeTiled's result if a tensor map cannot
// be encoded, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int window_attn_fwd_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* ids, void* out, int batch, int n, int heads, int head_dim,
    int nw, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, float scale, void* stream) {
  if (n <= 0 || n > kMaxTokens || batch <= 0 || batch > 65535 || heads <= 0 ||
      heads > 65535 || head_dim != kD ||
      (ids != nullptr && (nw <= 0 || batch % nw != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const flash::Strides qs{q_sb, q_sn, q_sh};
  const flash::Strides ks{k_sb, k_sn, k_sh};
  const flash::Strides vs{v_sb, v_sn, v_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  if (n <= w90::kN) {
    return w90::run(q, k, v, bias, ids, out, batch, n, heads, nw, qs, ks, vs,
                    scale, st);
  }
  // 5 tiles of 64 x 40 bf16 (25,600 B) and the ids: under the 48 KB a block
  // gets without opting in.
  const size_t smem = 5 * flash::Tile<kD>::kElems * sizeof(__nv_bfloat16) +
                      (ids != nullptr ? n * sizeof(int) : 0);
  const dim3 grid((n + flash::kBlock - 1) / flash::kBlock, heads, batch);
  mma::window_fwd_kernel<<<grid, flash::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(ids), static_cast<__nv_bfloat16*>(out), n, heads,
      ids != nullptr ? nw : 1, qs, ks, vs, scale * flash::kLog2e);
  return static_cast<int>(cudaGetLastError());
}
