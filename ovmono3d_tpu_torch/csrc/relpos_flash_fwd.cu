// Decomposed relative-position flash attention, forward, for Hopper
// (sm_90a): bf16 q/k/v/out, f32 bias factors, f32 online softmax.
//
// Replaces the TPU kernel _relpos_flash_kernel of ovmono3d_tpu/ops/
// attention.py (behind rel_pos_flash_attention), which every block of the
// SAM image encoder runs (segment_anything add_decomposed_rel_pos). Per
// (batch, head), over an (gh, gw) token grid with N = gh * gw:
//
//     s_ij  = scale * q_i.k_j + qrh[i, j / gw] + qrw[i, j % gw]
//     out_i = sum_j softmax_j(s_ij) v_j
//
// with scale = D^-1/2; the bias factors qrh [B, N, H, gh] and qrw [B, N, H,
// gw] (f32, q_i . Rh[r_i, a] and q_i . Rw[c_i, a]) are computed outside and
// are not scaled. q, k and v are strided views of the qkv projection's
// output [B, N, 3, H, D]; out is a contiguous [B, N, H * D] that the output
// projection reads as it is. D is 64 or 80 (SAM ViT-B/L and ViT-H), one
// template instance each; gh + gw is at most 128.
//
// Two instances of each: inference (relpos_flash_fwd_bf16) and training
// (relpos_flash_fwd_lse_bf16, kWriteLse), which also writes the row
// log-sum-exp of the biased logits, lse = m + log(l) ([B, H, N] f32,
// natural log, unclamped: kernel 3's unit), for csrc/relpos_flash_bwd.cu.
// The flag is a template argument and lse the kernel's last parameter, so
// the inference instance carries no lse code and builds as before.
//
// What bounds it on this card: at the SAM ViT-H global blocks (N = 4096,
// H = 16, D = 80) the QK^T and PV tensor-core work, 4*N^2*D flops per
// (batch, head); at the 14x14 windowed blocks (N = 196) the bytes of q, k, v,
// out and the bias factors. The N x N logits and their bias never leave the
// SM.
//
// What the design does about it: kernel 1's wgmma + TMA structure
// (flash_fwd_sm90_kernel in csrc/flash_attn_fwd.cu, on csrc/
// sm90_common.cuh): a persistent grid of one block of three warpgroups an
// SM, each block looping over work units of (128-row q tile, head, batch);
// warpgroup 0 the producer (one thread issues every TMA load; setmaxnreg 40
// for it, 232 for the others), warpgroups 1 and 2 consumers of 64 q rows
// each. Q is loaded once a unit and released after its last QK^T; K and V
// stream through a ring of three 128-key stages with full and empty
// mbarriers. Each consumer issues tile i's QK^T with tile i - 1's PV and
// runs tile i's softmax once both have landed, beside the other consumer's
// products (waiting for the PV frees P's registers for the bias; in kernel
// 1 that overlap was worth 1-4%, PERF.md). S = Q K^T is wgmma
// m64n128k16 with both operands in shared memory; P is rounded to bf16 in
// registers in wgmma's A-fragment layout and O += P V reads V as an
// MN-major operand.
//
// D = 80: a 160-byte row does not fit one 128-byte swizzle line, so every
// Q, K and V tile is stored as D / 16 blocks of 16 columns with the 32-byte
// swizzle (32-byte rows, 8-row atoms), each block one TMA box of the
// view's one tensor map. QK^T is D / 16 k16 steps, one a block, both
// operands K-major; PV is one m64nDk16 product a 16-key step, V read
// MN-major across its blocks (the descriptor's leading offset is the
// block stride), so O's 80 columns take one instruction. D = 64 runs the
// same code over 4 blocks.
//
// The bias on the accumulator layout: each consumer holds its 64 rows of qrh
// and qrw (gh + gw floats a row) in shared memory with rows g and g + 8 of a
// warp side by side, so one 8-byte read gives a key's term for both rows of a
// thread, and one 16-byte read the column terms of its two neighbouring keys
// (padded so a warp's reads hit different banks). The next unit's rows are
// copied in with cp.async as soon as the last softmax of a unit has read the
// table, so the copies overlap that unit's last PV and epilogue. Per logit the
// consumer adds bh[i][j / gw] + bw[i][j % gw] (j / gw by an f32 reciprocal,
// exact for N < 2^21) as it scales the logit. Shared memory: Q, three K/V
// stages (20 KB each of K and V at D = 80) and the two bias tables (68 KB),
// 208 KB.
//
// Softmax: online, with a running row max, the exponentials as ex2.approx
// of log2(e) times the argument: exact for any logit range, with no clamp.
//
// Edges: rows and keys past N arrive as zeros (TMA's out-of-bounds fill;
// N = 196 is one full and one partial tile), keys past N are set to -inf
// before the row max and q rows past N are not written. Zero-padded tokens
// of the window partition are real tokens inside N and are not masked.
//
// Not yet: fewer shared-memory reads of the bias (a grid width that
// divides the 128-key tile repeats a thread's column terms every tile).

#include "flash_common.cuh"
#include "sm90_common.cuh"

#include <algorithm>
#include <cmath>

namespace {

using flash::kLn2;
using flash::kLog2e;
using flash::pack_bf16;
using flash::Strides;
using sm90::ex2;
using sm90::load_box;
using sm90::MapDims;

constexpr int kRows = 128;                  // q rows a block
constexpr int kKeys = 128;                  // keys a K/V stage
constexpr int kStages = 3;
constexpr int kConsumers = 2;               // warpgroups of 64 q rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlk = 16;                    // columns a 32-byte block
constexpr int kMaxD = 80;
constexpr int kBlkBytes = kKeys * kBlk * 2; // one block of a tile: 4 KB
constexpr int kTileElems = kKeys * kMaxD;   // a tile: D / 16 blocks
constexpr int kMaxBias = 128;               // gh + gw
// A consumer's bias table: 32 row pairs (rows g and g + 8 of a warp), each
// 2 (gh + gw) floats padded to 16 more than a multiple of 32 (pair_stride).
constexpr int kBiasFloats = 32 * (2 * kMaxBias + 16);
constexpr int kProducerRegs = 24;          // its one thread issues loads
constexpr int kConsumerRegs = 240;
// The launch gives every thread 168 registers (65536 / 384, in steps of
// 8); setmaxnreg asking the warpgroups for more than that in all waits
// forever.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  kLaunchRegs * kThreads,
              "setmaxnreg beyond the launch allocation waits forever");
static_assert(kRows == kKeys, "one TMA box shape serves Q, K and V");

// A tile is [D / 16 blocks][128 rows][16 columns]; every block is 4 KB, so
// each stays aligned to the 256-byte swizzle atom when the struct is.
struct Smem {
  __nv_bfloat16 q[kTileElems];
  __nv_bfloat16 k[kStages][kTileElems];
  __nv_bfloat16 v[kStages][kTileElems];
  float bias[kConsumers][kBiasFloats];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_full[kStages];
  uint64_t v_empty[kStages];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;

// The tensor maps of q, k and v: boxes of 16 columns x 128 rows.
struct Maps {
  CUtensorMap q, k, v;
};
struct Dims {
  MapDims q, k, v;
};

// S = Q K^T, one warpgroup: 64 rows x 128 keys (S is overwritten); D / 16
// k-steps of 16, one a 4 KB block of Q and of K.
template <int D>
__device__ __forceinline__ void qk(float (&s)[64], uint64_t desc_q,
                                   uint64_t desc_k) {
#pragma unroll
  for (int b = 0; b < D / kBlk; ++b) {
    sm90::wgmma_m64n128k16_ss(s, desc_q + b * (kBlkBytes >> 4),
                              desc_k + b * (kBlkBytes >> 4), b);
  }
}

// O += P V, one warpgroup: P 64 x 128 from registers, O 64 x D; eight
// k-steps of 16 keys (V is MN-major, rows are keys: a step moves 16 rows of
// 32 bytes, across all its blocks).
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&p)[kKeys / 16][4],
                                   uint64_t desc_v) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t d = desc_v + kk * (16 * kBlk * 2 >> 4);
    if constexpr (D == 80) {
      sm90::wgmma_m64n80k16_rs(o, p[kk], d, 1);
    } else {
      sm90::wgmma_m64n64k16_rs(o, p[kk], d, 1);
    }
  }
}

// The descriptors of a K tile (K-major) and a V tile (MN-major: the
// leading offset is the 4 KB block stride), pinned in registers.
__device__ __forceinline__ uint64_t k_desc(const __nv_bfloat16* tile) {
  uint64_t d = sm90::desc_sw32(tile, 16, 256);
  sm90::fence_operand(d);
  return d;
}

__device__ __forceinline__ uint64_t v_desc(const __nv_bfloat16* tile) {
  uint64_t d = sm90::desc_sw32(tile, kBlkBytes, 256);
  sm90::fence_operand(d);
  return d;
}

__device__ __forceinline__ void fence_p(uint32_t (&p)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    sm90::fence_operands(p[kk]);
  }
}

// Copies 4 bytes from global `src` to shared `dst` asynchronously, or
// writes zeros when `valid` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The floats between two row pairs of a consumer's bias table: 16 more than
// a multiple of 32, so the 16-byte reads of a quarter warp (2 pairs x 4
// threads 2 columns apart) and the 8-byte reads of a half warp fall on
// different banks.
__device__ __forceinline__ int pair_stride(int gh, int gw) {
  return (2 * (gh + gw) + 31) / 32 * 32 + 16;
}

// Starts the copies of a unit's rows of qrh and qrw into a consumer's bias
// table: entry a (a < gh the row terms, then the gw column terms) of local row
// r = 16 w + 8 h + g at tab[(8 w + g) * pair_stride + 2 a + h], so a thread's
// rows g and g + 8 sit side by side; rows past n read as zeros. Each warp
// takes rows warp + 4 i, its lanes along a. The values are raw: add_bias
// scales them into base 2. cp.async needs no registers for the data, so all
// the copies are in flight together; the caller waits for them
// (cp.async.wait_group) before the table is read.
__device__ __forceinline__ void fill_bias(float* __restrict__ tab,
                                          const float* __restrict__ qrh,
                                          const float* __restrict__ qrw,
                                          int row0, int n, int heads,
                                          int head, int batch, int gh,
                                          int gw, int warp, int lane) {
  for (int a = lane; a < gh + gw; a += 32) {
    const bool is_h = a < gh;
    const int width = is_h ? gh : gw;
    // Row row0 + warp + 4 i of (batch, head) at src + i * step.
    const float* src =
        (is_h ? qrh + a : qrw + (a - gh)) +
        ((static_cast<long long>(batch) * n + row0 + warp) * heads + head) *
            width;
    const long long step = 4LL * heads * width;
    const int ps = pair_stride(gh, gw);
    // Not unrolled: the copies need no registers once issued, and their
    // addresses would otherwise all be live at once.
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const int r = warp + 4 * i;
      const bool valid = row0 + r < n;
      cp_async_4(tab + ((r >> 4) * 8 + (r & 7)) * ps + 2 * a + ((r >> 3) & 1),
                 valid ? src + i * step : qrh, valid);
    }
  }
  flash::cp_async_commit();
}

// Scales one logit tile and adds its bias, rows g and g + 8 of the
// thread's warp (`tab` at the thread's row pair), keys key0 + x for
// x = 8 j + 2 t + e; with kMasked, keys at or past `valid` (relative to
// key0) become -inf. j / gw by an f32 reciprocal, exact for keys < 2^21.
// With gh and gw even (kEven), a thread's two keys of a j share their row
// term and have neighbouring column terms: one 8-byte read of the row
// terms and one 16-byte read of the column terms serve the 4 logits. Else
// each key takes two 8-byte reads.
template <bool kMasked, bool kEven>
__device__ __forceinline__ void add_bias(float (&s)[64], const float* tab,
                                         int key0, int valid, int gh, int gw,
                                         float inv_gw, int t, float scale) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const int x = 8 * j + 2 * t;
    if constexpr (kEven) {
      // An even key and the next one: one row of the grid, since gw is
      // even; clamped to an even key below n.
      const int key = key0 + (kMasked ? min(x, (valid - 1) & ~1) : x);
      const int kr = static_cast<int>((key + 0.5f) * inv_gw);
      const float2 bh = *reinterpret_cast<const float2*>(tab + 2 * kr);
      const float4 bw = *reinterpret_cast<const float4*>(
          tab + 2 * (gh + key - kr * gw));
      s[4 * j] = fmaf(s[4 * j], scale, bh.x + bw.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], scale, bh.x + bw.z);
      s[4 * j + 2] = fmaf(s[4 * j + 2], scale, bh.y + bw.y);
      s[4 * j + 3] = fmaf(s[4 * j + 3], scale, bh.y + bw.w);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + (kMasked ? min(x + e, valid - 1) : x + e);
        const int kr = static_cast<int>((key + 0.5f) * inv_gw);
        const float2 bh = *reinterpret_cast<const float2*>(tab + 2 * kr);
        const float2 bw = *reinterpret_cast<const float2*>(
            tab + 2 * (gh + key - kr * gw));
        s[4 * j + e] = fmaf(s[4 * j + e], scale, bh.x + bw.x);
        s[4 * j + 2 + e] = fmaf(s[4 * j + 2 + e], scale, bh.y + bw.y);
      }
    }
    if (kMasked) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (x + e >= valid) {
          s[4 * j + e] = -INFINITY;
          s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
    // The compiler may not hoist later reads above here: a tile's 32 or
    // 64 reads in flight at once would take more registers than the
    // consumer has.
    asm volatile("" ::: "memory");
  }
}

// The online softmax of one biased logit tile in place: the new running
// max m, alpha = exp(m_old - m_new) for O, S replaced by P = exp(S - m) in
// f32 (as exp2 of log2(e) times the argument), and the row sums l rescaled
// and increased by this tile's f32 probabilities. Maxima and sums run in
// two partial chains a row (4 registers, where kernel 1's trees take 32:
// this kernel's consumers also hold the bias reads and a wider O).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  float a0[2], a1[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    a0[c] = fmaxf(s[4 * c], s[4 * c + 1]);
    a1[c] = fmaxf(s[4 * c + 2], s[4 * c + 3]);
  }
#pragma unroll
  for (int j = 2; j < kKeys / 8; ++j) {
    a0[j % 2] = fmaxf(a0[j % 2], fmaxf(s[4 * j], s[4 * j + 1]));
    a1[j % 2] = fmaxf(a1[j % 2], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx0 = fmaxf(m0, fmaxf(a0[0], a0[1]));
  float mx1 = fmaxf(m1, fmaxf(a1[0], a1[1]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // Every tile holds a key < n, so mx0/mx1 are finite here and the first
  // tile's alpha is exp2(-inf) = 0.
  alpha0 = ex2((m0 - mx0) * kLog2e);
  alpha1 = ex2((m1 - mx1) * kLog2e);
  m0 = mx0;
  m1 = mx1;
  const float ms0 = mx0 * kLog2e;
  const float ms1 = mx1 * kLog2e;
  a0[0] = a0[1] = a1[0] = a1[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], kLog2e, -ms0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], kLog2e, -ms0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], kLog2e, -ms1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], kLog2e, -ms1));
    a0[j % 2] += s[4 * j] + s[4 * j + 1];
    a1[j % 2] += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + (a0[0] + a0[1]);
  l1 = l1 * alpha1 + (a1[0] + a1[1]);
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

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// Rows r0 and r0 + 8 (when below n) of an accumulator block, scaled by
// 1/l, as bf16 pairs at columns 8 j of `ob` (the thread's first column).
template <int N>
__device__ __forceinline__ void store_rows(const float (&o)[N],
                                           __nv_bfloat16* ob,
                                           long long row_elems, int r0, int n,
                                           float inv0, float inv1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(ob + r0 * row_elems + 8 * j) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (r0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * row_elems + 8 * j) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

struct Problem {
  const float* qrh;
  const float* qrw;
  __nv_bfloat16* out;
  int n, heads, gh, gw, q_tiles, units;
  float scale, inv_gw;
};

// Bias and softmax of tile `it` (keys it * kKeys ..) on the landed S, with
// the consumer's bias table `tab`.
__device__ __forceinline__ void tile_softmax(float (&s)[64], const float* tab,
                                             const Problem& pr, int it,
                                             int lane, int warp, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  const int t = lane & 3;
  tab += (warp * 8 + (lane >> 2)) * pair_stride(pr.gh, pr.gw);
  // Opaque to the compiler: with the first tile's key0 known to be 0 it
  // would compute that tile's key indices ahead, across the waits, and
  // spill them.
  int key0 = it * kKeys;
  asm volatile("" : "+r"(key0));
  const int valid = pr.n - key0;
  const bool even = ((pr.gh | pr.gw) & 1) == 0;
  if (valid < kKeys) {
    if (even) {
      add_bias<true, true>(s, tab, key0, valid, pr.gh, pr.gw, pr.inv_gw, t,
                           pr.scale);
    } else {
      add_bias<true, false>(s, tab, key0, valid, pr.gh, pr.gw, pr.inv_gw,
                            t, pr.scale);
    }
  } else if (even) {
    add_bias<false, true>(s, tab, key0, valid, pr.gh, pr.gw, pr.inv_gw, t,
                          pr.scale);
  } else {
    add_bias<false, false>(s, tab, key0, valid, pr.gh, pr.gw, pr.inv_gw, t,
                           pr.scale);
  }
  softmax_tile(s, m0, m1, l0, l1, alpha0, alpha1);
}

// Starts the copies of the bias rows of the consumer's 64 rows of unit u.
__device__ __forceinline__ void fill_unit(float* tab, const Problem& pr,
                                          int u, int cw, int warp,
                                          int lane) {
  fill_bias(tab, pr.qrh, pr.qrw, (u % pr.q_tiles) * kRows + cw * 64, pr.n,
            pr.heads, (u / pr.q_tiles) % pr.heads,
            u / (pr.q_tiles * pr.heads), pr.gh, pr.gw, warp, lane);
}

// One consumer warpgroup: 64 q rows of each of the block's work units
// (q tile, head, batch) against every K/V stage, as kernel 1's consumer.
// The next unit's bias rows are copied into the table once every warp's
// last softmax of this unit has read it, so the copies run during this
// unit's last PV and epilogue and the next unit's first QK^T.
template <int D, bool kWriteLse>
__device__ __forceinline__ void consume(Smem& sm, const Problem& pr,
                                        float* __restrict__ lse) {
  const int ctid = threadIdx.x - 128;
  const int cw = ctid / 128;                // rows 64 cw .. 64 cw + 63
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int t = lane & 3;
  float* tab = sm.bias[cw];
  const int bar = 1 + cw;                   // this consumer's named barrier
  const __nv_bfloat16* q_rows = sm.q + cw * 64 * kBlk;
  float sacc[64];
  uint32_t p[kKeys / 16][4];

  // After a unit's last softmax: every warp is done with the table, then
  // the copies of the block's next unit start.
  const auto refill = [&](int u) {
    sm90::named_barrier(bar, 128);
    if (u + static_cast<int>(gridDim.x) < pr.units) {
      fill_unit(tab, pr, u + gridDim.x, cw, warp, lane);
    }
  };
  fill_unit(tab, pr, blockIdx.x, cw, warp, lane);
  for (int u = blockIdx.x; u < pr.units; u += gridDim.x) {
    // The key tiles, units done and K/V tiles consumed so far, recomputed
    // every unit: no counter is carried across the loop (registers are
    // tight; the asm keeps the compiler from hoisting n_tiles).
    int n_tiles = pr.n;
    asm volatile("" : "+r"(n_tiles));
    n_tiles = (n_tiles + kKeys - 1) / kKeys;
    const int i = (u - static_cast<int>(blockIdx.x)) / gridDim.x;
    const int c = i * n_tiles;
    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      o[j] = 0.f;
    }
    float m0 = -INFINITY;                   // running max (base 2), rows
    float m1 = -INFINITY;                   // g and g + 8
    float l0 = 0.f;                         // this thread's partial row sums
    float l1 = 0.f;
    float alpha0, alpha1;

    sm90::mbar_wait(&sm.q_full, i & 1);
    // Tile 0: S and its softmax; its PV goes out with tile 1's QK^T.
    const int s0 = c % kStages;
    sm90::mbar_wait(&sm.k_full[s0], (c / kStages) & 1);
    const uint64_t dk0 = k_desc(sm.k[s0]);
    sm90::fence_operands(sacc);
    sm90::wgmma_fence();
    qk<D>(sacc, sm90::desc_sw32(q_rows, 16, 256), dk0);
    sm90::wgmma_commit();
    flash::cp_async_wait<0>();
    sm90::named_barrier(bar, 128);          // every warp's copies landed
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sacc);
    if (lane == 0) {
      sm90::mbar_arrive(&sm.k_empty[s0]);   // this warp is done with K
      if (n_tiles == 1) {
        sm90::mbar_arrive(&sm.q_empty);     // and with Q
      }
    }
    tile_softmax(sacc, tab, pr, 0, lane, warp, m0, m1, l0, l1, alpha0,
                 alpha1);
    pack_p(sacc, p);
    if (n_tiles == 1) {
      refill(u);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int g = c + it;
      const int s = g % kStages;
      const int sp = (g - 1) % kStages;
      sm90::mbar_wait(&sm.k_full[s], (g / kStages) & 1);
      sm90::mbar_wait(&sm.v_full[sp], ((g - 1) / kStages) & 1);
      const uint64_t dk = k_desc(sm.k[s]);
      const uint64_t dv = v_desc(sm.v[sp]);
      sm90::fence_operands(sacc);
      sm90::fence_operands(o);
      fence_p(p);
      sm90::wgmma_fence();
      qk<D>(sacc, sm90::desc_sw32(q_rows, 16, 256), dk);
      pv<D>(o, p, dv);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();                // both landed: P is free
      sm90::fence_operands(sacc);
      sm90::fence_operands(o);
      fence_p(p);
      if (lane == 0) {
        sm90::mbar_arrive(&sm.k_empty[s]);
        sm90::mbar_arrive(&sm.v_empty[sp]);
        if (it == n_tiles - 1) {
          sm90::mbar_arrive(&sm.q_empty);
        }
      }
      tile_softmax(sacc, tab, pr, it, lane, warp, m0, m1, l0, l1, alpha0,
                   alpha1);
      rescale(o, alpha0, alpha1);
      pack_p(sacc, p);
      if (it == n_tiles - 1) {
        refill(u);
      }
    }
    const int gl = c + n_tiles - 1;
    const int sl = gl % kStages;
    sm90::mbar_wait(&sm.v_full[sl], (gl / kStages) & 1);
    const uint64_t dvl = v_desc(sm.v[sl]);
    sm90::fence_operands(o);
    fence_p(p);
    sm90::wgmma_fence();
    pv<D>(o, p, dvl);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);
    if (lane == 0) {
      sm90::mbar_arrive(&sm.v_empty[sl]);
    }

    // Row sums live split over the 4 threads of each row group.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;

    const int head = (u / pr.q_tiles) % pr.heads;
    const int batch = u / (pr.q_tiles * pr.heads);
    const long long row_elems = static_cast<long long>(pr.heads) * D;
    __nv_bfloat16* ob =
        pr.out + static_cast<long long>(batch) * pr.n * row_elems + head * D;
    const int r0 =
        (u % pr.q_tiles) * kRows + cw * 64 + warp * 16 + (lane >> 2);
    store_rows(o, ob + 2 * t, row_elems, r0, pr.n, inv0, inv1);
    if constexpr (kWriteLse) {
      // log(sum_j exp(s_j)) = ln2 * (m log2(e) + log2(l)), m the row max.
      float* lb = lse + (static_cast<long long>(batch) * pr.heads + head) *
                            pr.n;
      if (t == 0 && r0 < pr.n) {
        lb[r0] = (m0 * kLog2e + log2f(l0)) * kLn2;
      }
      if (t == 0 && r0 + 8 < pr.n) {
        lb[r0 + 8] = (m1 * kLog2e + log2f(l1)) * kLn2;
      }
    }
  }
}

// A Q, K or V tile (128 rows from `row`) as its D / 16 blocks.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          const MapDims& md, uint64_t* bar,
                                          int head, int row, int batch) {
#pragma unroll
  for (int b = 0; b < D / kBlk; ++b) {
    load_box(dst + b * kKeys * kBlk, map, md, bar, head, row, batch,
             b * kBlk);
  }
}

// A persistent grid: block b takes the work units b, b + gridDim.x, ...
// (unit = q tile + q_tiles * (head + heads * batch)).
template <int D, bool kWriteLse>
__global__ void __launch_bounds__(kThreads, 1)
    relpos_fwd_sm90_kernel(const __grid_constant__ Maps maps, const Dims md,
                           const Problem pr, float* __restrict__ lse) {
  constexpr int kTileBytes = kKeys * D * 2;  // a Q, K or V tile
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int n_tiles = (pr.n + kKeys - 1) / kKeys;

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
      sm90::prefetch_tensormap(&maps.q);
      sm90::prefetch_tensormap(&maps.k);
      sm90::prefetch_tensormap(&maps.v);
      int c = 0;                            // K/V tiles loaded so far
      int i = 0;                            // units started
      for (int u = blockIdx.x; u < pr.units; u += gridDim.x, ++i) {
        const int q0 = (u % pr.q_tiles) * kRows;
        const int head = (u / pr.q_tiles) % pr.heads;
        const int b = u / (pr.q_tiles * pr.heads);
        // A fresh barrier passes a wait at parity 1: the first unit's Q
        // and the first round of stages go in at once.
        sm90::mbar_wait(&sm.q_empty, (i & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.q_full, kTileBytes);
        load_tile<D>(sm.q, &maps.q, md.q, &sm.q_full, head, q0, b);
        for (int it = 0; it < n_tiles; ++it, ++c) {
          const int s = c % kStages;
          const uint32_t parity = ((c / kStages) & 1) ^ 1;
          const int key0 = it * kKeys;
          sm90::mbar_wait(&sm.k_empty[s], parity);
          sm90::mbar_expect_tx(&sm.k_full[s], kTileBytes);
          load_tile<D>(sm.k[s], &maps.k, md.k, &sm.k_full[s], head, key0, b);
          sm90::mbar_wait(&sm.v_empty[s], parity);
          sm90::mbar_expect_tx(&sm.v_full[s], kTileBytes);
          load_tile<D>(sm.v[s], &maps.v, md.v, &sm.v_full[s], head, key0, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume<D, kWriteLse>(sm, pr, lse);
  }
}

template <int D, bool kWriteLse>
int launch(const Maps& maps, const Dims& md, const Problem& pr, float* lse,
           cudaStream_t stream) {
  auto* kernel = relpos_fwd_sm90_kernel<D, kWriteLse>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  // One block an SM (its shared memory allows no second), each looping
  // over work units.
  kernel<<<std::min(pr.units, sms), kThreads, kSmemBytes, stream>>>(
      maps, md, pr, lse);
  return static_cast<int>(cudaGetLastError());
}

// The shared body of the two C entries: checks, tensor maps, the launch of
// the instance for D and for whether `lse` is given.
int run(const void* q, const void* k, const void* v, const void* qrh,
        const void* qrw, void* out, float* lse, int batch, int n, int heads,
        int head_dim, int gh, int gw, const Strides& qs, const Strides& ks,
        const Strides& vs, float scale, void* stream) {
  if (n <= 0 || n >= (1 << 21) || batch <= 0 || heads <= 0 || gh <= 0 ||
      gw <= 0 || gh * gw != n || gh + gw > kMaxBias ||
      (head_dim != 64 && head_dim != 80)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units =
      static_cast<long long>((n + kRows - 1) / kRows) * heads * batch;
  if (units > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps;
  Dims md;
  // Boxes of 16 columns x 128 rows with the 32-byte swizzle.
  const auto encode = [&](CUtensorMap* map, MapDims* dims, const void* base,
                          const Strides& st) {
    return sm90::encode_view(map, dims, base, batch, n, heads, st.b, st.n,
                             st.h, head_dim, kBlk, kKeys,
                             CU_TENSOR_MAP_SWIZZLE_32B);
  };
  int rc = encode(&maps.q, &md.q, q, qs);
  if (rc == 0) {
    rc = encode(&maps.k, &md.k, k, ks);
  }
  if (rc == 0) {
    rc = encode(&maps.v, &md.v, v, vs);
  }
  if (rc != 0) {
    return rc;
  }
  const Problem pr{static_cast<const float*>(qrh),
                   static_cast<const float*>(qrw),
                   static_cast<__nv_bfloat16*>(out),
                   n,
                   heads,
                   gh,
                   gw,
                   (n + kRows - 1) / kRows,
                   static_cast<int>(units),
                   scale,
                   1.f / gw};
  const auto st = static_cast<cudaStream_t>(stream);
  if (lse == nullptr) {
    return head_dim == 64 ? launch<64, false>(maps, md, pr, nullptr, st)
                          : launch<80, false>(maps, md, pr, nullptr, st);
  }
  return head_dim == 64 ? launch<64, true>(maps, md, pr, lse, st)
                        : launch<80, true>(maps, md, pr, lse, st);
}

}  // namespace

// q, k, v: [B, N, H, D] bf16 with the given batch/token/head strides (in
// elements, last stride 1, 16-byte aligned pointers and strides), D in
// {64, 80}, N = gh * gw < 2^21, gh + gw <= 128. qrh: contiguous
// [B, N, H, gh] f32; qrw: contiguous [B, N, H, gw] f32. out: contiguous
// [B, N, H * D] bf16. Launches on `stream`; returns cudaGetLastError(),
// cuTensorMapEncodeTiled's result if a tensor map cannot be encoded, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int relpos_flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* qrh,
    const void* qrw, void* out, int batch, int n, int heads, int head_dim,
    int gh, int gw, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, void* stream) {
  return run(q, k, v, qrh, qrw, out, nullptr, batch, n, heads, head_dim, gh,
             gw, Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
             Strides{v_sb, v_sn, v_sh}, scale, stream);
}

// The training forward: the same, and the row log-sum-exp of the biased
// logits into `lse`, a contiguous [B, H, N] f32 (natural log, unclamped:
// kernel 3's unit), which relpos_flash_bwd.cu reads.
extern "C" int relpos_flash_fwd_lse_bf16(
    const void* q, const void* k, const void* v, const void* qrh,
    const void* qrw, void* out, void* lse, int batch, int n, int heads,
    int head_dim, int gh, int gw, long long q_sb, long long q_sn,
    long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale,
    void* stream) {
  if (lse == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(q, k, v, qrh, qrw, out, static_cast<float*>(lse), batch, n,
             heads, head_dim, gh, gw, Strides{q_sb, q_sn, q_sh},
             Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh}, scale,
             stream);
}
