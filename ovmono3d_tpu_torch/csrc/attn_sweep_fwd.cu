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
// the key block: the S tile is kBlockK keys wide, and the plain version
// (attn_sweep_ref) runs the same recurrence over the same blocks. exp(x) is
// ex2.approx(x log2 e) at the rounding points above, within a few parts in
// a million of exp of the same argument. The q block only tiles the rows:
// every row runs the same instructions in the same order whatever kBlockQ
// is, so the outputs of two instances that differ only in kBlockQ are
// bit-identical.
//
// What bounds it on this card: the QK^T and PV products, 4 N^2 D flops per
// (batch, head): 0.0521 ms at the probe's [1, 4097, 12, 64] on the bf16
// tensor cores, against ~25 MB of q, k, v and out (0.0075 ms at 3.35 TB/s).
// As in kernel 1, the softmax at D = 64 costs about as much as the
// products, and the sweep's costs more: a subtraction before each
// exponential and, with a bf16 softmax, three more roundings a logit (two
// values a conversion).
//
// Design (flash_fwd_sm90_kernel's, csrc/flash_attn_fwd.cu, on the blocks of
// sm90_common.cuh): a persistent grid whose blocks loop over work units of
// (kBlockQ-row q tile, head, batch). Warpgroup 0 is the producer: it gives
// its registers to the others (setmaxnreg) and one of its threads issues
// every TMA load: Q once a unit, K and V through a ring of kBlockK-key
// stages, each with a full and an empty mbarrier. Each further warpgroup is
// a consumer of 64 q rows: kBlockQ = 128 is two consumers on one K/V
// stream, one block an SM; kBlockQ = 64 is one consumer, two blocks an SM,
// each on its own units. A consumer first rounds its rows of Q to
// q' = bf16(q * scale) in shared memory (then a proxy fence, so wgmma reads
// the new values), then runs S = q' K^T as wgmma m64n{kBlockK}k16 with both
// operands in shared memory, the sweep's softmax in registers on S's
// accumulator layout, and O += P V as wgmma m64n64k16 with P rounded to
// bf16 A fragments in registers and V read as an MN-major operand. Tile
// i's QK^T goes out with tile i - 1's PV and tile i's softmax runs while
// that PV is in flight; P is packed and O rescaled once the PV has landed.
// The loads use one 4-D tensor map per operand over the caller's view (q, k
// and v as strided [B, N, H, 64] views); rows past N arrive as zeros (TMA's
// out-of-bounds fill) and take the -1e30 mask. out is a contiguous
// [B, N, H, 64], written straight from the O registers.

#include "flash_common.cuh"
#include "sm90_common.cuh"

#include <algorithm>
#include <cmath>

namespace {

using flash::pack_bf16;
using flash::Strides;
using sm90::load_box;
using sm90::MapDims;

constexpr int kD = 64;
constexpr float kNegInf = -1e30f;
constexpr int kProducerRegs = 40;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// exp(x) as ex2.approx(x log2 e): the exponentials set the sweep's pace
// (with expf every instance took ~25% longer), and the approximation moves
// no instance past the limit its plain version holds it to (PERF.md).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * flash::kLog2e));
  return y;
}

// a, b = bf16(a), bf16(b), with one conversion for the pair.
__device__ __forceinline__ void round_bf16_pair(float& a, float& b) {
  const uint32_t w = pack_bf16(a, b);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

// The shape of one instance: kConsumers warpgroups of 64 q rows, kBlockK
// keys a K/V stage.
template <int kBlockK, int kConsumers>
struct Cfg {
  static constexpr int kBlockQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBlocksPerSm = kConsumers == 1 ? 2 : 1;
  static constexpr int kStages = kBlockK == 128 ? 3 : 4;
  static constexpr int kTileBytes = kBlockK * kD * 2;
  // The registers the launch gives a thread, the producer's share, and
  // what each consumer thread takes (setmaxnreg.inc waits forever past the
  // block's allocation).
  static constexpr int kLaunchRegs = 65536 / (kThreads * kBlocksPerSm);
  static constexpr int kConsumerRegs = kConsumers == 1 ? 216 : 232;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kThreads * (kLaunchRegs / 8 * 8),
                "the warpgroups ask for no more than the launch allocation");
  struct Smem {
    __nv_bfloat16 q[kBlockQ * kD];            // every tile is a multiple of
    __nv_bfloat16 k[kStages][kBlockK * kD];   // 8 KB: each stays 1024-byte
    __nv_bfloat16 v[kStages][kBlockK * kD];   // aligned (the swizzle atom)
    uint64_t q_full;
    uint64_t q_empty;
    uint64_t k_full[kStages];
    uint64_t k_empty[kStages];
    uint64_t v_full[kStages];
    uint64_t v_empty[kStages];
  };
  static constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
};

// The maximum (kMax) or the sum of r[0..2W) as a tree, in registers: each
// level folds the upper half onto the lower one (a level a template
// instance, so every index is a constant and r stays in registers).
template <bool kMax, int W, int N>
__device__ __forceinline__ float tree(float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    r[j] = kMax ? fmaxf(r[j], r[j + W]) : r[j] + r[j + W];
  }
  if constexpr (W > 1) {
    return tree<kMax, W / 2>(r);
  } else {
    return r[0];
  }
}

// q' = bf16(q * scale) in place over one consumer's 64 rows of Q (8 KB; the
// swizzle only permutes 16-byte chunks, so the elementwise pass ignores
// it), then a proxy fence and the warpgroup's barrier, so its wgmma reads
// q'.
__device__ __forceinline__ void scale_q(__nv_bfloat16* rows, float scale,
                                        int ctid, int cw) {
  uint4* p = reinterpret_cast<uint4*>(rows);
#pragma unroll
  for (int i = 0; i < 64 * kD / 8 / 128; ++i) {
    uint4 x = p[ctid + 128 * i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    p[ctid + 128 * i] = x;
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(1 + cw, 128);
}

// S = q' K^T over the stage's kBlockK keys (S is overwritten).
template <int kBlockK>
__device__ __forceinline__ void qk(float (&s)[kBlockK / 2],
                                   const uint64_t (&dq)[kD / 16],
                                   const uint64_t (&dk)[kD / 16]) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    if constexpr (kBlockK == 128) {
      sm90::wgmma_m64n128k16_ss(s, dq[kk], dk[kk], kk);
    } else {
      sm90::wgmma_m64n64k16_ss(s, dq[kk], dk[kk], kk);
    }
  }
}

// O += P V: P 64 x kBlockK bf16 from registers, V MN-major.
template <int kBlockK>
__device__ __forceinline__ void pv(float (&o)[32],
                                   const uint32_t (&p)[kBlockK / 16][4],
                                   const uint64_t (&dv)[kBlockK / 16]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    sm90::wgmma_m64n64k16_rs(o, p[kk], dv[kk], 1);
  }
}

template <int kBlockK>
__device__ __forceinline__ void fence_p(uint32_t (&p)[kBlockK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    sm90::fence_operands(p[kk]);
  }
}

// The sweep's softmax of one logit tile in place, rows g and g + 8 of the
// thread's warp (s[4j + e]: row g for e < 2, g + 8 otherwise; key
// 8j + 2t + (e & 1)): round to the softmax dtype, add the mask to keys at
// or past `valid`, the new running max m, alpha = exp(m_old - m), S
// replaced by p (bf16-rounded values for a bf16 softmax) and the row sums
// l rescaled and increased by p.
template <int kBlockK, bool kF32>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockK / 2],
                                             int valid, int t, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  constexpr int kJ = kBlockK / 8;
  if constexpr (!kF32) {
#pragma unroll
    for (int j = 0; j < 2 * kJ; ++j) {
      round_bf16_pair(s[2 * j], s[2 * j + 1]);
    }
  }
  if (valid < kBlockK) {
    // bf16(-1e30): the mask in the softmax dtype.
    const float mask = kF32 ? kNegInf : round_bf16(kNegInf);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * j + 2 * t + (e & 1) >= valid) {
          const float x = s[4 * j + e] + mask;
          s[4 * j + e] = kF32 ? x : round_bf16(x);
        }
      }
    }
  }
  float r0[kJ];
  float r1[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    r0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
    r1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
  float mx0 = tree<true, kJ / 2>(r0);
  float mx1 = tree<true, kJ / 2>(r1);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float m_new0 = fmaxf(m0, mx0);
  const float m_new1 = fmaxf(m1, mx1);
  alpha0 = exp_approx(m0 - m_new0);
  alpha1 = exp_approx(m1 - m_new1);
  m0 = m_new0;
  m1 = m_new1;
  const float mb0 = kF32 ? m_new0 : round_bf16(m_new0);
  const float mb1 = kF32 ? m_new1 : round_bf16(m_new1);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float mb = e < 2 ? mb0 : mb1;
      float x0 = s[4 * j + e] - mb;
      float x1 = s[4 * j + e + 1] - mb;
      if constexpr (!kF32) {
        round_bf16_pair(x0, x1);
      }
      x0 = exp_approx(x0);
      x1 = exp_approx(x1);
      if constexpr (!kF32) {
        round_bf16_pair(x0, x1);
      }
      s[4 * j + e] = x0;
      s[4 * j + e + 1] = x1;
    }
    r0[j] = s[4 * j] + s[4 * j + 1];
    r1[j] = s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + tree<false, kJ / 2>(r0);
  l1 = l1 * alpha1 + tree<false, kJ / 2>(r1);
}

// p (S's accumulator layout) rounded to bf16 A fragments for PV: p[kk]
// covers keys 16 kk .. 16 kk + 15.
template <int kBlockK>
__device__ __forceinline__ void pack_p(const float (&s)[kBlockK / 2],
                                       uint32_t (&p)[kBlockK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
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

// One consumer warpgroup: its 64 q rows of each of the block's work units
// against every K/V stage (flash_fwd_sm90_kernel's consumer loop with the
// sweep's rounding points). The K/V ring's position `c` runs on across
// units; Q is released after a unit's last QK^T.
template <int kBlockK, int kConsumers, bool kF32>
__device__ __forceinline__ void consume(
    typename Cfg<kBlockK, kConsumers>::Smem& sm,
    __nv_bfloat16* __restrict__ out, int n, int heads, int q_tiles,
    int units, float scale) {
  using C = Cfg<kBlockK, kConsumers>;
  constexpr int kStages = C::kStages;
  const int ctid = threadIdx.x - 128;
  const int cw = ctid / 128;                // rows 64 cw .. 64 cw + 63
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int t = lane & 3;
  const int n_tiles = (n + kBlockK - 1) / kBlockK;

  const uint64_t desc_q = sm90::desc_sw128(sm.q + cw * 64 * kD, 16, 1024);
  float sacc[kBlockK / 2];
  uint32_t p[kBlockK / 16][4];
  uint64_t dq[kD / 16], dk[kD / 16], dv[kBlockK / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    dq[kk] = desc_q + 2 * kk;               // 32 bytes along the 128-byte rows
  }
  const auto k_descs = [&](const __nv_bfloat16* tile) {
    const uint64_t base = sm90::desc_sw128(tile, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      dk[kk] = base + 2 * kk;
    }
    sm90::fence_operands(dq);
    sm90::fence_operands(dk);
  };
  const auto v_descs = [&](const __nv_bfloat16* tile) {
    const uint64_t base = sm90::desc_sw128(tile, C::kTileBytes, 1024);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      dv[kk] = base + kk * (16 * 128 >> 4);  // 16 key rows a step
    }
    sm90::fence_operands(dv);
  };

  int c = 0;                                // K/V tiles consumed so far
  int i = 0;                                // units done
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int q0 = (u % q_tiles) * C::kBlockQ;
    const int head = (u / q_tiles) % heads;
    const int batch = u / (q_tiles * heads);
    float o[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[j] = 0.f;
    }
    float m0 = kNegInf;                     // running row max, rows g, g + 8
    float m1 = kNegInf;
    float l0 = 0.f;                         // this thread's partial row sums
    float l1 = 0.f;
    float alpha0, alpha1;

    sm90::mbar_wait(&sm.q_full, i & 1);
    scale_q(sm.q + cw * 64 * kD, scale, ctid % 128, cw);
    // Tile 0: S and its softmax; its PV goes out with tile 1's QK^T.
    const int s0 = c % kStages;
    sm90::mbar_wait(&sm.k_full[s0], (c / kStages) & 1);
    k_descs(sm.k[s0]);
    sm90::fence_operands(sacc);
    sm90::wgmma_fence();
    qk<kBlockK>(sacc, dq, dk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sacc);
    if (lane == 0) {
      sm90::mbar_arrive(&sm.k_empty[s0]);   // this warp is done with K
      if (n_tiles == 1) {
        sm90::mbar_arrive(&sm.q_empty);     // and with Q
      }
    }
    softmax_tile<kBlockK, kF32>(sacc, n, t, m0, m1, l0, l1, alpha0, alpha1);
    pack_p<kBlockK>(sacc, p);
    for (int it = 1; it < n_tiles; ++it) {
      const int g = c + it;
      const int s = g % kStages;
      const int sp = (g - 1) % kStages;
      sm90::mbar_wait(&sm.k_full[s], (g / kStages) & 1);
      sm90::mbar_wait(&sm.v_full[sp], ((g - 1) / kStages) & 1);
      k_descs(sm.k[s]);
      v_descs(sm.v[sp]);
      sm90::fence_operands(sacc);
      sm90::fence_operands(o);
      fence_p<kBlockK>(p);
      sm90::wgmma_fence();
      qk<kBlockK>(sacc, dq, dk);
      sm90::wgmma_commit();
      pv<kBlockK>(o, p, dv);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();                // QK^T landed, PV in flight
      sm90::fence_operands(sacc);
      if (lane == 0) {
        sm90::mbar_arrive(&sm.k_empty[s]);
        if (it == n_tiles - 1) {
          sm90::mbar_arrive(&sm.q_empty);
        }
      }
      softmax_tile<kBlockK, kF32>(sacc, n - it * kBlockK, t, m0, m1, l0, l1,
                                  alpha0, alpha1);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      fence_p<kBlockK>(p);
      if (lane == 0) {
        sm90::mbar_arrive(&sm.v_empty[sp]);
      }
      rescale(o, alpha0, alpha1);
      pack_p<kBlockK>(sacc, p);
    }
    const int gl = c + n_tiles - 1;
    const int sl = gl % kStages;
    sm90::mbar_wait(&sm.v_full[sl], (gl / kStages) & 1);
    v_descs(sm.v[sl]);
    sm90::fence_operands(o);
    fence_p<kBlockK>(p);
    sm90::wgmma_fence();
    pv<kBlockK>(o, p, dv);
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
    const float den0 = fmaxf(l0, 1e-30f);
    const float den1 = fmaxf(l1, 1e-30f);

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
            pack_bf16(o[4 * j] / den0, o[4 * j + 1] / den0);
      }
      if (r1 < n) {
        *reinterpret_cast<uint32_t*>(ob + r1 * row_elems + col) =
            pack_bf16(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
      }
    }
  }
}

// A persistent grid: block b takes the work units b, b + gridDim.x, ...
// (unit = q tile + q_tiles * (head + heads * batch)).
template <int kBlockK, int kConsumers, bool kF32>
__global__ void __launch_bounds__(Cfg<kBlockK, kConsumers>::kThreads,
                                  Cfg<kBlockK, kConsumers>::kBlocksPerSm)
    sweep_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const MapDims dq, const MapDims dk,
                          const MapDims dv, __nv_bfloat16* __restrict__ out,
                          int batch, int n, int heads, float scale) {
  using C = Cfg<kBlockK, kConsumers>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<typename C::Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int q_tiles = (n + C::kBlockQ - 1) / C::kBlockQ;
  const int units = q_tiles * heads * batch;
  const int n_tiles = (n + kBlockK - 1) / kBlockK;

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
        const int q0 = (u % q_tiles) * C::kBlockQ;
        const int head = (u / q_tiles) % heads;
        const int b = u / (q_tiles * heads);
        // A fresh barrier passes a wait at parity 1: the first unit's Q
        // and the first round of stages go in at once.
        sm90::mbar_wait(&sm.q_empty, (i & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.q_full, C::kBlockQ * kD * 2);
        load_box(sm.q, &tm_q, dq, &sm.q_full, head, q0, b);
        for (int it = 0; it < n_tiles; ++it, ++c) {
          const int s = c % kStages;
          const uint32_t parity = ((c / kStages) & 1) ^ 1;
          sm90::mbar_wait(&sm.k_empty[s], parity);
          sm90::mbar_expect_tx(&sm.k_full[s], C::kTileBytes);
          load_box(sm.k[s], &tm_k, dk, &sm.k_full[s], head, it * kBlockK, b);
          sm90::mbar_wait(&sm.v_empty[s], parity);
          sm90::mbar_expect_tx(&sm.v_full[s], C::kTileBytes);
          load_box(sm.v[s], &tm_v, dv, &sm.v_full[s], head, it * kBlockK, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<C::kConsumerRegs>();
    consume<kBlockK, kConsumers, kF32>(sm, out, n, heads, q_tiles, units,
                                       scale);
  }
}

template <int kBlockK, int kConsumers, bool kF32>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n, int heads, const Strides& qs, const Strides& ks,
           const Strides& vs, float scale, cudaStream_t st) {
  using C = Cfg<kBlockK, kConsumers>;
  CUtensorMap tq, tk, tv;
  MapDims mq, mk, mv;
  int rc = sm90::encode_view_d64(&tq, &mq, q, batch, n, heads, qs.b, qs.n,
                                 qs.h, C::kBlockQ);
  if (rc == 0) {
    rc = sm90::encode_view_d64(&tk, &mk, k, batch, n, heads, ks.b, ks.n,
                               ks.h, kBlockK);
  }
  if (rc == 0) {
    rc = sm90::encode_view_d64(&tv, &mv, v, batch, n, heads, vs.b, vs.n,
                               vs.h, kBlockK);
  }
  if (rc != 0) {
    return rc;
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  auto* kernel = sweep_fwd_sm90_kernel<kBlockK, kConsumers, kF32>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long units =
      static_cast<long long>((n + C::kBlockQ - 1) / C::kBlockQ) * heads *
      batch;
  if (units > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(
      std::min<long long>(units, static_cast<long long>(sms) *
                                     C::kBlocksPerSm));
  kernel<<<grid, C::kThreads, C::kSmemBytes, st>>>(
      tq, tk, tv, mq, mk, mv, static_cast<__nv_bfloat16*>(out), batch, n,
      heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kBlockK, int kConsumers>
int launch_sm(bool softmax_f32, const void* q, const void* k, const void* v,
              void* out, int batch, int n, int heads, const Strides& qs,
              const Strides& ks, const Strides& vs, float scale,
              cudaStream_t st) {
  return softmax_f32
             ? launch<kBlockK, kConsumers, true>(q, k, v, out, batch, n, heads,
                                                 qs, ks, vs, scale, st)
             : launch<kBlockK, kConsumers, false>(q, k, v, out, batch, n,
                                                  heads, qs, ks, vs, scale,
                                                  st);
}

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with the given batch/token/head strides (in
// elements, last stride 1, 16-byte aligned pointer and strides). out:
// contiguous [B, N, H, 64] bf16. block_q and block_k in {64, 128};
// softmax_f32 0 or 1; scale = 1 / sqrt(D). Launches on `stream`; returns
// cudaGetLastError(), the driver's code if a tensor map cannot be encoded,
// or cudaErrorInvalidValue for a shape or instance it does not take.
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
    return launch_sm<64, 1>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                            scale, st);
  }
  if (block_q == 64 && block_k == 128) {
    return launch_sm<128, 1>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                             scale, st);
  }
  if (block_q == 128 && block_k == 64) {
    return launch_sm<64, 2>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                            scale, st);
  }
  if (block_q == 128 && block_k == 128) {
    return launch_sm<128, 2>(f32, q, k, v, out, batch, n, heads, qs, ks, vs,
                             scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
