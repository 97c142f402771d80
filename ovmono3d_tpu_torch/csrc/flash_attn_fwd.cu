// Flash-attention forward for Hopper (sm_90a): bf16 in and out, f32 softmax,
// with an optional row log-sum-exp output for the backward.
//
// Replaces two TPU kernels of ovmono3d_tpu/ops/attention.py:
// - _flash_kernel_packed, behind flash_attention_packed (inference): the
//   launch without an lse pointer;
// - _flash_kernel_packed_lse, behind flash_attention_packed_lse (training):
//   the same launch with an lse pointer, compiled as a second instance of the
//   kernel template, so the inference instance carries no lse code at all.
//
// It computes
//     out = softmax(q k^T / sqrt(D)) v        for every (batch, head),
//     lse = log(sum_j exp(q k_j / sqrt(D)))   (natural log, [B, H, N] f32)
// reading q, k and v as strided views of the qkv projection's output
// [B, N, 3, H, D] (token stride 3*H*D) and writing a contiguous [B, N, H*D]
// that the output projection reads as it is. No transposes, pads or copies.
// lse is stored in NATURAL-log units (the TPU kernel's is base 2 and shifted
// by its clamp; its [b, h/g, g, n] layout is a TPU tiling constraint and is
// not carried over).
//
// What bounds it on this card: the QK^T and PV tensor-core work,
// 4*N^2*D flops per (batch, head) -- 51.6 GFLOP per ViT-B/14 trunk layer at
// N = 4097, H = 12 -- against O(N*D) bytes of q/k/v/out traffic. The N x N
// logits never leave the SM.
//
// What the design does about it: one block of 4 warps per (64-row q tile,
// head, batch); each warp owns 16 q rows and keeps its 16 x 64 logit tile in
// registers, turns it into bf16 probabilities in place and feeds them back
// into the PV product without a trip through shared memory. K and V stream
// through shared memory in 64-key tiles, double-buffered with cp.async so the
// next tile's loads overlap this tile's math. Both products are mma.sync
// m16n8k16 (bf16 inputs, f32 accumulators); V's fragments come from
// ldmatrix.trans. Shared-memory rows are padded by 16 bytes so the fragment
// loads are free of bank conflicts.
//
// Softmax: the standard online softmax with a running row max, in base 2
// (log2(e) folded into the scale, exp2f). It is exact for any logit range;
// the TPU kernel's clamped single pass is exact only inside its window.
//
// Ragged edges (N = 4097 = 64*64 + 1): rows past N load as zeros (cp.async
// zero-fill), keys past N are set to -inf before the row max, and q rows past
// N are not written.
//
// Not yet: wgmma, TMA and warp specialisation (later work).

#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

template <bool kWriteLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int n, int heads,
                     Strides qs, Strides ks, Strides vs, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sq[kTileElems];
  __shared__ __align__(16) __nv_bfloat16 sk[2][kTileElems];
  __shared__ __align__(16) __nv_bfloat16 sv[2][kTileElems];

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

  load_tile(sq, qb, qs.n, q0, n, tid);
  load_tile(sk[0], kb, ks.n, 0, n, tid);
  load_tile(sv[0], vb, vs.n, 0, n, tid);
  cp_async_commit();

  uint32_t qf[kHeadDim / 16][4];            // this warp's Q as A fragments
  float o[kHeadDim / 8][4] = {};            // O accumulators, 16 x 64
  float m[2] = {-INFINITY, -INFINITY};      // running row max (rows g, g+8)
  float l[2] = {0.f, 0.f};                  // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(sk[cur ^ 1], kb, ks.n, (it + 1) * kBlock, n, tid);
      load_tile(sv[cur ^ 1], vb, vs.n, (it + 1) * kBlock, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
      load_a_frags(qf, sq, warp, g, t);
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlock / 8][4] = {};
    mma_a_rowsT(s, qf, sk[cur], g, t);

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
    for (int dn = 0; dn < kHeadDim / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }

    // O += P V.
    mma_p_rows(o, pf, sv[cur], lane);
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  // Row sums live split over the 4 threads of each row group.
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 1);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 2);

  const long long row_elems = static_cast<long long>(heads) * kHeadDim;
  __nv_bfloat16* ob = out + static_cast<long long>(batch) * n * row_elems +
                      head * kHeadDim;
  const int row0 = q0 + warp * 16;
  store_rows(ob, row_elems, o, row0, n, g, t, 1.f / l[0], 1.f / l[1]);

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

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with the given batch/token/head strides (in
// elements, last stride 1, 16-byte aligned rows). out: contiguous
// [B, N, H * 64] bf16. lse: contiguous [B, H, N] f32 (natural log), or null
// for the inference launch. Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int n, int heads, int head_dim, long long q_sb, long long q_sn,
    long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale,
    void* stream) {
  if (head_dim != kHeadDim || n <= 0 || batch <= 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  if (lse == nullptr) {
    flash_fwd_kernel<false><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, nullptr, n, heads, qs, ks, vs, scale * kLog2e);
  } else {
    flash_fwd_kernel<true><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, static_cast<float*>(lse), n, heads, qs, ks, vs,
        scale * kLog2e);
  }
  return static_cast<int>(cudaGetLastError());
}
