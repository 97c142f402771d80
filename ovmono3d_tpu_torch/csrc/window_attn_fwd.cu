// Swin window attention, forward, for Hopper (sm_90a): bf16 q/k/v/out, an
// f32 relative-position bias, per-token region ids for the shifted-window
// mask, f32 online softmax.
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
// Swin-B's last stage) is read by every window and stays in L2.
//
// What the design does about it: kernel 7's structure (csrc/
// relpos_flash_fwd.cu) and the tile helpers of csrc/flash_common.cuh at
// D = 32. One block of 4 warps per (64-row q tile, head, window): 3 x 4 x 361
// blocks at stage 0. Each warp keeps its 16 x 64 logit tile in registers,
// adds the bias rows it reads from global memory (through L2) and the mask
// from the window's ids in shared memory, turns the tile into bf16
// probabilities in place and feeds them to the PV product. K and V stream
// through shared memory in 64-key tiles, double-buffered with cp.async (a
// window is 3 tiles). Both products are mma.sync m16n8k16, bf16 in, f32
// accumulate. The TPU kernel's group of G windows with all heads in one
// program is not carried over.
//
// Softmax: online, with a running row max, in base 2 (log2(e) folded into
// the scale, the bias and the mask), so every exponential is exp2f; exact for
// any logit range. The mask is the reference's additive -1e9, not -inf: a row
// whose first key tile is all masked then has a finite running max, and the
// row's own key, which is never masked, later takes the max and scales what
// the masked keys added to zero.
//
// Edges: keys past N are -inf; q rows past N load as zeros, read the bias row
// N - 1 and are not stored. N is any length from 1 to 1024 (kMaxTokens: the
// ids take 4 N bytes of shared memory beside the 25.6 KB of tiles); Swin
// gives 144, or w^2 < 144 for a feature map smaller than the window.
//
// Not yet: wgmma, TMA, several heads or windows a block (later work).

#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

constexpr int kD = 32;
constexpr int kMaxTokens = 1024;
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

}  // namespace

// q, k, v: [BW, N, H, 32] bf16 with the given window/token/head strides (in
// elements, last stride 1, 16-byte aligned rows), 1 <= N <= 1024.
// bias: contiguous [H, N, N] f32. ids: contiguous [nw, N] int32 with BW a
// multiple of nw, or null for no mask. out: contiguous [BW, N, H * 32] bf16.
// Launches on `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape it does not take).
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
  const Strides qs{q_sb, q_sn, q_sh};
  const Strides ks{k_sb, k_sn, k_sh};
  const Strides vs{v_sb, v_sn, v_sh};
  // 5 tiles of 64 x 40 bf16 (25,600 B) and the ids: under the 48 KB a block
  // gets without opting in.
  const size_t smem = 5 * Tile<kD>::kElems * sizeof(__nv_bfloat16) +
                      (ids != nullptr ? n * sizeof(int) : 0);
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  const auto st = static_cast<cudaStream_t>(stream);
  window_fwd_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(ids), static_cast<__nv_bfloat16*>(out), n, heads,
      ids != nullptr ? nw : 1, qs, ks, vs, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
