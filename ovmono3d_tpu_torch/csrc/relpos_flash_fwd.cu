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
// template instance each.
//
// What bounds it on this card: at the SAM ViT-H global blocks (N = 4096,
// H = 16, D = 80) the QK^T and PV tensor-core work, 4*N^2*D flops per
// (batch, head); at the 14x14 windowed blocks (N = 196) the bytes of q, k, v,
// out and the bias factors. The N x N logits and their bias never leave the
// SM.
//
// What the design does about it: kernel 1's structure (csrc/
// flash_attn_fwd.cu) and its tile helpers (csrc/flash_common.cuh) at head
// dim D. One block of 4 warps per (64-row q tile, head, batch); each warp
// keeps its 16 x 64 logit tile in registers, adds the bias, turns it into
// bf16 probabilities in place and feeds them to the PV product. K and V
// stream through shared memory in 64-key tiles, double-buffered with
// cp.async. Both products are mma.sync m16n8k16 (bf16 in, f32 accumulate).
// The block's 64 rows of qrh and qrw (gh + gw floats a row) sit in shared
// memory, transposed and pre-multiplied by log2(e); a key's bias is two
// indexed reads, free of bank conflicts (kBiasStride). The TPU kernel's one-hot E_r / E_c matmuls, which kept the bias
// expansion on its matrix unit, its clamped single pass, its 128-lane KV
// padding and its head groups are not carried over.
//
// Softmax: online, with a running row max, in base 2: log2(e) is folded into
// the q.k scale and into the bias, so every exponential is exp2f. Exact for
// any logit range.
//
// Edges: keys past N (N = 196 is not a multiple of 64) are set to -inf;
// q rows past N load as zeros and are not stored. Zero-padded tokens of the
// window partition are real tokens inside N and are not masked.
//
// Shared memory: 5 bf16 tiles of 64 x (D + 8) plus (gh + gw) x 68 floats,
// 91,136 B at ViT-H's global blocks, so it is dynamic shared memory.
//
// Not yet: wgmma, TMA and warp specialisation (later work).

#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

// The block's bias table, transposed: entry a (a < gh the row terms, then
// the gw column terms) of local q row r at sb[a * kBiasStride + r]. The 4
// floats of padding put the 32 column-term reads of one warp (8 rows g by 4
// key pairs t, keys 2t apart) in 32 different banks; the row-term reads are
// 8 addresses, one per row, each broadcast to the row's 4 lanes.
constexpr int kBiasStride = kBlock + 4;

template <int D>
__global__ void __launch_bounds__(kThreads)
    relpos_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ qrh,
                      const float* __restrict__ qrw,
                      __nv_bfloat16* __restrict__ out, int n, int heads,
                      int gh, int gw, Strides qs, Strides ks, Strides vs,
                      float scale_log2, float inv_gw) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = Tile<D>::kElems;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kTile;           // two buffers
  __nv_bfloat16* sv = sk + 2 * kTile;       // two buffers
  float* sb = reinterpret_cast<float*>(sv + 2 * kTile);  // [gh + gw][stride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int nb = gh + gw;

  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  const int n_tiles = (n + kBlock - 1) / kBlock;

  load_tile<D>(sq, qb, qs.n, q0, n, tid);
  load_tile<D>(sk, kb, ks.n, 0, n, tid);
  load_tile<D>(sv, vb, vs.n, 0, n, tid);
  cp_async_commit();

  // The block's bias rows, in base-2 units, transposed; rows past n are
  // zeros. Visible to every warp after the first __syncthreads of the loop.
  for (int idx = tid; idx < kBlock * nb; idx += kThreads) {
    const int r = idx / nb;
    const int a = idx - r * nb;
    const int row = q0 + r;
    float val = 0.f;
    if (row < n) {
      const long long base =
          (static_cast<long long>(batch) * n + row) * heads + head;
      val = a < gh ? qrh[base * gh + a] : qrw[base * gw + (a - gh)];
    }
    sb[a * kBiasStride + r] = val * kLog2e;
  }

  uint32_t qf[D / 16][4];
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float* bias0 = sb + warp * 16 + g;   // row g
  const float* bias1 = bias0 + 8;            // row g + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(sk + (cur ^ 1) * kTile, kb, ks.n, (it + 1) * kBlock, n,
                   tid);
      load_tile<D>(sv + (cur ^ 1) * kTile, vb, vs.n, (it + 1) * kBlock, n,
                   tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
      load_a_frags<D>(qf, sq, warp, g, t);
    }

    float s[kBlock / 8][4] = {};
    mma_a_rowsT<D>(s, qf, sk + cur * kTile, g, t);

    // Scale into base 2, add the bias, mask keys past n, take the row max.
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
        // kk / gw, exact for n < 2^21 (the launcher's limit).
        const int kr = static_cast<int>((kk + 0.5f) * inv_gw);
        const int row = kr * kBiasStride;
        const int col = (gh + kk - kr * gw) * kBiasStride;
        s[j][e] = ok ? fmaf(s[j][e], scale_log2, bias0[row] + bias0[col])
                     : -INFINITY;
        s[j][2 + e] =
            ok ? fmaf(s[j][2 + e], scale_log2, bias1[row] + bias1[col])
               : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile holds a key < n, so mx0/mx1 are finite here.
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
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }

    mma_p_rows<D>(o, pf, sv + cur * kTile, lane);
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 1);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 2);

  const long long row_elems = static_cast<long long>(heads) * D;
  store_rows<D>(out + static_cast<long long>(batch) * n * row_elems + head * D,
                row_elems, o, q0 + warp * 16, n, g, t, 1.f / l[0],
                1.f / l[1]);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* qrh,
           const void* qrw, void* out, int batch, int n, int heads, int gh,
           int gw, const Strides& qs, const Strides& ks, const Strides& vs,
           float scale, cudaStream_t stream) {
  const size_t smem = 5 * Tile<D>::kElems * sizeof(__nv_bfloat16) +
                      static_cast<size_t>(kBiasStride) * (gh + gw) *
                          sizeof(float);
  if (smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      relpos_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  relpos_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(qrh),
      static_cast<const float*>(qrw), static_cast<__nv_bfloat16*>(out), n,
      heads, gh, gw, qs, ks, vs, scale * kLog2e, 1.f / gw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: [B, N, H, D] bf16 with the given batch/token/head strides (in
// elements, last stride 1, 16-byte aligned rows), D in {64, 80}, N = gh * gw.
// qrh: contiguous [B, N, H, gh] f32; qrw: contiguous [B, N, H, gw] f32.
// out: contiguous [B, N, H * D] bf16. Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int relpos_flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* qrh,
    const void* qrw, void* out, int batch, int n, int heads, int head_dim,
    int gh, int gw, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, void* stream) {
  if (n <= 0 || n >= (1 << 21) || batch <= 0 || heads <= 0 || gh <= 0 ||
      gw <= 0 || gh * gw != n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return launch<64>(q, k, v, qrh, qrw, out, batch, n, heads, gh, gw, qs, ks,
                      vs, scale, st);
  }
  if (head_dim == 80) {
    return launch<80>(q, k, v, qrh, qrw, out, batch, n, heads, gh, gw, qs, ks,
                      vs, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
