// Flash-attention forward for Hopper (sm_90a): a bf16 instance (bf16 in and
// out, f32 softmax, an optional row log-sum-exp output for the backward) and
// an f32 instance (f32 in and out, f32 products), each at head dims 32 and 64.
//
// Replaces five TPU kernels of ovmono3d_tpu/ops/attention.py. The TPU needs a
// packed and a head-major variant of each because its (8, 128) tiling fixes
// the layout a kernel can read; these kernels take any batch/token/head
// strides, so one kernel serves both layouts:
// - _flash_kernel_packed, behind flash_attention_packed (inference, packed
//   [B, N, H*D]): the bf16 launch without an lse pointer, or the f32 launch;
// - _flash_kernel_single / _flash_kernel, behind flash_attention (inference,
//   head-major [B*H, N, D]): the same launches on the caller's [B, N, H, D]
//   views, with no transposed copy;
// - _flash_kernel_packed_lse and _flash_kernel_single_lse, behind
//   flash_attention_packed_lse and flash_attention_fwd_lse (training): the
//   bf16 launch with an lse pointer, a second instance of the kernel
//   template, so the inference instance carries no lse code at all.
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
// (batch, head) -- 51.6 GFLOP per ViT-B/14 trunk layer at N = 4097, H = 12 --
// against O(N*D) bytes of q/k/v/out traffic. The N x N logits never leave
// the SM. bf16 runs on the tensor cores (989 TFLOP/s); f32 on the FP32 pipes
// (67 TFLOP/s), since single-pass TF32 products would keep 10 mantissa bits.
//
// bf16 design: one block of 4 warps per (64-row q tile, head, batch); each
// warp owns 16 q rows and keeps its 16 x 64 logit tile in registers, turns
// it into bf16 probabilities in place and feeds them back into the PV
// product without a trip through shared memory. K and V stream through
// shared memory in 64-key tiles, double-buffered with cp.async so the next
// tile's loads overlap this tile's math. Both products are mma.sync
// m16n8k16 (bf16 inputs, f32 accumulators); V's fragments come from
// ldmatrix.trans. Shared-memory rows are padded by 16 bytes so the fragment
// loads are free of bank conflicts.
//
// f32 design (flash_fwd_f32_kernel): FFMA, exact f32 products as the JAX
// kernel's f32 dots are. One block of 16 x 16 threads per (64-row q tile,
// head, batch); thread (ty, tx) owns q rows 4ty..4ty+3 and, in each 64-key
// tile, keys tx + 16j (j < 4), so the 16 threads of a row are one half-warp
// and the row max and sum reduce with 4 shuffles. Q, K and V tiles and the
// f32 probabilities P sit in shared memory with rows padded to D + 4 and
// 68 floats, which keeps the float4 loads conflict-free; P stays f32 for PV,
// as the JAX kernel casts p to the input dtype. One K/V buffer (cp.async,
// 16 bytes = 4 floats a copy): ~70 KB of dynamic shared memory at D = 64,
// three blocks an SM. Speed is later work.
//
// Softmax: the standard online softmax with a running row max, in base 2
// (log2(e) folded into the scale, exp2f). It is exact for any logit range;
// the TPU kernels' clamped single pass is exact only inside its window.
//
// Ragged edges (N = 4097 = 64*64 + 1): rows past N load as zeros (cp.async
// zero-fill), keys past N are set to -inf before the row max, and q rows past
// N are not written.
//
// Not yet: wgmma, TMA and warp specialisation; an f32 backward (later work).

#include "flash_common.cuh"

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

constexpr int kF32Threads = 256;            // 16 x 16
constexpr int kPStride = kBlock + 4;        // P rows, in floats

template <int D>
struct F32Tile {
  static constexpr int kStride = D + 4;     // floats; 16-byte rows
  static constexpr int kElems = kBlock * kStride;
  static constexpr int kSmemBytes =
      (3 * kElems + kBlock * kPStride) * static_cast<int>(sizeof(float));
};

// Copy rows [row0, row0 + 64) of one head (row stride `row_stride` floats)
// into a padded smem tile, 4 floats a cp.async; rows at or past n arrive as
// zeros.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* smem, const float* base,
                                              long long row_stride, int row0,
                                              int n, int tid) {
  constexpr int kChunks = D / 4;
  constexpr int kIters = kBlock * kChunks / kF32Threads;
  static_assert(kBlock * kChunks % kF32Threads == 0, "tile loads must divide");
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = tid + i * kF32Threads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int row = row0 + r;
    const bool valid = row < n;
    const float* src =
        base + (valid ? static_cast<long long>(row) * row_stride + c : 0);
    cp_async_16(smem + r * F32Tile<D>::kStride + c, src, valid);
  }
}

__device__ __forceinline__ float dot4(float acc, const float4& a,
                                      const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int n, int heads, Strides qs, Strides ks, Strides vs,
                         float scale_log2) {
  constexpr int kS = F32Tile<D>::kStride;
  constexpr int kCols = D / 16;             // O columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + F32Tile<D>::kElems;
  float* sv = sk + F32Tile<D>::kElems;
  float* sp = sv + F32Tile<D>::kElems;

  const int tid = threadIdx.x;
  const int tx = tid % 16;                  // key / column lane of a row
  const int ty = tid / 16;                  // row group: rows 4ty..4ty+3
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  const float* qb = q + batch * qs.b + head * qs.h;
  const float* kb = k + batch * ks.b + head * ks.h;
  const float* vb = v + batch * vs.b + head * vs.h;
  const int n_tiles = (n + kBlock - 1) / kBlock;

  load_tile_f32<D>(sq, qb, qs.n, q0, n, tid);

  float o[4][kCols] = {};
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l[4] = {0.f, 0.f, 0.f, 0.f};        // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int key0 = it * kBlock;
    __syncthreads();   // the previous tile's PV is done with sk, sv and sp
    load_tile_f32<D>(sk, kb, ks.n, key0, n, tid);
    load_tile_f32<D>(sv, vb, vs.n, key0, n, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T: rows 4ty + i, keys tx + 16j.
    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
      float4 kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sq + (4 * ty + i) * kS + d);
        kv[i] = *reinterpret_cast<const float4*>(sk + (tx + 16 * i) * kS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(s[i][j], qv[i], kv[j]);
        }
      }
    }

    // Scale into base 2, mask keys past n, online softmax; P into smem.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = key0 + tx + 16 * j < n ? s[i][j] * scale_log2 : -INFINITY;
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
        sp[(4 * ty + i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        o[i][c] *= alpha;
      }
    }
    __syncthreads();

    // O += P V: rows 4ty + i, columns tx + 16c.
#pragma unroll 2
    for (int key = 0; key < kBlock; key += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(sp + (4 * ty + i) * kPStride +
                                                 key);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float* vc = sv + key * kS + tx + 16 * c;
        const float v0 = vc[0];
        const float v1 = vc[kS];
        const float v2 = vc[2 * kS];
        const float v3 = vc[3 * kS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][c] = fmaf(pv[i].x, v0, o[i][c]);
          o[i][c] = fmaf(pv[i].y, v1, o[i][c]);
          o[i][c] = fmaf(pv[i].z, v2, o[i][c]);
          o[i][c] = fmaf(pv[i].w, v3, o[i][c]);
        }
      }
    }
  }

  const long long row_elems = static_cast<long long>(heads) * D;
  float* ob = out + static_cast<long long>(batch) * n * row_elems + head * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      li += __shfl_xor_sync(0xffffffffu, li, off);
    }
    const int row = q0 + 4 * ty + i;
    if (row < n) {
      const float inv = 1.f / li;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        ob[row * row_elems + tx + 16 * c] = o[i][c] * inv;
      }
    }
  }
}

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
  constexpr int kSmem = F32Tile<D>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid((n + kBlock - 1) / kBlock, heads, batch);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, heads, qs, ks,
      vs, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: [B, N, H, D] bf16, D in {32, 64}, with the given batch/token/head
// strides (in elements, last stride 1, 16-byte aligned rows). out:
// contiguous [B, N, H * D] bf16. lse: contiguous [B, H, N] f32 (natural
// log), or null for the inference launch. Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
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
    return launch_bf16<64>(q, k, v, out, lse, batch, n, heads, qs, ks, vs,
                           scale, st);
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
