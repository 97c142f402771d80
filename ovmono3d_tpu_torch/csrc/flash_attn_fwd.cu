// Flash-attention forward for Hopper (sm_90a): bf16 in and out, f32 softmax.
//
// Replaces: ovmono3d_tpu/ops/attention.py:_flash_kernel_packed, the TPU
// kernel behind flash_attention_packed. It computes
//     out = softmax(q k^T / sqrt(D)) v        for every (batch, head),
// reading q, k and v as strided views of the qkv projection's output
// [B, N, 3, H, D] (token stride 3*H*D) and writing a contiguous [B, N, H*D]
// that the output projection reads as it is. No transposes, pads or copies.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;                 // q rows per block
constexpr int kBlockK = 64;                 // keys per K/V tile
constexpr int kWarps = kBlockQ / 16;        // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kHeadDim + 8;       // padded smem row: 144 bytes
constexpr int kTileElems = kBlockK * kStride;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, n, h;                        // in elements
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a * b for one m16n8k16 tile: a is 16x16 (row), b is 16x8 (col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head (row stride `row_stride`) into a
// padded smem tile; rows at or past n arrive as zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int n, int tid) {
  constexpr int kChunksPerRow = kHeadDim / 8;   // 16-byte chunks
  constexpr int kIters = kBlockK * kChunksPerRow / kThreads;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunksPerRow;
    const int c = (idx % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool valid = row < n;
    const __nv_bfloat16* src =
        base + (valid ? static_cast<long long>(row) * row_stride + c : 0);
    cp_async_16(smem + r * kStride + c, src, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int n, int heads,
                     Strides qs, Strides ks, Strides vs, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sq[kBlockQ * kStride];
  __shared__ __align__(16) __nv_bfloat16 sk[2][kTileElems];
  __shared__ __align__(16) __nv_bfloat16 sv[2][kTileElems];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;          // fragment row group
  const int t = lane & 3;           // thread in group
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  const int n_tiles = (n + kBlockK - 1) / kBlockK;

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
      load_tile(sk[cur ^ 1], kb, ks.n, (it + 1) * kBlockK, n, tid);
      load_tile(sv[cur ^ 1], vb, vs.n, (it + 1) * kBlockK, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
      const __nv_bfloat16* qw = sq + warp * 16 * kStride;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const __nv_bfloat16* p = qw + kk * 16 + 2 * t;
        qf[kk][0] = ld_u32(p + g * kStride);
        qf[kk][1] = ld_u32(p + (g + 8) * kStride);
        qf[kk][2] = ld_u32(p + g * kStride + 8);
        qf[kk][3] = ld_u32(p + (g + 8) * kStride + 8);
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    const __nv_bfloat16* skc = sk[cur];
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const __nv_bfloat16* kr = skc + (j * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_bf16(s[j], qf[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // Scale into base 2, mask keys past n, take the new row max.
    const int key0 = it * kBlockK;
    float mx0 = m[0];
    float mx1 = m[1];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
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
    uint32_t pf[kBlockK / 16][4];
    float rs0 = 0.f;
    float rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - mx0);
      const float p1 = exp2f(s[j][1] - mx0);
      const float p2 = exp2f(s[j][2] - mx1);
      const float p3 = exp2f(s[j][3] - mx1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);   // row g
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);   // row g + 8
    }
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int dn = 0; dn < kHeadDim / 8; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }

    // O += P V. ldmatrix.x4.trans yields the B fragments of two 8-wide
    // column tiles of V for one 16-key step.
    const __nv_bfloat16* svc = sv[cur];
    const int mat = lane >> 3;
    const int mrow = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, svc + (kk * 16 + (mat & 1) * 8 + mrow) * kStride + dp * 16 +
                   (mat >> 1) * 8);
        mma_bf16(o[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();   // the next iteration's loads overwrite this buffer
  }

  // Row sums live split over the 4 threads of each row group.
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 1);
  l[1] += __shfl_xor_sync(0xffffffffu, l[1], 2);
  const float inv0 = 1.f / l[0];
  const float inv1 = 1.f / l[1];

  const long long row_elems = static_cast<long long>(heads) * kHeadDim;
  __nv_bfloat16* ob = out + static_cast<long long>(batch) * n * row_elems +
                      head * kHeadDim;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < kHeadDim / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(ob + r0 * row_elems + col) =
          pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(ob + r1 * row_elems + col) =
          pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
    }
  }
}

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with the given batch/token/head strides (in
// elements, last stride 1, 16-byte aligned rows). out: contiguous
// [B, N, H * 64] bf16. Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, int batch, int n,
    int heads, int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, void* stream) {
  if (head_dim != kHeadDim || n <= 0 || batch <= 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      n, heads, Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
      Strides{v_sb, v_sn, v_sh}, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
