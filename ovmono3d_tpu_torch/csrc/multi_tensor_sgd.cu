// Multi-tensor SGD update and gradient finiteness flag for Hopper (sm_90a):
// every trainable leaf of a model in one launch, where the eager update took
// ~12 launches a leaf.
//
// Replaces no TPU kernel. The JAX package's optimizer is one optax chain
// (ovmono3d_tpu/train/optim.py build_optimizer) that XLA fuses into a few
// loops over the whole parameter tree; the port's eager update
// (train/optim.py Optimizer._updates) runs the same arithmetic one small
// kernel at a time, ~12 launches a leaf (~2,750 for SAM ViT-B's 237 leaves),
// which leaves the card waiting for the host. This file does the work of
// `Optimizer.step` for kind "sgd" and of the train step's finiteness flag.
//
// sgd_kernel, for each element of each leaf (optax's sgd with a trace:
// momentum, no Nesterov), in f32 and in the eager path's order, each product
// and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc would otherwise
// contract them into an FMA and the result would no longer be the eager
// path's bit for bit):
//
//     u      = g + wd * p        (u = g in a group without weight decay)
//     trace' = u + momentum * trace
//     p'     = p + trace' * (-lr[group])
//
// finite_kernel writes 0 to a bool flag (which the wrapper set to 1) when any
// element of any gradient is an inf or a NaN.
//
// What bounds it on this card: bytes. 5 flops an element against 20 bytes
// (g, p and trace read, p and trace written). SAM ViT-B's 121.17 M trainable
// f32 parameters move 2.42 GB, 0.72 ms at 3.35 TB/s; the flag reads 0.48 GB,
// 0.145 ms.
//
// What the design does about it. The work list is a static table of chunks
// (leaf, start, length), CHUNK elements each except a leaf's last, and a
// table of leaves (p and trace pointers, the group, its weight decay), both
// on the device, built once when the optimizer is built: parameters and
// trace buffers do not move. Only the gradients change from step to step;
// their pointers travel by value in the kernel's parameters (a
// __grid_constant__ struct of at most kMaxLeaves pointers, within the 4 KB
// of kernel parameters that CUDA before 12.1 allows), so a step copies
// nothing from the host.
// A null pointer is an unused leaf, read as zeros. One block takes one chunk
// at a time (grid-stride over the table, the grid as large as the table up
// to kMaxGrid, so the hardware balances the blocks), each thread keeping
// kUnroll 16-byte loads of each array in flight. p and trace are allocations
// of their own and 16-byte aligned; a gradient may be a view at any offset
// (the data-parallel step's flat all_reduce buffer), and is then read with
// 4-byte loads beside the 16-byte ones of p and trace. The skip flag and the
// learning rates are read from device memory, so the host never waits: on a
// skipped step every block returns before it writes, and parameters and
// trace keep their bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 480;     // gradient pointers a launch carries
constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // 16-byte loads in flight a thread, per array
constexpr int kMaxGrid = 1 << 20;

// One work item: elements [start, start + len) of leaf `leaf`.
struct Chunk {
  long long start;
  int leaf;
  int len;
};

struct Leaf {
  float* p;
  float* t;
  int group;     // index into the learning rates
  float wd;
  int decay;     // 1: u = g + wd * p; 0: u = g
  int pad;
};

static_assert(sizeof(Chunk) == 16, "chunk table layout (ops/optim_kernels.py)");
static_assert(sizeof(Leaf) == 32, "leaf table layout (ops/optim_kernels.py)");

struct SgdArgs {
  const float* g[kMaxLeaves];   // leaves [leaf0, leaf0 + kMaxLeaves)
  const Chunk* chunks;
  const Leaf* leaves;
  const float* lr;
  const unsigned char* skip;
  float momentum;
  int c0, c1, leaf0;
};

struct FiniteArgs {
  const float* g[kMaxLeaves];
  const Chunk* chunks;
  unsigned char* finite;
  int c0, c1, leaf0;
};

static_assert(sizeof(SgdArgs) <= 4096, "kernel parameters within 4 KB");
static_assert(sizeof(FiniteArgs) <= 4096, "kernel parameters within 4 KB");

__device__ __forceinline__ void sgd1(float g, float& p, float& t, float wd,
                                     bool decay, float mu, float neg_lr) {
  const float u = decay ? __fadd_rn(g, __fmul_rn(wd, p)) : g;
  t = __fadd_rn(u, __fmul_rn(mu, t));
  p = __fadd_rn(p, __fmul_rn(t, neg_lr));
}

__device__ __forceinline__ float4 load_g4(const float* g, int i, bool vec_g) {
  if (g == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec_g) return __ldcs(reinterpret_cast<const float4*>(g) + i);
  const float* q = g + 4 * i;
  return make_float4(__ldcs(q), __ldcs(q + 1), __ldcs(q + 2), __ldcs(q + 3));
}

// p and t 16-byte aligned; g aligned when vec_g, or null.
__device__ void sgd_chunk_vec(const float* __restrict__ g,
                              float* __restrict__ p, float* __restrict__ t,
                              int n, bool vec_g, float wd, bool decay,
                              float mu, float neg_lr) {
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* t4 = reinterpret_cast<float4*>(t);
  const int n4 = n >> 2;
  for (int base = threadIdx.x; base < n4; base += kThreads * kUnroll) {
    float4 gv[kUnroll], pv[kUnroll], tv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < n4) {
        gv[u] = load_g4(g, i, vec_g);
        pv[u] = p4[i];
        tv[u] = t4[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < n4) {
        sgd1(gv[u].x, pv[u].x, tv[u].x, wd, decay, mu, neg_lr);
        sgd1(gv[u].y, pv[u].y, tv[u].y, wd, decay, mu, neg_lr);
        sgd1(gv[u].z, pv[u].z, tv[u].z, wd, decay, mu, neg_lr);
        sgd1(gv[u].w, pv[u].w, tv[u].w, wd, decay, mu, neg_lr);
        p4[i] = pv[u];
        t4[i] = tv[u];
      }
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) {
    float pi = p[i], ti = t[i];
    sgd1(g == nullptr ? 0.f : g[i], pi, ti, wd, decay, mu, neg_lr);
    p[i] = pi;
    t[i] = ti;
  }
}

__device__ void sgd_chunk_scalar(const float* __restrict__ g,
                                 float* __restrict__ p, float* __restrict__ t,
                                 int n, float wd, bool decay, float mu,
                                 float neg_lr) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float pi = p[i], ti = t[i];
    sgd1(g == nullptr ? 0.f : g[i], pi, ti, wd, decay, mu, neg_lr);
    p[i] = pi;
    t[i] = ti;
  }
}

__device__ __forceinline__ bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
sgd_kernel(const __grid_constant__ SgdArgs a) {
  if (*a.skip) return;
  for (int c = a.c0 + blockIdx.x; c < a.c1; c += gridDim.x) {
    const Chunk ch = a.chunks[c];
    const Leaf lf = a.leaves[ch.leaf];
    const float* g = a.g[ch.leaf - a.leaf0];
    if (g != nullptr) g += ch.start;
    float* p = lf.p + ch.start;
    float* t = lf.t + ch.start;
    const float neg_lr = -a.lr[lf.group];
    if (aligned16(p) && aligned16(t)) {
      sgd_chunk_vec(g, p, t, ch.len, g == nullptr || aligned16(g), lf.wd,
                    lf.decay != 0, a.momentum, neg_lr);
    } else {
      sgd_chunk_scalar(g, p, t, ch.len, lf.wd, lf.decay != 0, a.momentum,
                       neg_lr);
    }
  }
}

__device__ __forceinline__ bool nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

__global__ void __launch_bounds__(kThreads)
finite_kernel(const __grid_constant__ FiniteArgs a) {
  bool bad = false;
  for (int c = a.c0 + blockIdx.x; c < a.c1; c += gridDim.x) {
    const Chunk ch = a.chunks[c];
    const float* g = a.g[ch.leaf - a.leaf0];
    if (g == nullptr) continue;
    g += ch.start;
    int done = 0;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int n4 = ch.len >> 2;
      for (int base = threadIdx.x; base < n4; base += kThreads * kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * kThreads;
          v[u] = i < n4 ? __ldcs(g4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          bad |= nonfinite(v[u].x) | nonfinite(v[u].y) | nonfinite(v[u].z) |
                 nonfinite(v[u].w);
        }
      }
      done = 4 * n4;
    }
    for (int i = done + threadIdx.x; i < ch.len; i += kThreads) {
      bad |= nonfinite(__ldcs(g + i));
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *a.finite = 0;
}

int grid_for(int c0, int c1) {
  const int n = c1 - c0;
  return n < kMaxGrid ? n : kMaxGrid;
}

}  // namespace

extern "C" int multi_tensor_max_leaves() { return kMaxLeaves; }

// One launch over chunks [c0, c1), whose leaves lie in [leaf0, leaf0 + n);
// grads: n device pointers (0 for an unused leaf), in a host array.
extern "C" int multi_tensor_sgd(const void* chunks, const void* leaves,
                                int c0, int c1, int leaf0, int n,
                                const void* const* grads, const void* lr,
                                const void* skip, float momentum,
                                void* stream) {
  if (c0 < 0 || c1 <= c0 || leaf0 < 0 || n <= 0 || n > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SgdArgs a = {};
  for (int i = 0; i < n; ++i) a.g[i] = static_cast<const float*>(grads[i]);
  a.chunks = static_cast<const Chunk*>(chunks);
  a.leaves = static_cast<const Leaf*>(leaves);
  a.lr = static_cast<const float*>(lr);
  a.skip = static_cast<const unsigned char*>(skip);
  a.momentum = momentum;
  a.c0 = c0;
  a.c1 = c1;
  a.leaf0 = leaf0;
  sgd_kernel<<<grid_for(c0, c1), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int multi_tensor_all_finite(const void* chunks, int c0, int c1,
                                       int leaf0, int n,
                                       const void* const* grads,
                                       void* finite, void* stream) {
  if (c0 < 0 || c1 <= c0 || leaf0 < 0 || n <= 0 || n > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FiniteArgs a = {};
  for (int i = 0; i < n; ++i) a.g[i] = static_cast<const float*>(grads[i]);
  a.chunks = static_cast<const Chunk*>(chunks);
  a.finite = static_cast<unsigned char*>(finite);
  a.c0 = c0;
  a.c1 = c1;
  a.leaf0 = leaf0;
  finite_kernel<<<grid_for(c0, c1), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
