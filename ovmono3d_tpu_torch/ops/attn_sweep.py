"""The attention forward of the block-size sweep (kernel 11): the plain
PyTorch version and the Hopper kernel.

Counterpart of the TPU kernel `make_kernel(sm_f32)` of
tools/profile_attn_sweep.py, reached there only through its `flash`: kernel
2's online forward with padded keys masked by an additive -1e30 and a switch
that keeps the softmax in f32 or in the input dtype (bf16). Its rounding
points differ from kernel 1's, and they depend on the key block (p is
rounded to bf16 against the running max), so the plain version runs the
same recurrence over the same blocks:

- `attn_sweep_ref(q, k, v, block_k, softmax_f32)`: q' = bf16(f32(q) *
  scale); per key block s = q' k^T in f32 (rounded to bf16 for a bf16
  softmax), plus the mask; m = max(m_prev, rowmax(s)) in f32 from -1e30;
  p = exp(s - m) (bf16: bf16(exp(bf16(s - bf16(m))))); l and acc rescaled
  by exp(m_prev - m), l += sum(p) in f32, acc += bf16(p) v in f32; out =
  bf16(acc / max(l, 1e-30)).
- `attn_sweep(q, k, v, block_q, block_k, softmax_f32)`: the kernel
  (`csrc/attn_sweep_fwd.cu`, wgmma + TMA with a producer warpgroup) for
  CUDA tensors, one of `INSTANCES`; the plain version for CPU tensors.
  bf16 [B, N, H, 64] strided views in, a contiguous [B, N, H, 64] out.
  Forward only. Counts each launch in
  `attn_sweep.launches[(block_q, block_k, softmax_f32)]`. block_q only
  tiles the rows: two instances that differ in it give bit-identical
  outputs. The kernel's exp is ex2.approx(x log2 e), within a few parts in
  a million of the plain version's `torch.exp` of the same argument.

The TPU variants hold the whole key set in VMEM (block_k 4352-4608); the
card's shared memory holds 64- and 128-key stages, so the instances sweep
block_q and block_k over {64, 128} in both softmax modes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

KERNEL_SOURCES = ["attn_sweep_fwd.cu"]
INSTANCES = tuple((bq, bk, f32) for f32 in (True, False)
                  for bq in (64, 128) for bk in (64, 128))
HEAD_DIM = 64
NEG_INF = -1e30


def attn_sweep_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   block_k: int, softmax_f32: bool) -> torch.Tensor:
    """The swept kernel's recurrence over key blocks of `block_k`, rounded
    where it rounds. q/k/v [B, N, H, D] -> [B, N, H, D] in q's dtype."""
    b, n, h, d = q.shape
    in_dtype = q.dtype
    sdt = torch.float32 if softmax_f32 else in_dtype
    scale = 1.0 / math.sqrt(d)
    qh = (q.float() * scale).to(in_dtype).permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    acc = torch.zeros(b, h, n, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, n, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, h, n, 1, dtype=torch.float32, device=q.device)
    # Keys past N (the TPU wrapper's zero padding plus the -1e30 mask) move
    # neither a row's max (each block holds a real key) nor its sums (their
    # p is exactly 0), so each block stops at N.
    for start in range(0, n, block_k):
        stop = min(start + block_k, n)
        s = (qh @ kh[:, :, start:stop].transpose(-1, -2)).to(sdt)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True).float())
        p = torch.exp(s - m_new.to(sdt))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.float().sum(-1, keepdim=True)
        pv = p.to(in_dtype).float()
        acc = acc * alpha + pv @ vh[:, :, start:stop].float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(in_dtype).permute(0, 2, 1, 3).contiguous()


def _bind(lib: ctypes.CDLL):
    """The C entry attn_sweep_fwd_bf16 of a library built from
    attn_sweep_fwd.cu, with its argument types."""
    fn = lib.attn_sweep_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float,
                                                ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from ovmono3d_tpu_torch.utils import cuda_build

    return _bind(cuda_build.load(KERNEL_SOURCES)["attn_sweep_fwd.cu"])


def build_kernels() -> None:
    """Compile (or load) the sweep's library now rather than at the first
    launch."""
    _kernel()


def _check(q, k, v, instance) -> None:
    if instance not in INSTANCES:
        raise ValueError(f"(block_q, block_k, softmax_f32) = {instance}; the "
                         f"kernel's instances are {INSTANCES}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {x.dtype}; the kernel takes bfloat16")
        if x.dim() != 4 or x.shape != q.shape or x.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name} has shape {tuple(x.shape)}; want "
                             f"[B, N, H, {HEAD_DIM}] equal to q's")
        if (x.stride(-1) != 1 or x.data_ptr() % 16
                or any(s % 8 for s in x.stride()[:3])):
            raise ValueError(f"{name}: unit stride over D and 16-byte aligned "
                             f"pointer and strides needed ({x.stride()})")
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError("attn_sweep is forward-only")
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; the kernel needs all "
                             "its tensors on one CUDA device")


def attn_sweep(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               block_q: int = 64, block_k: int = 64,
               softmax_f32: bool = True) -> torch.Tensor:
    """Kernel 11 at one instance of the sweep; CPU tensors run
    `attn_sweep_ref` (block_q changes only the kernel's tiling)."""
    if q.device.type == "cpu":
        return attn_sweep_ref(q, k, v, block_k, softmax_f32)
    instance = (block_q, block_k, bool(softmax_f32))
    out = _launch(_kernel(), q, k, v, instance)
    attn_sweep.launches[instance] += 1
    return out


def _launch(fn, q, k, v, instance) -> torch.Tensor:
    """One launch of the C entry `fn` at `instance`, after the checks."""
    _check(q, k, v, instance)
    block_q, block_k, softmax_f32 = instance
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                n, h, d, block_q, block_k, int(softmax_f32), *strides,
                1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"attn_sweep_fwd_bf16 {instance} launch failed "
                           f"with CUDA error {rc} (B={b}, N={n}, H={h})")
    return out


attn_sweep.launches = dict.fromkeys(INSTANCES, 0)
