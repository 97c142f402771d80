"""Multi-head attention: the plain PyTorch version and the Hopper kernel.

Counterpart of ovmono3d_tpu/ops/attention.py on the inference path:

- `attention_ref`: the plain version, the same math as `attention_xla`
  (f32 logits, f32 softmax, probabilities cast to v's dtype before PV). It
  is what CPU tensors run and what the kernel is held against.
- `flash_attention_packed`: the wrapper of the hand-written CUDA kernel
  `csrc/flash_attn_fwd.cu` (sm_90a), which replaces the TPU kernel
  `_flash_kernel_packed`. It takes q/k/v as strided views of the qkv
  projection's output and launches the kernel, or raises.
- `dot_product_attention`: the dispatcher. CPU tensors go to
  `attention_ref`, CUDA tensors to the kernel; nothing falls back.

Layout: [B, N, H, D] in and out.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

_KERNEL_SOURCES = ["flash_attn_fwd.cu"]
_HEAD_DIM = 64


def attention_ref(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v. q/k/v: [B, N, H, D] -> [B, N, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # Products of the input dtype are exact in f32, so f32 operands give the
    # same logits as an f32-accumulating product of the inputs.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    from ovmono3d_tpu_torch.utils import cuda_build

    lib = cuda_build.load("ovmono3d_attn", _KERNEL_SOURCES)
    fn = lib.flash_attn_fwd_bf16
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def build_kernels() -> None:
    """Compile (or load) the attention kernel library now rather than at the
    first launch."""
    _library()


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes q/k/v as they are. The
    device is checked last, so the layout checks run on CPU tensors too."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {x.dtype}; the kernel takes bfloat16")
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError(
                f"{name} has shape {tuple(x.shape)}; want [B, N, H, D] equal "
                f"to q's {tuple(q.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride over D")
        # 16-byte rows: cp.async moves 8 bf16 at a time.
        if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(
                f"{name}: pointer and batch/token/head strides must be "
                f"16-byte aligned (strides {x.stride()})")
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                "flash_attention_packed is forward-only; the backward "
                "kernels are ROADMAP queue 2 items 3-4")
    if q.shape[-1] != _HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]}; the kernel takes "
                         f"{_HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; the kernel needs "
                             f"q, k and v on one CUDA device")


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA flash-attention forward. [B, N, H, D] -> same.

    q/k/v may be strided views (the qkv projection's [B, N, 3, H, D] output
    unbound along the 3); the result is contiguous, so its [B, N, H*D] view
    is free. Counts each launch in `flash_attention_packed.launches`.
    """
    check_kernel_inputs(q, k, v)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    fn = _library().flash_attn_fwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, n, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attn_fwd_bf16 launch failed with CUDA error {rc} "
            f"(B={b}, N={n}, H={h}, D={d})")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Attention for the ViT trunk; [B, N, H, D] in and out."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v)
    if q.device.type == "cuda":
        return flash_attention_packed(q, k, v)
    raise ValueError(f"no attention path for device {q.device}")
