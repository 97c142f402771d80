"""Fused row LayerNorm: the plain PyTorch versions and the Hopper kernel.

Counterpart of ovmono3d_tpu/ops/layernorm.py (kernel 9) and of the Pallas
variants of tools/probe_layernorm.py (kernel 12). As in the JAX package, no
model calls `layer_norm_fused`: the ViT's LayerNorm keeps its inline math
(ovmono3d_tpu/models/vit.py LayerNormBf16Out and the docstring of its
ops/layernorm.py say why). The op and the probe's variants are their own
entry points.

- `layer_norm_ref`: the plain version, the JAX package's `_ln_reference`
  (f32 mean and centred variance, `out_dtype` output).
- `layer_norm_fused(x, scale, bias, eps, out_dtype)`: routes as the JAX
  `_fused_core` does. A CUDA tensor with x.ndim >= 2 and C % 128 == 0 runs
  the kernel (`csrc/layernorm_fwd.cu`, instance kF32Stats) through the
  autograd Function `LayerNormFused`, whose backward differentiates the
  plain math, as the JAX custom_vjp differentiates `_ln_reference`. Every
  other input (CPU tensors, and CUDA tensors the gate refuses) runs the
  plain version under autograd. That copies the JAX gate; it is not a
  fallback: a gated-in tensor the kernel does not take raises (a width
  outside `WIDTHS`, the models' own, or a pointer not 16-byte aligned).
- The probe's variants, each a kernel instance with its own plain version
  (eps 1e-6, the output in x's dtype):
  - `ln_probe_v2` (`_ln_kernel`, the same math as kernel 9): instance
    kF32Stats;
  - `ln_probe_v3` (`_ln_kernel_dot`: the row sums as a product with a ones
    column, times f32(1 / C)): instance kRecipMean;
  - `ln_probe_v4` (`_ln_kernel_bf16`: as v3, with each square rounded to
    bf16 before its f32 sum; bf16 input): instance kBf16Squares.
  `ln_probe_ref(x, scale, bias, variant)` holds the plain versions.

Every launch adds one to `layernorm_fwd.launches[mode]` (mode "f32_stats",
"recip_mean" or "bf16_squares"). Layout: x [..., C] bf16 or f32, scale and
bias [C] f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

KERNEL_SOURCES = ["layernorm_fwd.cu"]
MODES = {"f32_stats": 0, "recip_mean": 1, "bf16_squares": 2}
# csrc/layernorm_fwd.cu's instances: the widths the models use.
WIDTHS = (128, 256, 512, 768, 1024, 1280)
_DTYPES = (torch.bfloat16, torch.float32)
PROBE_EPS = 1e-6                    # tools/probe_layernorm.py EPS
PROBE_MODES = {"v2": "f32_stats", "v3": "recip_mean", "v4": "bf16_squares"}


def layer_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis, in
    f32, cast to `out_dtype` (`_ln_reference` of the JAX package)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(out_dtype)


def ln_probe_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 variant: str) -> torch.Tensor:
    """The plain version of the probe's `variant` ("v2", "v3" or "v4"),
    eps 1e-6, the output in x's dtype."""
    if variant == "v2":
        return layer_norm_ref(x, scale, bias, PROBE_EPS, x.dtype)
    c = x.shape[-1]
    ones = torch.ones(c, 1, dtype=torch.float32, device=x.device)
    xf = x.float()
    mu = (xf @ ones) * (1.0 / c)
    xc = xf - mu
    sq = xc * xc
    if variant == "v4":
        sq = sq.to(torch.bfloat16).float()
    elif variant != "v3":
        raise ValueError(f"unknown probe variant {variant!r}: v2, v3 or v4")
    y = xc * torch.rsqrt((sq @ ones) * (1.0 / c) + PROBE_EPS)
    return (y * scale + bias).to(x.dtype)


@functools.cache
def _kernel():
    from ovmono3d_tpu_torch.utils import cuda_build

    fn = cuda_build.load(KERNEL_SOURCES)["layernorm_fwd.cu"].layernorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build_kernels() -> None:
    """Compile (or load) the LayerNorm library now rather than at the first
    launch."""
    _kernel()


def _check(x, scale, bias, out_dtype, mode: str) -> None:
    """ValueError for what the kernel does not take; x, scale and bias are
    the contiguous tensors it would read (16-byte vector loads)."""
    c = x.shape[-1]
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"x is {x.dtype}, out_dtype {out_dtype}; the kernel "
                         "takes bfloat16 or float32")
    if c not in WIDTHS:
        raise ValueError(f"C = {c}: the kernel's instances take C in "
                         f"{WIDTHS} (a multiple of 128 that a model uses)")
    if mode != "f32_stats" and (x.dtype != torch.bfloat16
                                or out_dtype != torch.bfloat16):
        raise ValueError(f"instance {mode} takes bf16 in and out; got "
                         f"{x.dtype} -> {out_dtype}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (c,):
            raise ValueError(f"{name} must be [C] = [{c}] float32; got "
                             f"{p.dtype} {tuple(p.shape)}")
    tensors = (("x", x), ("scale", scale), ("bias", bias))
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} starts at a pointer that is not 16-byte "
                             "aligned; the kernel loads 16-byte vectors")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             "its tensors on one CUDA device")


def layernorm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, out_dtype: torch.dtype,
                  mode: str = "f32_stats") -> torch.Tensor:
    """One launch of csrc/layernorm_fwd.cu's instance `mode` over x's rows
    ([..., C] -> [..., C] in `out_dtype`), or ValueError for what it does
    not take. Counts the launch in `layernorm_fwd.launches[mode]`."""
    xc = x.contiguous()
    sc, bi = scale.contiguous(), bias.contiguous()
    _check(xc, sc, bi, out_dtype, mode)
    c = x.shape[-1]
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = xc.numel() // c
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(xc.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                       out.data_ptr(), rows, c, int(x.dtype == torch.bfloat16),
                       int(out_dtype == torch.bfloat16), MODES[mode],
                       float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"layernorm_fwd ({mode}) launch failed with CUDA "
                           f"error {rc} (rows={rows}, C={c}, {x.dtype} -> "
                           f"{out_dtype})")
    layernorm_fwd.launches[mode] += 1
    return out


layernorm_fwd.launches = dict.fromkeys(MODES, 0)


class LayerNormFused(torch.autograd.Function):
    """The kernel forward; the backward differentiates `layer_norm_ref`
    under autograd (the JAX custom_vjp's bwd)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, out_dtype: torch.dtype):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.out_dtype = eps, out_dtype
        return layernorm_fwd(x, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
            y = layer_norm_ref(*leaves, ctx.eps, ctx.out_dtype)
            grads = torch.autograd.grad(y, leaves, grad)
        return (*grads, None, None)


def layer_norm_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """LayerNorm with f32 statistics and an `out_dtype` output over the last
    axis; the kernel for a CUDA tensor with x.ndim >= 2 and C % 128 == 0 (the
    JAX gate, with the card in place of the TPU), the plain version
    otherwise. Differentiable either way."""
    if x.device.type == "cuda" and x.ndim >= 2 and x.shape[-1] % 128 == 0:
        return LayerNormFused.apply(x, scale, bias, float(eps), out_dtype)
    return layer_norm_ref(x, scale, bias, eps, out_dtype)


def _probe(variant: str):
    def run(x: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return ln_probe_ref(x, scale, bias, variant)
        return layernorm_fwd(x, scale, bias, PROBE_EPS, x.dtype,
                             PROBE_MODES[variant])

    run.__name__ = f"ln_probe_{variant}"
    run.__doc__ = (f"The probe's {variant}: the kernel instance "
                   f"{PROBE_MODES[variant]} on CUDA tensors, its plain "
                   "version (`ln_probe_ref`) on CPU tensors; eps 1e-6, the "
                   "output in x's dtype.")
    return run


ln_probe_v2 = _probe("v2")
ln_probe_v3 = _probe("v3")
ln_probe_v4 = _probe("v4")
