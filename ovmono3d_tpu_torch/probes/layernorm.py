"""LayerNorm formulations at the ViT trunk's shape on the card: the port's
counterpart of tools/probe_layernorm.py.

    python -m ovmono3d_tpu_torch.probes.layernorm [--batch 8]

At [B, 4097, 768] bf16 (the probe's x ~ N(0.8, 1.7^2), scale ~ U(0.5, 1.5),
bias ~ N(0, 0.1^2), from seed 0) it runs, as the TPU probe does:
  v0  the plain math (f32 statistics, bf16 out; `layer_norm_ref`)
  v1  matmul statistics, mean and second moment through a ones column (not
      a Pallas kernel there, torch products here; var = m2 - mu^2 cancels)
  v2  kernel 9's instance (csrc/layernorm_fwd.cu kF32Stats), eps 1e-6
  v3  the row sums times f32(1 / C) (kRecipMean)
  v4  as v3 with the squares rounded to bf16 (kBf16Squares)
and prints for each its median time by CUDA events (for the kernels also
their device time from torch.profiler: around one call the events count the
wrapper's launch too), max|err| against v0 (as the probe's main), the error
against its own plain version (and how many elements differ from it, and
from v2's plain version) and the byte bound, with F.layer_norm (bf16
weights) on the same tensors beside them (a yardstick the port never calls).
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import layernorm as ln
from ovmono3d_tpu_torch.probes import (PEAK_BYTES, bf16_ulp_diff, card,
                                       device_ms, time_ms)

N, C = 4097, 768


def inputs(batch: int, n: int = N, c: int = C, seed: int = 0,
           device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(batch, n, c, generator=g, device=device) * 1.7
         + 0.8).to(torch.bfloat16)
    scale = torch.rand(c, generator=g, device=device) + 0.5
    bias = torch.randn(c, generator=g, device=device) * 0.1
    return x, scale, bias


def bound_ms(x: torch.Tensor, out_dtype: torch.dtype) -> float:
    """Each input read once and the output written once, at the card's
    memory rate: rows C (in + out) bytes + 8 C for scale and bias."""
    out_size = torch.tensor([], dtype=out_dtype).element_size()
    nbytes = x.numel() * (x.element_size() + out_size) + 8 * x.shape[-1]
    return nbytes / PEAK_BYTES * 1e3


def v1(x, scale, bias):
    """The probe's v1: statistics through products with a ones column."""
    c = x.shape[-1]
    ones = torch.ones(c, 1, dtype=x.dtype, device=x.device)
    mu = (x @ ones / c).float()
    m2 = ((x * x) @ ones / c).float()
    var = torch.clamp(m2 - mu * mu, min=0.0)
    y = (x.float() - mu) * torch.rsqrt(var + ln.PROBE_EPS)
    return (y * scale + bias).to(x.dtype)


def library(x, scale, bias):
    """F.layer_norm on the same tensors with the weights cast to x's dtype:
    PyTorch's CUDA layer_norm refuses bf16 input with f32 weights."""
    c = x.shape[-1]
    sb, bb = scale.to(x.dtype), bias.to(x.dtype)
    return lambda: F.layer_norm(x, (c,), sb, bb, ln.PROBE_EPS)


def rows(batch: int = 8, reps: int = 20) -> list[dict]:
    """One row per variant: name, ms, max_abs_err vs v0, plain_ms, bound_ms,
    library_ms (F.layer_norm); for the kernels also device_ms, the error
    against their own plain version, `n_diff` / `n_beyond_ulp` (elements
    that differ from it, and by more than one bf16 ulp) and `n_diff_v2`
    (elements that differ from v2's plain version: v4's bf16 squares move
    a measurable share; v3's reciprocal moves no more than the sum order)."""
    x, scale, bias = inputs(batch)
    v0 = ln.layer_norm_ref(x, scale, bias, ln.PROBE_EPS, x.dtype)
    lib_ms = time_ms(library(x, scale, bias), reps)
    bound = bound_ms(x, x.dtype)
    plain_v0 = time_ms(lambda: ln.layer_norm_ref(x, scale, bias,
                                                 ln.PROBE_EPS, x.dtype), reps)
    out = [{"name": "v0 plain", "ms": plain_v0, "err_v0": 0.0,
            "max_abs_err": 0.0, "plain_ms": plain_v0},
           {"name": "v1 matmul-stats",
            "ms": time_ms(lambda: v1(x, scale, bias), reps),
            "err_v0": (v1(x, scale, bias).float() - v0.float()).abs().max()
            .item(), "max_abs_err": None, "plain_ms": None}]
    plain_v2 = ln.ln_probe_ref(x, scale, bias, "v2")
    for variant in ("v2", "v3", "v4"):
        fn = getattr(ln, f"ln_probe_{variant}")
        got = fn(x, scale, bias)
        plain = ln.ln_probe_ref(x, scale, bias, variant)
        n_diff, n_beyond = bf16_ulp_diff(got, plain)
        out.append({
            "name": f"{variant} kernel", "variant": variant,
            "ms": time_ms(lambda: fn(x, scale, bias), reps),
            "device_ms": device_ms(lambda: fn(x, scale, bias),
                                   "ln_fwd_kernel", reps),
            "err_v0": (got.float() - v0.float()).abs().max().item(),
            "max_abs_err": (got.float() - plain.float()).abs().max().item(),
            "n_diff": n_diff, "n_beyond_ulp": n_beyond,
            "n_diff_v2": bf16_ulp_diff(got, plain_v2)[0],
            "n_elements": got.numel(),
            "plain_ms": time_ms(lambda: ln.ln_probe_ref(x, scale, bias,
                                                        variant), reps)})
    for row in out:
        row.update(bound_ms=bound, library_ms=lib_ms)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    table = rows(args.batch)
    print(f"card: {card()}; x [{args.batch}, {N}, {C}] bf16 -> bf16; "
          "F.layer_norm with bf16 weights")
    for r in table:
        own = ("" if "device_ms" not in r
               else f"  vs own plain {r['max_abs_err']:.2e} ({r['n_diff']} "
                    f"differ, {r['n_beyond_ulp']} by > 1 ulp; "
                    f"{r['n_diff_v2']} differ from v2's plain)  device "
                    f"{r['device_ms']:.4f} ms")
        print(f"{r['name']:<16} {r['ms']:8.4f} ms/call  max|err| vs v0: "
              f"{r['err_v0']:.2e}{own}  bound {r['bound_ms']:.4f} ms  "
              f"F.layer_norm {r['library_ms']:.4f} ms")


if __name__ == "__main__":
    main()
