"""The bf16 D = 64 flash-attention forward on the card (kernels 1 and 3,
whose wrappers also serve the JAX package's head-major kernels 2 and 5): the
wgmma + TMA design of csrc/flash_attn_fwd.cu against
F.scaled_dot_product_attention.

    python -m ovmono3d_tpu_torch.probes.flash_fwd

At each of SHAPES (q, k, v ~ N(0, 1) bf16, strided views of one packed
[B, N, 3, H, D] tensor, as the qkv projection leaves them) it holds the
inference and lse instances to attention_ref / attention_lse_ref, then
times, in turns (kernel, SDPA, then SDPA, kernel), the kernel through
flash_attention_packed / flash_attention_packed_lse and SDPA's forward on
the same views (a yardstick the port never calls). Each is timed two ways:
CUDA events around one call (the ctypes wrapper's host time included) and
the profiler's device time of the kernels the call launches
(`probes.device_ms`). Prints the bound of the work beside them: 4 B H N^2 D
flops at the bf16 tensor-core peak.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import attention
from ovmono3d_tpu_torch.probes import (PEAK_BF16_FLOPS, PEAK_BYTES, card,
                                       in_turns)

# LIFT serving's trunk; an evaluation batch (and the B=8 train step's
# trunk, kernel 3's shape); bf16 Depth-Pro's 35 patch crops; a sequence past
# the JAX package's packed gate (6144).
SHAPES = {"trunk": (1, 4097, 12, 64), "eval_b8": (8, 4097, 12, 64),
          "depth_pro_patches": (35, 577, 16, 64), "long": (1, 8192, 12, 64)}
# The name of the kernel each call launches, for the profiler's device time
# (SDPA's: every device op of the call).
KERNEL = "flash_fwd_sm90_kernel"


def inputs(shape, seed: int = 0, device="cuda"):
    """q, k, v ~ N(0, 1) bf16 as strided views of one packed tensor."""
    b, n, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device=device,
                      dtype=torch.bfloat16)
    return qkv.unbind(2)


def bound_ms(shape, lse: bool = False) -> tuple[float, str]:
    """The larger of 4 B H N^2 D flops at the bf16 peak and q, k, v, out
    (and lse) once each at the memory rate."""
    b, n, h, d = shape
    t_ops = 4 * b * h * n * n * d / PEAK_BF16_FLOPS
    t_bytes = (4 * b * n * h * d * 2 + (4 * b * h * n if lse else 0)
               ) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_errors(q, k, v) -> dict:
    """Max abs error against the plain versions, one batch element at a
    time: "fwd" of both instances' out, "lse" of the lse."""
    err = {"fwd": 0.0, "lse": 0.0}
    with torch.no_grad():
        for i in range(q.shape[0]):
            qi, ki, vi = q[i:i + 1], k[i:i + 1], v[i:i + 1]
            want = attention.attention_ref(qi, ki, vi).float()
            want_o, want_lse = attention.attention_lse_ref(qi, ki, vi)
            got = attention.flash_attention_packed(qi, ki, vi).float()
            o, lse = attention.flash_attention_packed_lse(qi, ki, vi)
            err["fwd"] = max(err["fwd"], (got - want).abs().max().item(),
                             (o.float() - want_o).abs().max().item())
            err["lse"] = max(err["lse"], (lse - want_lse).abs().max().item())
            del want, want_o, want_lse
    return err


def rows(shapes=None, reps: int = 20) -> dict:
    """One row per (shape, instance): {"fwd" | "lse": {ms, device_ms,
    library_ms, library_device_ms, bound_ms, bound_by, max_abs_err}} by
    shape name. The lse row's library time is SDPA's forward (it returns no
    lse); its max_abs_err is the lse's, the out's is in the fwd row."""
    out = {}
    for name, shape in (shapes or SHAPES).items():
        q, k, v = inputs(shape)
        err = max_errors(q, k, v)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        with torch.no_grad():
            t = in_turns({
                "fwd": (lambda: attention.flash_attention_packed(q, k, v),
                        KERNEL),
                "lse": (lambda: attention.flash_attention_packed_lse(q, k, v),
                        KERNEL),
                "sdpa": (lambda: F.scaled_dot_product_attention(qs, ks, vs),
                         "")}, reps)
        out[name] = {}
        for kind in ("fwd", "lse"):
            bound, bound_by = bound_ms(shape, lse=kind == "lse")
            out[name][kind] = {
                "shape": shape, "ms": t[kind][0], "device_ms": t[kind][1],
                "library_ms": t["sdpa"][0],
                "library_device_ms": t["sdpa"][1],
                "bound_ms": bound, "bound_by": bound_by,
                "max_abs_err": err[kind]}
        del q, k, v, qs, ks, vs
    return out


def describe(name: str, kind: str, r: dict) -> str:
    """One printed line of a row."""
    share = r["bound_ms"] / r["device_ms"]
    return (f"{name} {list(r['shape'])} {kind}: kernel {r['ms']:.4f} ms "
            f"events / {r['device_ms']:.4f} ms device ({share:.1%} of the "
            f"bound); SDPA {r['library_ms']:.4f} / "
            f"{r['library_device_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); max|err| vs plain {r['max_abs_err']:.2e}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}")
    for name, by_kind in rows().items():
        for kind, r in by_kind.items():
            print(describe(name, kind, r), flush=True)


if __name__ == "__main__":
    main()
