"""The bf16 D = 64 flash-attention backward on the card (kernel 4, whose
wrapper also serves the JAX package's head-major kernel 6): the wgmma + TMA
design of csrc/flash_attn_bwd.cu against the backward of
F.scaled_dot_product_attention.

    python -m ovmono3d_tpu_torch.probes.flash_bwd
    python -m ovmono3d_tpu_torch.probes.flash_bwd --shape train_b8 --repeats 7

At each of SHAPES (q, k, v ~ N(0, 1) bf16, strided views of one packed
[B, N, 3, H, D] tensor as the qkv projection leaves them; o and lse from
kernel 3 on them; do ~ N(0, 1)) it holds dq, dk and dv to
attention_bwd_ref, one batch element at a time, then times, in turns
(kernel, SDPA, then SDPA, kernel), the kernel through
flash_attention_packed_bwd and SDPA's backward on the same views (a
yardstick the port never calls). Each is timed two ways: CUDA events around
one call (the ctypes wrapper's host time included) and the profiler's
device time of every device op the call launches (`probes.device_ms`), so
the stats pass counts as SDPA's own ops do. Besides, the device time of the
launch's three kernels apart, and of the torch ops that would compute delta
in place of the stats pass. Prints the bound of the work beside them:
10 B H N^2 D flops at the bf16 tensor-core peak.

With --repeats R it takes only the timings, R times in one process at each
--shape (default all), and prints each repetition's device times of the
two and their median and range.
"""
from __future__ import annotations

import argparse
import statistics

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import attention
from ovmono3d_tpu_torch.probes import (PEAK_BF16_FLOPS, PEAK_BYTES, card,
                                       device_ms, in_turns, repeated, spread)

# LIFT's trunk at B=1; the B=8 train step's trunk; a sequence past the JAX
# package's packed gate (6144); a small ragged case.
SHAPES = {"trunk": (1, 4097, 12, 64), "train_b8": (8, 4097, 12, 64),
          "long": (1, 8192, 12, 64), "ragged": (2, 77, 12, 64)}
# Names of the launch's kernels, for the breakdown of its device time.
STATS_KERNEL = "bwd_stats_kernel"
DKDV_KERNEL, DQ_KERNEL = ("flash_bwd_sm90_kernel<true",
                          "flash_bwd_sm90_kernel<false")


def inputs(shape, seed: int = 0, device="cuda"):
    """q, k, v (views of one packed tensor), o and lse from kernel 3, do."""
    b, n, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device=device,
                      dtype=torch.bfloat16)
    do = torch.randn(b, n, h, d, generator=g, device=device,
                     dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    with torch.no_grad():
        o, lse = attention.flash_attention_packed_lse(q, k, v)
    return q, k, v, o, lse, do


def torch_delta(o, do):
    """delta by torch ops, as the port computed it before the stats pass."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def sdpa_bwd(q, k, v, do):
    """A callable that runs SDPA's backward alone: one forward with
    autograd, then each call reuses its graph."""
    with torch.enable_grad():
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (qg, kg, vg)))
    do_t = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do_t,
                                       retain_graph=True)


def bound_ms(shape) -> tuple[float, str]:
    """The larger of 10 B H N^2 D flops at the bf16 peak and q, k, v, o, do,
    dq, dk, dv (bf16) and lse (f32) once each at the memory rate."""
    b, n, h, d = shape
    t_ops = 10 * b * h * n * n * d / PEAK_BF16_FLOPS
    t_bytes = (8 * b * n * h * d * 2 + 4 * b * h * n) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def errors(grads, want) -> dict:
    """Max abs error, and the max and mean error relative to the largest
    and the mean |ref|, over dq, dk and dv."""
    out = {"max_abs_err": 0.0, "max_rel": 0.0, "mean_rel": 0.0}
    for g, w in zip(grads, want):
        err, ref = (g.float() - w).abs(), w.abs()
        out["max_abs_err"] = max(out["max_abs_err"], err.max().item())
        out["max_rel"] = max(out["max_rel"],
                             err.max().item() / ref.max().item())
        out["mean_rel"] = max(out["mean_rel"],
                              err.mean().item() / ref.mean().item())
    return out


def max_errors(q, k, v, o, lse, do) -> dict:
    """errors() of the kernel against attention_bwd_ref, one batch element
    at a time, the worst over the batch."""
    worst = {}
    with torch.no_grad():
        for i in range(q.shape[0]):
            xs = [x[i:i + 1] for x in (q, k, v, o, lse, do)]
            want = attention.attention_bwd_ref(*xs)
            e = errors(attention.flash_attention_packed_bwd(*xs).unbind(2),
                       want)
            worst = {name: max(val, worst.get(name, 0.0))
                     for name, val in e.items()}
            del want
    return worst


def rows(shapes=None, reps: int = 10) -> dict:
    """One row per shape: {ms, device_ms, library_ms, library_device_ms,
    stats_device_ms, dkdv_device_ms, dq_device_ms, torch_delta_device_ms,
    bound_ms, bound_by, max_abs_err, max_rel, mean_rel}."""
    out = {}
    for name, shape in (shapes or SHAPES).items():
        q, k, v, o, lse, do = inputs(shape)
        err = max_errors(q, k, v, o, lse, do)
        with torch.no_grad():
            kernel = lambda: attention.flash_attention_packed_bwd(  # noqa: E731
                q, k, v, o, lse, do)
            # Device ms of every device op of a call.
            t = in_turns({"kernel": (kernel, ""),
                          "sdpa": (sdpa_bwd(q, k, v, do), "")}, reps)
            parts = {key: device_ms(kernel, match, reps) for key, match in (
                ("stats_device_ms", STATS_KERNEL),
                ("dkdv_device_ms", DKDV_KERNEL),
                ("dq_device_ms", DQ_KERNEL))}
            parts["torch_delta_device_ms"] = device_ms(
                lambda: torch_delta(o, do), "", reps)
        bound, bound_by = bound_ms(shape)
        out[name] = {
            "shape": shape, "ms": t["kernel"][0], "device_ms": t["kernel"][1],
            "library_ms": t["sdpa"][0], "library_device_ms": t["sdpa"][1],
            **parts, "bound_ms": bound, "bound_by": bound_by, **err}
        del q, k, v, o, lse, do
    return out


def describe(name: str, r: dict) -> str:
    """One printed line of a row."""
    share = r["bound_ms"] / r["device_ms"]
    return (f"{name} {list(r['shape'])} bwd: kernel {r['ms']:.4f} ms events "
            f"/ {r['device_ms']:.4f} ms device ({share:.1%} of the bound; "
            f"stats {r['stats_device_ms']:.4f}, dk/dv "
            f"{r['dkdv_device_ms']:.4f}, dq {r['dq_device_ms']:.4f}; torch's "
            f"delta ops {r['torch_delta_device_ms']:.4f}); SDPA "
            f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); vs plain: max|err| "
            f"{r['max_abs_err']:.2e} ({r['max_rel']:.2e} of max|ref|, mean "
            f"{r['mean_rel']:.2e} of mean)")


def repeated_times(shape, repeats: int, reps: int = 10) -> dict:
    """{call: [device ms of each repetition]} for "kernel" and "sdpa" on
    one set of inputs (`probes.repeated`)."""
    q, k, v, o, lse, do = inputs(shape)
    with torch.no_grad():
        return repeated({
            "kernel": (lambda: attention.flash_attention_packed_bwd(
                q, k, v, o, lse, do), ""),
            "sdpa": (sdpa_bwd(q, k, v, do), "")}, repeats, reps)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", action="append", choices=sorted(SHAPES),
                        help="a shape of SHAPES (repeatable; default all)")
    parser.add_argument("--repeats", type=int, default=0,
                        help="time only, this many times at each shape")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}")
    shapes = {name: SHAPES[name] for name in args.shape or SHAPES}
    if args.repeats <= 0:
        for name, r in rows(shapes).items():
            print(describe(name, r), flush=True)
        return
    for name, shape in shapes.items():
        times = repeated_times(shape, args.repeats)
        for call, ts in times.items():
            print(f"{name} {list(shape)} {call}: device ms {spread(ts)}",
                  flush=True)
        ratio = [a / b for a, b in zip(times["kernel"], times["sdpa"])]
        print(f"{name} kernel / sdpa by repetition: "
              f"{' '.join(f'{x:.4f}' for x in ratio)}; median "
              f"{statistics.median(ratio):.4f}", flush=True)


if __name__ == "__main__":
    main()
