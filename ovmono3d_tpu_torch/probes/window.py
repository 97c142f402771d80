"""Kernel 8 on the card: Swin's window attention forward
(csrc/window_attn_fwd.cu) at Swin-B's four stage shapes at 896^2.

    python -m ovmono3d_tpu_torch.probes.window
    python -m ovmono3d_tpu_torch.probes.window --repeats 5
    python -m ovmono3d_tpu_torch.probes.window --previous DIR

At each of SHAPES, shifted (the region ids of one image's windows, a shift
of half the window) and unshifted (no ids), with q, k, v ~ N(0, 1) bf16 as
strided views of one packed [BW, N, 3, H, 32] tensor, as the qkv projection
leaves them, and a bias [H, N, N] ~ N(0, 1) f32, it holds the kernel to
window_attention_ref (LIMITS: absolute and relative), then times in turns
the kernel and F.scaled_dot_product_attention with the [BW, H, N, N] bias
and shift mask built inside the timed call (`sdpa_window`: the same
function as one PyTorch call, a yardstick the port never calls), by CUDA
events around one call and by the profiler's device time
(`probes.device_ms`; SDPA's: every device op of its call, the mask's
construction included). Prints the bound beside them (`bound_ms`), the
plain version's time, and the host's time a call (`host_ms`: 200 calls
back to back by the host's clock) of the wrapper and of its C entry alone.

--previous DIR times, in the same turns, the C entry of the copy of
window_attn_fwd.cu in DIR (an earlier design with the same entry, for
instance the parent commit's `ovmono3d_tpu_torch/csrc` unpacked outside
the tree) behind the wrapper's own code (`previous_window`: the same
checks and launch, so host times compare on equal terms) and holds it to
the same limits. --repeats R takes only the
device times, R times in one process, the call timed first rotating, and
prints each one's median and range.
"""
from __future__ import annotations

import argparse
import functools
import math
import time
import types

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.models.gdino import swin
from ovmono3d_tpu_torch.ops import attention
from ovmono3d_tpu_torch.probes import (PEAK_BF16_FLOPS, PEAK_BYTES, card,
                                       in_turns, previous_library, repeated,
                                       spread, time_ms)

# (BW, N, H) of Swin-B's four stages at 896^2 (patch grid 224, window 12:
# 19^2, 10^2, 5^2 and 3^2 windows of 144 tokens, D = 32).
STAGES = {"stage0": (361, 144, 4), "stage1": (100, 144, 8),
          "stage2": (25, 144, 16), "stage3": (9, 144, 32)}
# Every stage shifted (the odd blocks) and unshifted (the even ones).
SHAPES = {f"{name}{'_shifted' if shifted else ''}": (*shape, shifted)
          for name, shape in STAGES.items() for shifted in (True, False)}
D = 32
# Against window_attention_ref: bf16 outputs and bf16 probabilities in PV
# on both sides, rounded at different points (chip_smoke.py's kernel
# limits): max and mean absolute error, and relative to max and mean |ref|.
LIMITS = {"max_abs": 2e-2, "mean_abs": 2e-3, "max_rel": 5e-2,
          "mean_rel": 1e-2}
KERNEL = "window_fwd"                       # both designs' kernel names


def inputs(bw, n, h, seed: int, shifted: bool, bias_std: float = 1.0,
           device="cuda"):
    """q, k, v (views of one packed tensor), an f32 bias [H, N, N] and, for a
    shifted block, the region ids of one image's sqrt(BW) x sqrt(BW)
    windows of sqrt(N) x sqrt(N) tokens (swin._region_ids, as the Swin
    blocks make them), else None."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(bw, n, 3 * h * D, device=device, generator=g,
                      dtype=torch.bfloat16)
    q, k, v = qkv.view(bw, n, 3, h, D).unbind(2)
    g = torch.Generator(device=device).manual_seed(2000 + seed)
    bias = torch.randn(h, n, n, device=device, generator=g) * bias_std
    ids = None
    if shifted:
        side, win = math.isqrt(bw), math.isqrt(n)
        ids = swin._region_ids(side * win, side * win, win, win // 2,
                               q.device)
    return q, k, v, bias, ids


def bound_ms(bw, n, h, d=D, nw=0) -> tuple[float, str]:
    """4 BW H N^2 D flops; q, k, v, out in bf16, the bias in f32 and nw
    windows' ids in int32, each moved once."""
    flops = 4 * bw * h * n * n * d
    nbytes = 4 * bw * n * h * d * 2 + h * n * n * 4 + nw * n * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_window(q, k, v, bias, ids):
    """The same function as one PyTorch call: SDPA with the [BW, H, N, N]
    bias and shift mask built inside the call, as the kernel does."""
    bw, n, h, _ = q.shape
    mask = bias[None].expand(bw, h, n, n)
    if ids is not None:
        nw = ids.shape[0]
        shift = torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -1e9)
        mask = (mask.reshape(bw // nw, nw, h, n, n)
                + shift[None, :, None]).reshape(bw, h, n, n)
    return F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)),
        attn_mask=mask.to(q.dtype)).transpose(1, 2)


def error(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max and mean absolute error, relative to max and mean |want|, and
    whether all are within LIMITS."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    out = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "max_rel": (err.max() / ref.max()).item(),
           "mean_rel": (err.mean() / ref.mean()).item()}
    out["ok"] = (bool(torch.isfinite(got).all())
                 and out["max_abs_err"] <= LIMITS["max_abs"]
                 and out["mean_abs_err"] <= LIMITS["mean_abs"]
                 and out["max_rel"] <= LIMITS["max_rel"]
                 and out["mean_rel"] <= LIMITS["mean_rel"])
    return out


def previous_entry(csrc: str):
    """The C entry window_attn_fwd_bf16 of the copy of window_attn_fwd.cu in
    the directory `csrc`, with the shipped entry's argument types."""
    entry = previous_library("window_attn_fwd.cu", csrc).window_attn_fwd_bf16
    shipped = attention._kernels()["window"]
    entry.argtypes, entry.restype = shipped.argtypes, shipped.restype
    return entry


def previous_window(csrc: str):
    """window_flash_attention's own code (its checks, its ctypes call, its
    launch count kept apart) on previous_entry(csrc): fn(q, k, v, bias,
    ids) -> out, the earlier design on the same host path as the shipped
    one."""
    kernels = {**attention._kernels(), "window": previous_entry(csrc)}
    names = {**vars(attention), "_kernels": functools.cache(lambda: kernels),
             "window_flash_attention": types.SimpleNamespace(launches=0)}
    wrapper = attention.window_flash_attention
    return types.FunctionType(wrapper.__code__, names, wrapper.__name__,
                              wrapper.__defaults__)


def bare_call(entry, q, k, v, bias, ids):
    """A call of the C entry `entry` alone, its arguments (the output
    included) made once, as window_flash_attention passes them: the C
    entry's share of the wrapper's host time."""
    bw, n, h, d = q.shape
    out = torch.empty((bw, n, h, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if ids is None else ids.data_ptr(), out.data_ptr(), bw, n,
            h, d, 0 if ids is None else ids.shape[0], *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = entry(*args)
        if rc != 0:
            raise RuntimeError(f"window_attn_fwd_bf16 failed with CUDA error "
                               f"{rc}")

    return call


def host_ms(fn, calls: int = 200, warmup: int = 20) -> float:
    """The host's time a call of `fn`, in ms: `calls` calls back to back
    with no synchronisation between them, by the host's clock. While the
    device keeps up, the queue of launches stays short and this is the
    wrapper's own cost (its checks, tensor maps and launch); the device's
    time is not in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def _calls(x: tuple, previous=None) -> dict:
    q, k, v, bias, ids = x
    calls = {"kernel": (lambda: attention.window_flash_attention(
        q, k, v, bias, ids), KERNEL)}
    if previous is not None:
        calls["previous"] = (lambda: previous(q, k, v, bias, ids), KERNEL)
    calls["sdpa"] = (lambda: sdpa_window(q, k, v, bias, ids), "")
    return calls


def host_times(x: tuple, prev=None, prev_entry=None) -> dict:
    """host_ms of the wrapper and entry_host_ms of its C entry alone
    (`bare_call`), and with `prev` and `prev_entry` (previous_window and
    previous_entry of one directory) previous_host_ms and
    previous_entry_host_ms: timed in the order given, then reversed,
    averaged."""
    q, k, v, bias, ids = x
    calls = {"host_ms": lambda: attention.window_flash_attention(
        q, k, v, bias, ids),
        "entry_host_ms": bare_call(attention._kernels()["window"], *x)}
    if prev is not None:
        calls["previous_host_ms"] = lambda: prev(q, k, v, bias, ids)
        calls["previous_entry_host_ms"] = bare_call(prev_entry, *x)
    out = dict.fromkeys(calls, 0.0)
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            out[name] += host_ms(calls[name]) / 2
    return out


def rows(shapes=None, reps: int = 20, previous: str | None = None) -> dict:
    """{shape name: row}: ms, device_ms, library_ms and library_device_ms
    (SDPA with the bias and mask), plain_ms, bound_ms, bound_by,
    `host_times`' keys and `error`'s keys against window_attention_ref;
    with `previous` (a directory of sources) also previous_ms,
    previous_device_ms and previous_ok."""
    prev = None if previous is None else previous_window(previous)
    prev_entry = None if previous is None else previous_entry(previous)
    out = {}
    for i, name in enumerate(shapes or SHAPES):
        bw, n, h, shifted = SHAPES[name]
        x = inputs(bw, n, h, i, shifted)
        q, k, v, bias, ids = x
        with torch.no_grad():
            want = attention.window_attention_ref(q, k, v, bias, ids)
            row = error(attention.window_flash_attention(q, k, v, bias, ids),
                        want)
            if prev is not None:
                row["previous_ok"] = error(prev(q, k, v, bias, ids),
                                           want)["ok"]
            del want
            t = in_turns(_calls(x, prev), reps)
            row.update(host_times(x, prev, prev_entry))
            row["plain_ms"] = time_ms(lambda: attention.window_attention_ref(
                q, k, v, bias, ids), 3)
        row["ms"], row["device_ms"] = t["kernel"]
        row["library_ms"], row["library_device_ms"] = t["sdpa"]
        if prev is not None:
            row["previous_ms"], row["previous_device_ms"] = t["previous"]
        row["bound_ms"], row["bound_by"] = bound_ms(
            bw, n, h, nw=0 if ids is None else ids.shape[0])
        out[name] = row
    return out


def describe(name: str, r: dict) -> str:
    """One printed line of a row: each time by events and device, and the
    host's time a call of the wrapper and of its C entry alone."""
    old = (f"; previous {r['previous_ms']:.4f} / "
           f"{r['previous_device_ms']:.4f} ms (events - device "
           f"{r['previous_ms'] - r['previous_device_ms']:.4f}; host "
           f"{r['previous_host_ms']:.4f}, C entry "
           f"{r['previous_entry_host_ms']:.4f}; within the limits: "
           f"{r['previous_ok']})" if "previous_ms" in r else "")
    share = r["bound_ms"] / r["device_ms"]
    bw, n, h, _ = SHAPES[name]
    return (f"{name} {(bw, n, h, D)}: kernel {r['ms']:.4f} ms events / "
            f"{r['device_ms']:.4f} ms device ({share:.1%} of the bound; "
            f"events - device {r['ms'] - r['device_ms']:.4f}; host "
            f"{r['host_ms']:.4f}, C entry {r['entry_host_ms']:.4f})"
            f"{old}; SDPA with bias and mask {r['library_ms']:.4f} / "
            f"{r['library_device_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; vs plain max "
            f"|err| {r['max_abs_err']:.2e} (mean {r['mean_abs_err']:.2e}, "
            f"relative {r['max_rel']:.2e} / {r['mean_rel']:.2e}; within the "
            f"limits: {r['ok']})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=0,
                        help="device times only, this many times")
    parser.add_argument("--previous", metavar="DIR",
                        help="a directory holding an earlier "
                             "window_attn_fwd.cu (and its headers) to time "
                             "in turns with the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}", flush=True)
    if args.repeats <= 0:
        for name, r in rows(previous=args.previous).items():
            print(describe(name, r), flush=True)
        return
    prev = None if args.previous is None else previous_window(args.previous)
    for i, (name, (bw, n, h, shifted)) in enumerate(SHAPES.items()):
        x = inputs(bw, n, h, i, shifted)
        with torch.no_grad():
            times = repeated(_calls(x, prev), args.repeats)
        for call, ts in times.items():
            print(f"{name} {call}: device ms {spread(ts)}", flush=True)


if __name__ == "__main__":
    main()
