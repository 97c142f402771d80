"""Kernel 7 on the card: SAM's decomposed rel-pos attention forward
(csrc/relpos_flash_fwd.cu) at SAM ViT-H's global and windowed blocks.

    python -m ovmono3d_tpu_torch.probes.relpos
    python -m ovmono3d_tpu_torch.probes.relpos --repeats 5
    python -m ovmono3d_tpu_torch.probes.relpos --previous DIR

At each of SHAPES (q, k, v ~ N(0, 1) bf16 as strided views of one packed
[B, N, 3, H, D] tensor, as the qkv projection leaves them; rel-pos tables
~N(0, 0.1^2), about a trained SAM table's scale; the bias factors from
`rel_pos_factors`) it holds the kernel to rel_pos_attention_ref (LIMITS:
absolute and relative), then times in turns the kernel and
F.scaled_dot_product_attention with the [B, H, N, N] bias expanded from
qrh and qrw inside the timed call (the same function as one PyTorch call,
a yardstick the port never calls), by CUDA events around one call and by
the profiler's device time (`probes.device_ms`; SDPA's: every device op of
its call, the bias expansion included). Prints the bound beside them: 4 B H
N^2 D flops at the bf16 tensor-core peak against q, k, v, out (bf16) and
qrh, qrw (f32) moved once.

--previous DIR times, in the same turns, the C entry of the copy of
relpos_flash_fwd.cu in DIR (an earlier design with the same entry, for
instance the parent commit's `ovmono3d_tpu_torch/csrc` unpacked outside
the tree) and holds it to the same limits. --repeats R takes only the
device times, R times in one process, the call timed first rotating, and
prints each one's median and range.
"""
from __future__ import annotations

import argparse
import ctypes
import math

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import attention
from ovmono3d_tpu_torch.probes import (PEAK_BF16_FLOPS, PEAK_BYTES, card,
                                       in_turns, previous_library, repeated,
                                       spread, time_ms)

# (B, (gh, gw), H, D): SAM ViT-H at 1024^2, its 4 global blocks (a 64x64
# grid) and its 28 windowed ones (14x14 windows of the grid padded to 70,
# 25 per image).
SHAPES = {"sam_h_global": (1, (64, 64), 16, 80),
          "sam_h_window": (25, (14, 14), 16, 80)}
REL_POS_STD = 0.1
# Against rel_pos_attention_ref: bf16 outputs and bf16 probabilities in PV
# on both sides, rounded at different points (tests/test_torch_relpos.py):
# max and mean absolute error, and relative to max and mean |ref|.
LIMITS = {"max_abs": 2e-2, "mean_abs": 2e-3, "max_rel": 5e-2,
          "mean_rel": 1e-2}
KERNEL = "relpos"                           # both designs' kernel names


def inputs(b, grid, h, d, seed: int = 0, device="cuda"):
    """q, k, v (views of one packed tensor), Rh, Rw and the bias factors
    qrh, qrw, as the SAM encoder makes them."""
    n = grid[0] * grid[1]
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * d, device=device, generator=g,
                      dtype=torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
    g = torch.Generator(device=device).manual_seed(1000 + seed)
    rh, rw = (torch.randn(x, x, d, device=device, generator=g) * REL_POS_STD
              for x in grid)
    return (q, k, v, rh, rw, *attention.rel_pos_factors(q, rh, rw, grid))


def bound_ms(b, grid, h, d) -> tuple[float, str]:
    """4 B H N^2 D flops; q, k, v, out in bf16 and qrh, qrw in f32, each
    moved once."""
    n = grid[0] * grid[1]
    flops = 4 * b * h * n * n * d
    nbytes = 4 * b * n * h * d * 2 + b * n * h * (grid[0] + grid[1]) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_with_bias(q, k, v, qrh, qrw):
    """The same function as one PyTorch call: SDPA with the [B, H, N, N]
    bias expanded from qrh/qrw (inside the call, as the kernel does)."""
    b, n, h, _ = q.shape
    bias = (qrh.permute(0, 2, 1, 3)[..., :, None]
            + qrw.permute(0, 2, 1, 3)[..., None, :]).reshape(b, h, n, n)
    return F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), attn_mask=bias.to(q.dtype))


def error(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max and mean absolute error, relative to max and mean |want|, and
    whether all are within LIMITS."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    out = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "max_rel": (err.max() / ref.max()).item(),
           "mean_rel": (err.mean() / ref.mean()).item()}
    out["ok"] = (out["max_abs_err"] <= LIMITS["max_abs"]
                 and out["mean_abs_err"] <= LIMITS["mean_abs"]
                 and out["max_rel"] <= LIMITS["max_rel"]
                 and out["mean_rel"] <= LIMITS["mean_rel"])
    return out


def previous_relpos(csrc: str):
    """The earlier design's launch from the directory `csrc`, with the
    shipped wrapper's arguments: fn(q, k, v, qrh, qrw, grid) -> out."""
    fn = previous_library("relpos_flash_fwd.cu", csrc).relpos_flash_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, qrh, qrw, grid):
        b, n, h, d = q.shape
        out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qrh.data_ptr(),
                qrw.data_ptr(), out.data_ptr(), b, n, h, d, *grid,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the previous relpos_flash_fwd_bf16 failed "
                               f"with CUDA error {rc}")
        return out

    return run


def _calls(x: tuple, grid, previous=None) -> dict:
    q, k, v, _, _, qrh, qrw = x
    calls = {"kernel": (lambda: attention.rel_pos_flash_attention(
        q, k, v, qrh, qrw, grid), KERNEL)}
    if previous is not None:
        calls["previous"] = (lambda: previous(q, k, v, qrh, qrw, grid),
                             KERNEL)
    calls["sdpa"] = (lambda: sdpa_with_bias(q, k, v, qrh, qrw), "")
    return calls


def rows(shapes=None, reps: int = 20, previous: str | None = None) -> dict:
    """{shape name: row}: ms, device_ms, library_ms and library_device_ms
    (SDPA with the bias), plain_ms, bound_ms, bound_by and `error`'s keys
    against rel_pos_attention_ref; with `previous` (a directory of
    sources) also previous_ms, previous_device_ms and previous_ok."""
    prev = None if previous is None else previous_relpos(previous)
    out = {}
    for i, name in enumerate(shapes or SHAPES):
        b, grid, h, d = SHAPES[name]
        x = inputs(b, grid, h, d, seed=i)
        q, k, v, rh, rw, qrh, qrw = x
        with torch.no_grad():
            want = attention.rel_pos_attention_ref(q, k, v, rh, rw, grid)
            row = error(attention.rel_pos_flash_attention(q, k, v, qrh, qrw,
                                                          grid), want)
            if prev is not None:
                row["previous_ok"] = error(prev(q, k, v, qrh, qrw, grid),
                                           want)["ok"]
            del want
            t = in_turns(_calls(x, grid, prev), reps)
            row["plain_ms"] = time_ms(lambda: attention.rel_pos_attention_ref(
                q, k, v, rh, rw, grid), 3)
        row["ms"], row["device_ms"] = t["kernel"]
        row["library_ms"], row["library_device_ms"] = t["sdpa"]
        if prev is not None:
            row["previous_ms"], row["previous_device_ms"] = t["previous"]
        row["bound_ms"], row["bound_by"] = bound_ms(b, grid, h, d)
        out[name] = row
    return out


def describe(name: str, r: dict) -> str:
    """One printed line of a row."""
    old = (f"; previous {r['previous_ms']:.4f} / "
           f"{r['previous_device_ms']:.4f} ms (within the limits: "
           f"{r['previous_ok']})" if "previous_ms" in r else "")
    share = r["bound_ms"] / r["device_ms"]
    return (f"{name} {SHAPES[name]}: kernel {r['ms']:.4f} ms events / "
            f"{r['device_ms']:.4f} ms device ({share:.1%} of the bound)"
            f"{old}; SDPA with bias {r['library_ms']:.4f} / "
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
                             "relpos_flash_fwd.cu (and its headers) to time "
                             "in turns with the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}", flush=True)
    if args.repeats <= 0:
        for name, r in rows(previous=args.previous).items():
            print(describe(name, r), flush=True)
        return
    prev = None if args.previous is None else previous_relpos(args.previous)
    for i, (name, (b, grid, h, d)) in enumerate(SHAPES.items()):
        x = inputs(b, grid, h, d, seed=i)
        with torch.no_grad():
            times = repeated(_calls(x, grid, prev), args.repeats)
        for call, ts in times.items():
            print(f"{name} {call}: device ms {spread(ts)}", flush=True)


if __name__ == "__main__":
    main()
