"""SAM-trunk training's attention on the card: kernel 7's lse instance and
the rel-pos backward (csrc/relpos_flash_bwd.cu: a stats pass, the dk/dv and
the dq kernels) at SAM's training shapes.

    python -m ovmono3d_tpu_torch.probes.relpos_bwd
    python -m ovmono3d_tpu_torch.probes.relpos_bwd --previous DIR

At each of SHAPES (q, k, v ~ N(0, 1) bf16 as views of one packed [B, N, 3,
H, D] tensor, tables ~N(0, 0.1^2), do ~N(0, 1)) it holds the lse
instance's out and lse and the backward's five gradients to
rel_pos_attention_lse_ref / rel_pos_attention_bwd_ref (max |error| relative
to max |ref|: LIMIT; the plain versions one image at a time past B = 2, as
their [B, H, N, N] f32 tensors would not fit side by side), checks two
backward launches bit-identical, and times in turns each kernel and its
PyTorch yardstick (never called by the port): SDPA with the [B, H, N, N]
bias built from qrh/qrw as a float mask in the call, forward for the lse
instance, forward + backward to q, k, v, qrh and qrw for the backward; by
CUDA events and by the profiler's device time, the backward's three
kernels apart; beside the plain versions' times and the bound (4 or 10 B H
N^2 D flops at the bf16 tensor-core peak against the bytes moved once).

--previous DIR times, in the same turns, the C entry of the copy of
relpos_flash_bwd.cu in DIR (an earlier design with the same entry, the
copy made outside the tree) and holds it to the same limit.
"""
from __future__ import annotations

import argparse
import ctypes
import math

import torch

from ovmono3d_tpu_torch.ops import attention
from ovmono3d_tpu_torch.probes import (PEAK_BF16_FLOPS, PEAK_BYTES, card,
                                       device_ms, in_turns, previous_library,
                                       time_ms)
from ovmono3d_tpu_torch.probes import relpos as relpos_probe

# (B, (gh, gw), H, D): SAM ViT-B's global and windowed blocks in a B=8
# train step at 1024^2, a global block of one image, and SAM-H's.
SHAPES = {"sam_b_global_b8": (8, (64, 64), 12, 64),
          "sam_b_global_b1": (1, (64, 64), 12, 64),
          "sam_b_window_b8": (200, (14, 14), 12, 64),
          "sam_h_global_b1": (1, (64, 64), 16, 80)}
# Max |error| against the f32 plain versions relative to max |ref|: bf16
# out, dq, dk, dv from bf16-rounded p and dS (kernel 4's rounding points);
# f32 lse, dqrh, dqrw.
LIMIT = 3e-2
PARTS = ("relpos_bwd_stats", "relpos_bwd_dkdv", "relpos_bwd_dq")


def bound_ms(b, grid, h, d, kind: str) -> tuple[float, str]:
    """The lse instance (4 B H N^2 D flops; q, k, v, out bf16, qrh, qrw,
    lse f32) or the backward (10 B H N^2 D flops; q, k, v, o, do, dq, dk,
    dv bf16, qrh, qrw, dqrh, dqrw, lse f32), each byte moved once."""
    n = grid[0] * grid[1]
    elems, bias = b * n * h * d, b * n * h * (grid[0] + grid[1])
    if kind == "bwd":
        flops, nbytes = 10 * b * h * n * n * d, 16 * elems + 8 * bias
    else:
        flops, nbytes = 4 * b * h * n * n * d, 8 * elems + 4 * bias
    nbytes += 4 * b * h * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_train_with_bias(q, k, v, qrh, qrw, do):
    """The backward's yardstick as one PyTorch call: relpos_probe's SDPA
    with the bias as a float mask, forward and backward to q, k, v, qrh and
    qrw."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (q, k, v, qrh, qrw)]
        out = relpos_probe.sdpa_with_bias(*xs)
        return torch.autograd.grad(out, xs, do.transpose(1, 2))


def previous_bwd(csrc: str):
    """The earlier design's launch from the directory `csrc`, with the
    shipped wrapper's arguments and outputs."""
    lib = previous_library("relpos_flash_bwd.cu", csrc)
    fn = lib.relpos_flash_bwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    floats = lib.relpos_flash_bwd_scratch_floats
    floats.argtypes = [ctypes.c_int] * 3
    floats.restype = ctypes.c_longlong

    def run(q, k, v, o, lse, do, qrh, qrw, grid):
        b, n, h, d = q.shape
        scratch = torch.empty(floats(b, n, h), dtype=torch.float32,
                              device=q.device)
        grad = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
        dq, dk, dv = grad.unbind(2)
        dqrh, dqrw = torch.empty_like(qrh), torch.empty_like(qrw)
        strides = [s for x in (q, k, v, o, do, dq, dk, dv)
                   for s in x.stride()[:3]]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), qrh.data_ptr(), qrw.data_ptr(), lse.data_ptr(),
                scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dqrh.data_ptr(), dqrw.data_ptr(), b, n, h, d,
                *grid, (ctypes.c_longlong * len(strides))(*strides),
                1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the previous relpos_flash_bwd_bf16 failed "
                               f"with CUDA error {rc}")
        return grad, dqrh, dqrw

    return run


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _per_image(fn, *xs):
    """fn over one image (one window past B = 2) at a time, the results
    concatenated."""
    if xs[0].shape[0] <= 2:
        return fn(*xs)
    outs = [fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def rows(shapes=None, reps: int = 10, previous: str | None = None) -> dict:
    """{shape name: {"lse": row, "bwd": row}}. Each row: ms, device_ms,
    library_ms, library_device_ms, plain_ms, bound_ms, bound_by, max_rel
    (the worst output against the plain version) and ok (within LIMIT; for
    the backward also bit-identical across two launches); the backward's
    also identical and each of PARTS' device ms; with `previous`,
    previous_ms, previous_device_ms and previous_rel."""
    prev = None if previous is None else previous_bwd(previous)
    out = {}
    for i, name in enumerate(shapes or SHAPES):
        b, grid, h, d = SHAPES[name]
        q, k, v, _, _, qrh, qrw = relpos_probe.inputs(b, grid, h, d, seed=i)
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        do = torch.randn(q.shape, device="cuda", generator=g,
                         dtype=torch.bfloat16)
        with torch.no_grad():
            o, lse = attention.rel_pos_flash_attention_lse(q, k, v, qrh, qrw,
                                                           grid)
            args = (q, k, v, o, lse, do, qrh, qrw, grid)
            plain = {
                "lse": lambda: _per_image(
                    lambda *a: attention.rel_pos_attention_lse_ref(*a, grid),
                    q, k, v, qrh, qrw),
                "bwd": lambda: _per_image(
                    lambda *a: attention.rel_pos_attention_bwd_ref(*a, grid),
                    *args[:-1])}
            r = {"lse": {"max_rel": max(map(_rel, (o, lse), plain["lse"]()))}}
            want = plain["bwd"]()
            got = attention.rel_pos_flash_attention_bwd(*args)
            again = attention.rel_pos_flash_attention_bwd(*args)
            flat = lambda x: (*x[0].unbind(2), x[1], x[2])  # noqa: E731
            r["bwd"] = {"max_rel": max(map(_rel, flat(got), want)),
                        "identical": all(torch.equal(x, y)
                                         for x, y in zip(got, again))}
            if prev is not None:
                r["bwd"]["previous_rel"] = max(map(
                    _rel, flat(prev(*args)), want))
            del want, got, again
            calls = {
                "lse": (lambda: attention.rel_pos_flash_attention_lse(
                    q, k, v, qrh, qrw, grid), "relpos_fwd"),
                "lse_library": (lambda: relpos_probe.sdpa_with_bias(
                    q, k, v, qrh, qrw), ""),
                "bwd": (lambda: attention.rel_pos_flash_attention_bwd(*args),
                        "relpos_bwd"),
                "bwd_library": (lambda: sdpa_train_with_bias(
                    q, k, v, qrh, qrw, do), "")}
            if prev is not None:
                calls["bwd_previous"] = (lambda: prev(*args), "relpos_bwd")
            t = in_turns(calls, reps)
            for part in PARTS:
                r["bwd"][part] = device_ms(
                    lambda: attention.rel_pos_flash_attention_bwd(*args),
                    part, reps)
            for kind in ("lse", "bwd"):
                row = r[kind]
                row["ms"], row["device_ms"] = t[kind]
                row["library_ms"], row["library_device_ms"] = \
                    t[f"{kind}_library"]
                row["plain_ms"] = time_ms(plain[kind], reps=2, warmup=1)
                row["bound_ms"], row["bound_by"] = bound_ms(b, grid, h, d,
                                                            kind)
                row["ok"] = (row["max_rel"] <= LIMIT
                             and row.get("identical", True))
            if prev is not None:
                r["bwd"]["previous_ms"], r["bwd"]["previous_device_ms"] = \
                    t["bwd_previous"]
        out[name] = r
        del q, k, v, qrh, qrw, do, o, lse, args
        torch.cuda.empty_cache()
    return out


def describe(name: str, kind: str, r: dict) -> str:
    """One printed line of a row."""
    what = ("kernel 7's lse instance" if kind == "lse"
            else "the rel-pos backward")
    library = "forward" if kind == "lse" else "forward + backward"
    parts = ("" if kind == "lse" else
             "; device ms by kernel " + ", ".join(f"{p} {r[p]:.4f}"
                                                   for p in PARTS))
    old = (f"; previous {r['previous_ms']:.4f} ms events / "
           f"{r['previous_device_ms']:.4f} ms device (max rel "
           f"{r['previous_rel']:.2e})" if "previous_ms" in r else "")
    same = (f"; two launches bit-identical: {r['identical']}"
            if "identical" in r else "")
    return (f"{what} {name} {SHAPES[name]}: {r['ms']:.4f} ms events / "
            f"{r['device_ms']:.4f} ms device "
            f"({r['bound_ms'] / r['device_ms']:.1%} of the bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_by']}){parts}{old}; plain "
            f"{r['plain_ms']:.4f} ms; SDPA with the bias as a float mask "
            f"{library} {r['library_ms']:.4f} ms events / "
            f"{r['library_device_ms']:.4f} ms device; vs plain max rel "
            f"{r['max_rel']:.2e} (limit {LIMIT}){same}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--previous", metavar="DIR",
                        help="a directory holding an earlier "
                             "relpos_flash_bwd.cu (and its headers) to time "
                             "in turns with the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}", flush=True)
    failed = []
    for name, r in rows(previous=args.previous).items():
        for kind in ("lse", "bwd"):
            print(describe(name, kind, r[kind]), flush=True)
            if not r[kind]["ok"]:
                failed.append(f"{name} {kind}")
    if failed:
        raise SystemExit(f"outside the limits or not deterministic: {failed}")


if __name__ == "__main__":
    main()
