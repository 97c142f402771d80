"""The block-size sweep of the attention forward on the card: the port's
counterpart of tools/profile_attn_sweep.py.

    python -m ovmono3d_tpu_torch.probes.attn_sweep
    python -m ovmono3d_tpu_torch.probes.attn_sweep --repeats 5
    python -m ovmono3d_tpu_torch.probes.attn_sweep --previous DIR

At the probe's [1, 4097, 12, 64] bf16 (q, k, v ~ U(0, 1) from seed 0) it
times every instance of kernel 11 (csrc/attn_sweep_fwd.cu: block_q and
block_k in {64, 128}, softmax in f32 or bf16) and
F.scaled_dot_product_attention on the same views (a yardstick the port
never calls) in turns, each by CUDA events around a call (the ctypes
wrapper's host time included) and by the profiler's device time
(`probes.device_ms`), and prints beside them the bound of the work (4 N^2 D
flops a head on the bf16 tensor cores) and the error against
`attn_sweep_ref` at the instance's block_k. The error is taken at the same
shape on peaked rows (`checked_inputs`: q, k ~ 2 N(0, 1), v ~ N(0, 1)):
with the probe's U(0, 1) inputs the logits q.k/8 spread by ~0.2 across
keys, every output row is close to the mean of v, and a kernel that
ignored q and k would look right. Each pair of instances that differ only
in block_q must give bit-identical outputs (`block_q_identical`).

--previous DIR times, in the same turns, the C entry of the copy of
attn_sweep_fwd.cu in DIR (an earlier design, for instance the parent
commit's `ovmono3d_tpu_torch/csrc` unpacked outside the tree) and holds it
to the same limit. --repeats R takes only the device times, R times in one
process, the call timed first rotating, and prints each one's median and
range.
The TPU probe's trace parsing has no counterpart: the profiler's device
time stands in for it.
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import attn_sweep as sweep
from ovmono3d_tpu_torch.probes import (PEAK_BF16_FLOPS, PEAK_BYTES,
                                       bf16_ulp_diff, card, in_turns,
                                       previous_library, repeated, spread,
                                       time_ms)

SHAPE = (1, 4097, 12, 64)
# The kernels' names, for the profiler's device time (both designs' names
# hold it; SDPA's: every device op of its call).
KERNEL = "sweep_fwd"
# An instance against its plain version on `checked_inputs`: at most
# ULP_SHARE of the elements more than one bf16 ulp apart, and no element
# more than ATOL apart. Sound pairs (the plain version against the TPU
# kernel in interpret mode, or with its logits summed in float64) leave
# 3e-5 to 2e-4 of the elements beyond one ulp, and 1.7e-3 where a row's
# dominant bf16 logit rounds the other way in one sum order (one row in 600
# at [1, 300, 2, 64]); that moves the row's weight by up to one ulp of the
# logit (2^-4 at |s| < 16), its output by up to ~0.02 there and by at most
# 2^-4 p (1 - p) |v_i - out| ~ 0.15 anywhere. The bf16 softmax against the
# f32 one leaves 0.45-0.6 of the elements beyond one ulp, the mean of v
# (uniform weights) nearly all.
ATOL, ULP_SHARE = 0.15, 1e-2


def inputs(shape=SHAPE, seed: int = 0, device="cuda"):
    """q, k, v ~ U(0, 1) (the TPU probe's) as strided views of one packed
    [B, N, 3, H, D] tensor."""
    b, n, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.rand(b, n, 3, h, d, generator=g, device=device).bfloat16()
    return qkv.unbind(2)


def checked_inputs(shape=SHAPE, seed: int = 1, device="cuda"):
    """q, k ~ 2 N(0, 1), v ~ N(0, 1), the same packed views: logits with a
    spread of ~4, so each row's softmax is peaked and the bf16 softmax's
    roundings move outputs of ~1 apart from the f32 one's."""
    b, n, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device=device)
    qkv[:, :, :2] *= 2.0
    return qkv.bfloat16().unbind(2)


def bound_ms(shape=SHAPE) -> tuple[float, str]:
    """The larger of 4 B H N^2 D flops at the bf16 peak and q, k, v, out
    once each at the memory rate."""
    b, n, h, d = shape
    t_ops = 4 * b * h * n * n * d / PEAK_BF16_FLOPS
    t_bytes = 4 * b * n * h * d * 2 / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def error(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max_abs_err, the share of elements more than one bf16 ulp of `want`
    away, and whether both are within the limit (ATOL, ULP_SHARE)."""
    err = (got.float() - want.float()).abs().max().item()
    share = bf16_ulp_diff(got, want)[1] / got.numel()
    return {"max_abs_err": err, "share_beyond_ulp": share,
            "ok": err <= ATOL and share <= ULP_SHARE}


def block_q_identical(outs: dict) -> dict:
    """{(block_k, softmax_f32): whether the instances at block_q 64 and 128
    gave bit-identical outputs}, from {instance: output}."""
    return {(bk, f32): torch.equal(outs[(64, bk, f32)], outs[(128, bk, f32)])
            for _, bk, f32 in sweep.INSTANCES if (64, bk, f32) in outs}


def _calls(q, k, v, previous=None) -> dict:
    """{name: (fn, kernel-name match)}: every instance ("bq64 bk128 f32"
    and so on), the earlier design's ("previous ...") where given, SDPA."""
    calls = {}
    for inst in sweep.INSTANCES:
        label = "bq{} bk{} {}".format(inst[0], inst[1],
                                      "f32" if inst[2] else "bf16")
        calls[label] = (lambda i=inst: sweep.attn_sweep(q, k, v, *i), KERNEL)
        if previous is not None:
            calls["previous " + label] = (
                lambda i=inst: sweep._launch(previous, q, k, v, i), KERNEL)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    calls["sdpa"] = (lambda: F.scaled_dot_product_attention(qs, ks, vs), "")
    return calls


def _previous(csrc: str | None):
    return (None if csrc is None else
            sweep._bind(previous_library("attn_sweep_fwd.cu", csrc)))


def rows(shape=SHAPE, reps: int = 20, previous: str | None = None
         ) -> list[dict]:
    """One row per instance: block_q, block_k, softmax_f32, ms and
    device_ms (on the probe's inputs), `error` against the plain version at
    its block_k on `checked_inputs`, block_q_identical, plain_ms,
    library_ms and library_device_ms (SDPA), bound_ms, bound_by; with
    `previous` (a directory of sources) also previous_ms,
    previous_device_ms and previous_ok."""
    prev = _previous(previous)
    q, k, v = inputs(shape)
    qc, kc, vc = checked_inputs(shape)
    outs = {inst: sweep.attn_sweep(qc, kc, vc, *inst)
            for inst in sweep.INSTANCES}
    same = block_q_identical(outs)
    with torch.no_grad():
        t = in_turns(_calls(q, k, v, prev), reps)
    bound, bound_by = bound_ms(shape)
    out = []
    for (bq, bk, f32), got in outs.items():
        label = f"bq{bq} bk{bk} {'f32' if f32 else 'bf16'}"
        want = sweep.attn_sweep_ref(qc, kc, vc, bk, f32)
        row = {"block_q": bq, "block_k": bk, "softmax_f32": f32,
               "ms": t[label][0], "device_ms": t[label][1],
               **error(got, want), "block_q_identical": same[(bk, f32)],
               "plain_ms": time_ms(lambda: sweep.attn_sweep_ref(
                   q, k, v, bk, f32), 5),
               "library_ms": t["sdpa"][0], "library_device_ms": t["sdpa"][1],
               "bound_ms": bound, "bound_by": bound_by}
        if prev is not None:
            old = sweep._launch(prev, qc, kc, vc, (bq, bk, f32))
            row.update(previous_ms=t["previous " + label][0],
                       previous_device_ms=t["previous " + label][1],
                       previous_ok=error(old, want)["ok"])
        out.append(row)
    return out


def describe(r: dict) -> str:
    """One printed line of a row."""
    sm = "f32 " if r["softmax_f32"] else "bf16"
    old = (f"; previous {r['previous_ms']:.4f} / "
           f"{r['previous_device_ms']:.4f} ms (within the limit: "
           f"{r['previous_ok']})" if "previous_ms" in r else "")
    return (f"{sm} bq{r['block_q']:<3} bk{r['block_k']:<3} {r['ms']:.4f} ms "
            f"events / {r['device_ms']:.4f} ms device ("
            f"{r['bound_ms'] / r['device_ms']:.1%} of the bound){old}; SDPA "
            f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
            f"{r['plain_ms']:.4f} ms; max|err| vs plain {r['max_abs_err']:.2e} "
            f"(peaked rows; {r['share_beyond_ulp']:.2e} of the elements > 1 "
            f"ulp; within the limit: {r['ok']}); bit-identical across "
            f"block_q: {r['block_q_identical']}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=0,
                        help="device times only, this many times")
    parser.add_argument("--previous", metavar="DIR",
                        help="a directory holding an earlier "
                             "attn_sweep_fwd.cu (and its headers) to time "
                             "in turns with the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}; q, k, v {list(SHAPE)} bf16")
    if args.repeats <= 0:
        for r in rows(previous=args.previous):
            print(describe(r), flush=True)
        return
    q, k, v = inputs()
    with torch.no_grad():
        times = repeated(_calls(q, k, v, _previous(args.previous)),
                         args.repeats)
    for name, ts in times.items():
        print(f"{name}: device ms {spread(ts)}", flush=True)


if __name__ == "__main__":
    main()
