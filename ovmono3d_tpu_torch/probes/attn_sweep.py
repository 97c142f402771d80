"""The block-size sweep of the attention forward on the card: the port's
counterpart of tools/profile_attn_sweep.py.

    python -m ovmono3d_tpu_torch.probes.attn_sweep

At the probe's [1, 4097, 12, 64] bf16 (q, k, v ~ U(0, 1) from seed 0) it
times every instance of kernel 11 (csrc/attn_sweep_fwd.cu: block_q and
block_k in {64, 128}, softmax in f32 or bf16) by CUDA events, and prints
beside each the bound of its work (4 N^2 D flops a head on the bf16 tensor
cores), F.scaled_dot_product_attention on the same views (a yardstick the
port never calls) and its error against `attn_sweep_ref` at its block_k.
The error is taken at the same shape on peaked rows (`checked_inputs`:
q, k ~ 2 N(0, 1), v ~ N(0, 1)): with the probe's U(0, 1) inputs the logits
q.k/8 spread by ~0.2 across keys, every output row is close to the mean of
v, and a kernel that ignored q and k would look right.
The TPU probe's trace parsing has no counterpart: CUDA events time the
kernel alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import attn_sweep as sweep
from ovmono3d_tpu_torch.probes import (PEAK_BF16_FLOPS, PEAK_BYTES,
                                       bf16_ulp_diff, card, time_ms)

SHAPE = (1, 4097, 12, 64)
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


def rows(shape=SHAPE, reps: int = 20) -> list[dict]:
    """One row per instance: block_q, block_k, softmax_f32, ms (on the
    probe's inputs), `error` against the plain version at its block_k on
    `checked_inputs`, plain_ms, library_ms (SDPA), bound_ms, bound_by."""
    q, k, v = inputs(shape)
    qc, kc, vc = checked_inputs(shape)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), reps)
    bound, bound_by = bound_ms(shape)
    out = []
    for bq, bk, f32 in sweep.INSTANCES:
        got = sweep.attn_sweep(qc, kc, vc, bq, bk, f32)
        want = sweep.attn_sweep_ref(qc, kc, vc, bk, f32)
        out.append({
            "block_q": bq, "block_k": bk, "softmax_f32": f32,
            "ms": time_ms(lambda: sweep.attn_sweep(q, k, v, bq, bk, f32),
                          reps),
            **error(got, want),
            "plain_ms": time_ms(lambda: sweep.attn_sweep_ref(q, k, v, bk,
                                                             f32), 5),
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}; q, k, v {list(SHAPE)} bf16")
    for r in rows():
        sm = "f32 " if r["softmax_f32"] else "bf16"
        print(f"{sm} bq{r['block_q']:<3} bk{r['block_k']:<3} {r['ms']:.4f} "
              f"ms/call  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"SDPA {r['library_ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"max|err| vs plain {r['max_abs_err']:.2e} (peaked rows; "
              f"{r['share_beyond_ulp']:.2e} of the elements > 1 ulp)")


if __name__ == "__main__":
    main()
