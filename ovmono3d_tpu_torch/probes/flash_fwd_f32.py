"""The f32 flash-attention forward on the card (kernel 1's f32 instance, and
kernel 2's f32 route, which launches the same C entry on head-major views):
csrc/flash_attn_fwd.cu `flash_attn_fwd_f32` against f32
F.scaled_dot_product_attention.

    python -m ovmono3d_tpu_torch.probes.flash_fwd_f32
    python -m ovmono3d_tpu_torch.probes.flash_fwd_f32 --repeats 5
    python -m ovmono3d_tpu_torch.probes.flash_fwd_f32 --previous DIR

At each of SHAPES (q, k, v ~ N(0, 1) f32, strided views of one packed
[B, N, 3, H, D] tensor, as the qkv projection leaves them) it holds the
kernel to f32 attention_ref (max error relative to max |ref|), then times
it and SDPA's f32 forward on the same views (a yardstick the port never
calls; PyTorch's f32 path, no TF32) in turns, each by
CUDA events around a call and by the profiler's device time, beside the
bound of the work: 4 B H N^2 D flops on the FP32 pipes (the products are
exact f32 FFMA). --previous DIR adds the C entry of the copy of
flash_attn_fwd.cu in DIR (an earlier design, for instance the parent
commit's `ovmono3d_tpu_torch/csrc` unpacked outside the tree) to the same
turns and checks. --repeats R takes only the device times, R times in one
process, the call timed first rotating, and prints each one's median and
range.
"""
from __future__ import annotations

import argparse
import ctypes
import math

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import attention
from ovmono3d_tpu_torch.probes import (PEAK_BYTES, PEAK_F32_FLOPS, card,
                                       in_turns, previous_library, repeated,
                                       spread)

# f32 Depth-Pro's image and FOV encoders (B = 1, 48 launches an image) and
# its patch encoder (the 35 pyramid crops, 24 launches an image); the f32
# LIFT trunk through kernel 2.
SHAPES = {"depth_pro": (1, 577, 16, 64),
          "depth_pro_patches": (35, 577, 16, 64),
          "trunk": (1, 4097, 12, 64)}
KERNEL = "flash_fwd_f32_kernel"


def inputs(shape, seed: int = 0, device="cuda"):
    """q, k, v ~ N(0, 1) f32 as strided views of one packed tensor."""
    b, n, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device=device)
    return qkv.unbind(2)


def bound_ms(shape) -> tuple[float, str]:
    """The larger of 4 B H N^2 D flops at the FP32 pipes' peak and q, k, v,
    out (f32) once each at the memory rate."""
    b, n, h, d = shape
    t_ops = 4 * b * h * n * n * d / PEAK_F32_FLOPS
    t_bytes = 4 * b * n * h * d * 4 / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def previous_fwd(csrc: str):
    """A callable (q, k, v) -> out launching the C entry flash_attn_fwd_f32
    of the copy of flash_attn_fwd.cu in the directory `csrc`, on the
    arguments of attention._launch_fwd."""
    fn = previous_library("flash_attn_fwd.cu", csrc).flash_attn_fwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float,
                                                ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v):
        attention.check_kernel_inputs(q, k, v, forward_only=True,
                                      dtypes=(torch.float32,))
        b, n, h, d = q.shape
        out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                n, h, d, *strides, 1.0 / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the previous flash_attn_fwd_f32 failed with "
                               f"CUDA error {rc}")
        return out
    return run


def rel_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over max |ref|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def _calls(q, k, v, previous=None) -> dict:
    calls = {"new": (lambda: attention.flash_attention_packed(q, k, v),
                     KERNEL)}
    if previous is not None:
        calls["previous"] = (lambda: previous(q, k, v), KERNEL)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    calls["sdpa"] = (lambda: F.scaled_dot_product_attention(qs, ks, vs), "")
    return calls


def rows(shapes=None, reps: int = 20, previous: str | None = None) -> dict:
    """One row per shape: {shape, ms, device_ms, library_ms,
    library_device_ms, bound_ms, bound_by, max_rel} (and previous_ms,
    previous_device_ms, previous_max_rel with `previous`, a directory of
    sources)."""
    prev = None if previous is None else previous_fwd(previous)
    out = {}
    for name, shape in (shapes or SHAPES).items():
        q, k, v = inputs(shape)
        with torch.no_grad():
            want = attention.attention_ref(q, k, v)
            err = {"max_rel": rel_error(
                attention.flash_attention_packed(q, k, v), want)}
            if prev is not None:
                err["previous_max_rel"] = rel_error(prev(q, k, v), want)
            del want
            t = in_turns(_calls(q, k, v, prev), reps)
        bound, bound_by = bound_ms(shape)
        out[name] = {"shape": shape, "ms": t["new"][0],
                     "device_ms": t["new"][1], "library_ms": t["sdpa"][0],
                     "library_device_ms": t["sdpa"][1], "bound_ms": bound,
                     "bound_by": bound_by, **err}
        if prev is not None:
            out[name].update(previous_ms=t["previous"][0],
                             previous_device_ms=t["previous"][1])
        del q, k, v
    return out


def describe(name: str, r: dict) -> str:
    """One printed line of a row."""
    old = (f"; previous {r['previous_ms']:.4f} / "
           f"{r['previous_device_ms']:.4f} ms (max|err| "
           f"{r['previous_max_rel']:.2e} of max|ref|)"
           if "previous_ms" in r else "")
    return (f"{name} {list(r['shape'])} f32: {r['ms']:.4f} ms events / "
            f"{r['device_ms']:.4f} ms device "
            f"({r['bound_ms'] / r['device_ms']:.1%} of the bound){old}; SDPA "
            f"f32 {r['library_ms']:.4f} / {r['library_device_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max|err| vs "
            f"plain {r['max_rel']:.2e} of max|ref|")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", action="append", choices=sorted(SHAPES),
                        help="a shape of SHAPES (repeatable; default all)")
    parser.add_argument("--repeats", type=int, default=0,
                        help="device times only, this many times a shape")
    parser.add_argument("--previous", metavar="DIR",
                        help="a directory holding an earlier "
                             "flash_attn_fwd.cu (and its headers) to time in "
                             "turns with the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}")
    shapes = {name: SHAPES[name] for name in args.shape or SHAPES}
    if args.repeats <= 0:
        for name, r in rows(shapes, previous=args.previous).items():
            print(describe(name, r), flush=True)
        return
    prev = None if args.previous is None else previous_fwd(args.previous)
    for name, shape in shapes.items():
        q, k, v = inputs(shape)
        with torch.no_grad():
            times = repeated(_calls(q, k, v, prev), args.repeats)
        for design, ts in times.items():
            print(f"{name} {list(shape)} {design}: device ms {spread(ts)}",
                  flush=True)


if __name__ == "__main__":
    main()
