"""Kernel 10 on the card: the W8A8 int8 product of csrc/int8_gemm.cu and
the activation's quantization in front of it, the port's counterpart of
tools/probe_int8_pallas.py.

    python -m ovmono3d_tpu_torch.probes.int8_gemm
    python -m ovmono3d_tpu_torch.probes.int8_gemm --repeats 5
    python -m ovmono3d_tpu_torch.probes.int8_gemm --previous DIR

At each of SHAPES (activations ~N(0, 1) bf16, weights ~N(0, 0.02^2),
quantized per row and per output channel, a bias ~N(0, 1)) it holds the
product to its plain version (the int32 accumulator equal to int8_mm_ref,
the bf16 dequantized product within one bf16 ulp of dequantize_ref) and the
quantization kernel to quantize_int8 (equal), then times in turns: the
product (with the weight's tensor map encoded once, as QDense does), the
quantization kernel, torch._int_mm alone, torch._int_mm with the same
epilogue in torch ops (the nearest PyTorch call of the same function) and
bf16 F.linear at the same shape (the product the int8 path replaces):
yardsticks the port never calls. Each is timed by CUDA events around one
call (the ctypes wrapper's host time included) and by the profiler's device
time (`probes.device_ms`; the yardsticks': every device op of the call).
Prints the bounds beside them: 2 R K M operations at the int8 tensor-core
peak against the bytes, and the quantization's bytes.

--previous DIR times, in the same turns, the dequantizing C entry of the
copy of int8_gemm.cu in DIR (an earlier design, for instance the parent
commit's `ovmono3d_tpu_torch/csrc` unpacked outside the tree, whose
int8_gemm_s8 takes (xq, wq, x_scale, w_scale, bias, out, R, M, K, mode,
stream)) and holds it to the same limit. --repeats R takes only the device
times, R times in one process, the call timed first rotating, and prints
each one's median and range.
"""
from __future__ import annotations

import argparse
import ctypes

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.ops import quant
from ovmono3d_tpu_torch.probes import (PEAK_BYTES, PEAK_INT8_OPS, card,
                                       in_turns, previous_library, repeated,
                                       spread, time_ms)

# (R, K, M): LIFT's four products (DINOv2 ViT-B/14 at 896^2, 4097 tokens),
# SAM ViT-H's fc1 (4096 tokens of a global block), Depth-Pro's patch qkv
# (35 crops of 577 tokens, ViT-L/16).
SHAPES = {"lift_qkv": (4097, 768, 2304), "lift_proj": (4097, 768, 768),
          "lift_fc1": (4097, 768, 3072), "lift_fc2": (4097, 3072, 768),
          "sam_h_fc1": (4096, 1280, 5120),
          "dp_patch_qkv": (20195, 1024, 3072)}
# Kernel names for the profiler's device time.
GEMM_KERNEL, QUANT_KERNEL, OLD_KERNEL = ("int8_gemm_sm90_kernel",
                                         "quantize_rows_kernel",
                                         "int8_gemm_kernel")


def operands(rows, depth, cols, seed: int = 0, device="cuda") -> dict:
    """The product's inputs as QDense makes them: x ~N(0, 1) bf16 and its
    quantization, w ~N(0, 0.02^2) quantized per output channel (its bf16
    copy for F.linear), a bias ~N(0, 1) f32."""
    g = torch.Generator(device=device).manual_seed(4000 + seed)
    x = torch.randn(rows, depth, device=device, generator=g).bfloat16()
    w = torch.randn(cols, depth, device=device, generator=g) * 0.02
    bias = torch.randn(cols, device=device, generator=g)
    xq, x_scale = quant.quantize_int8(x, -1)
    wq, w_scale = quant.quantize_int8(w, -1)
    return {"x": x, "xq": xq, "x_scale": x_scale, "wq": wq,
            "w_scale": w_scale.reshape(-1), "bias": bias,
            "w_bf16": w.bfloat16()}


def bound_ms(rows, depth, cols) -> tuple[float, str]:
    """The dequantizing product's bound: 2 R K M int8 operations; xq and wq
    (int8), the scales and the bias (f32) read once, the bf16 output
    written once."""
    ops = 2 * rows * depth * cols
    nbytes = (rows + cols) * depth + 4 * (rows + 2 * cols) + 2 * rows * cols
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def quant_bound_ms(rows, depth) -> float:
    """The quantization's bound: bf16 x read once, int8 xq and f32 x_scale
    written once."""
    return (3 * rows * depth + 4 * rows) / PEAK_BYTES * 1e3


def ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance of two bf16 tensors in units in the last
    place."""
    return int((got.view(torch.int16).int()
                - want.view(torch.int16).int()).abs().max())


def previous_gemm(csrc: str):
    """The dequantizing product of the earlier design in the directory
    `csrc`: fn(op) -> bf16 [R, M]."""
    fn = previous_library("int8_gemm.cu", csrc).int8_gemm_s8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(op: dict) -> torch.Tensor:
        xq, wq = op["xq"], op["wq"]
        out = torch.empty((xq.shape[0], wq.shape[0]), dtype=torch.bfloat16,
                          device=xq.device)
        rc = fn(xq.data_ptr(), wq.data_ptr(), op["x_scale"].data_ptr(),
                op["w_scale"].data_ptr(), op["bias"].data_ptr(),
                out.data_ptr(), xq.shape[0], wq.shape[0], xq.shape[1], 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the previous int8_gemm_s8 failed with CUDA "
                               f"error {rc}")
        return out

    return run


def check(op: dict, previous=None) -> dict:
    """The raw accumulator equal to int8_mm_ref (raw_equal), the bf16
    product's distance from dequantize_ref in ulps (ulps, max_abs_err), the
    quantization kernel equal to quantize_int8 (quant_equal), and the
    previous design's distance in ulps (previous_ulps)."""
    acc = quant.int8_mm_ref(op["xq"], op["wq"])
    want = quant.dequantize_ref(acc, op["x_scale"], op["w_scale"],
                                op["bias"], torch.bfloat16)
    got = quant.int8_gemm(op["xq"], op["wq"], op["x_scale"], op["w_scale"],
                          op["bias"])
    out = {"raw_equal": torch.equal(quant.int8_gemm(op["xq"], op["wq"]), acc),
           "ulps": ulps(got, want),
           "max_abs_err": (got.float() - want.float()).abs().max().item()}
    xq, x_scale = quant.quantize_rows(op["x"])
    out["quant_equal"] = (torch.equal(xq, op["xq"])
                          and torch.equal(x_scale, op["x_scale"]))
    if previous is not None:
        out["previous_ulps"] = ulps(previous(op), want)
    return out


def _calls(op: dict, previous=None) -> dict:
    """{name: (fn, kernel-name match)} of one shape's calls."""
    w_map = quant.weight_map(op["wq"])
    xq, wq, xs, ws, bias = (op[k] for k in ("xq", "wq", "x_scale", "w_scale",
                                            "bias"))
    wq_t, bias_b = wq.T, bias.bfloat16()
    calls = {"kernel": (lambda: quant.int8_gemm(xq, wq, xs, ws, bias,
                                                w_map=w_map), GEMM_KERNEL)}
    calls["quantize"] = (lambda: quant.quantize_rows(op["x"]), QUANT_KERNEL)
    if previous is not None:
        calls["previous"] = (lambda: previous(op), OLD_KERNEL)
    calls["int_mm"] = (lambda: torch._int_mm(xq, wq_t), "")
    calls["int_mm_epilogue"] = (lambda: quant.dequantize_ref(
        torch._int_mm(xq, wq_t), xs, ws, bias, torch.bfloat16), "")
    calls["bf16_linear"] = (lambda: F.linear(op["x"], op["w_bf16"], bias_b),
                            "")
    return calls


def rows(shapes=None, reps: int = 20, previous: str | None = None) -> dict:
    """{shape name: row}: ms and device_ms, quant_ms / quant_device_ms,
    quant_plain_ms (quantize_int8's torch ops) and quant_bound_ms, int_mm_ms
    / int_mm_device_ms, library_ms / library_device_ms (_int_mm + epilogue),
    bf16_linear_ms / bf16_linear_device_ms, bound_ms, bound_by, plain_ms,
    check's keys; with `previous` (a directory of sources) also previous_ms
    and previous_device_ms."""
    prev = None if previous is None else previous_gemm(previous)
    out = {}
    for i, name in enumerate(shapes or SHAPES):
        r, k, m = SHAPES[name]
        op = operands(r, k, m, seed=i)
        with torch.no_grad():
            row = check(op, prev)
            t = in_turns(_calls(op, prev), reps)
            row["plain_ms"] = time_ms(lambda: quant.dequantize_ref(
                quant.int8_mm_ref(op["xq"], op["wq"]), op["x_scale"],
                op["w_scale"], op["bias"], torch.bfloat16), 3)
            row["quant_plain_ms"] = time_ms(
                lambda: quant.quantize_int8(op["x"], -1))
        row["ms"], row["device_ms"] = t["kernel"]
        row["quant_ms"], row["quant_device_ms"] = t["quantize"]
        row["quant_bound_ms"] = quant_bound_ms(r, k)
        row["int_mm_ms"], row["int_mm_device_ms"] = t["int_mm"]
        row["library_ms"], row["library_device_ms"] = t["int_mm_epilogue"]
        row["bf16_linear_ms"], row["bf16_linear_device_ms"] = \
            t["bf16_linear"]
        if prev is not None:
            row["previous_ms"], row["previous_device_ms"] = t["previous"]
        row["bound_ms"], row["bound_by"] = bound_ms(r, k, m)
        out[name] = row
    return out


def describe(name: str, r: dict) -> str:
    """One printed line of a row."""
    rr, k, m = SHAPES[name]
    old = (f"; previous {r['previous_ms']:.4f} / "
           f"{r['previous_device_ms']:.4f} ms ({r['previous_ulps']} ulp)"
           if "previous_ms" in r else "")
    return (f"{name} [{rr}, {k}] x [{m}, {k}]: kernel {r['ms']:.4f} ms "
            f"events / {r['device_ms']:.4f} ms device "
            f"({r['bound_ms'] / r['device_ms']:.1%} of the bound){old}; "
            f"_int_mm alone "
            f"{r['int_mm_ms']:.4f} / {r['int_mm_device_ms']:.4f}, _int_mm + "
            f"epilogue {r['library_ms']:.4f} / {r['library_device_ms']:.4f}, "
            f"bf16 F.linear {r['bf16_linear_ms']:.4f} / "
            f"{r['bf16_linear_device_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; quantization "
            f"{r['quant_ms']:.4f} / {r['quant_device_ms']:.4f} ms (bound "
            f"{r['quant_bound_ms']:.4f}, plain {r['quant_plain_ms']:.4f}, "
            f"equal: {r['quant_equal']}); raw equal {r['raw_equal']}, "
            f"dequant {r['ulps']} ulp")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=0,
                        help="device times only, this many times")
    parser.add_argument("--previous", metavar="DIR",
                        help="a directory holding an earlier int8_gemm.cu "
                             "(and its headers) to time in turns with the "
                             "shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times kernels on the card: no CUDA device")
    print(f"card: {card()}", flush=True)
    if args.repeats <= 0:
        for name, r in rows(previous=args.previous).items():
            print(describe(name, r), flush=True)
        return
    prev = None if args.previous is None else previous_gemm(args.previous)
    for i, (name, (r, k, m)) in enumerate(SHAPES.items()):
        op = operands(r, k, m, seed=i)
        with torch.no_grad():
            times = repeated(_calls(op, prev), args.repeats)
        for call, ts in times.items():
            print(f"{name} {call}: device ms {spread(ts)}", flush=True)


if __name__ == "__main__":
    main()
