"""Dynamic int8 (W8A8) dense layers for serving: the plain PyTorch versions
and the Hopper kernel.

Counterpart of ovmono3d_tpu/ops/quant.py, the opt-in serving path of the ViT
trunks' qkv, proj, fc1 and fc2 products (`model.backbone.quant="int8"`):
weights quantized per output channel, activations per row (token), both
symmetric absmax to int8; the product accumulated in int32, rescaled in f32,
the bias added in f32, then cast to the compute dtype.

- `quantize_int8`: symmetric absmax quantization along one dim, the JAX
  package's `quantize_int8` (round half to even, clamp to [-127, 127]).
- `int8_mm_ref`: the plain int32 accumulator, computed in float64, which is
  exact here (|acc| <= 127^2 K, far below 2^53) and runs on the CPU and the
  card alike (CUDA has no int32 matmul).
- `dequantize_ref`: the epilogue in the JAX package's order, each step
  rounded on its own: float(acc) * (x_scale * w_scale), + bias, cast.
- `int8_matmul_ref`: the plain W8A8 product (`int8_matmul` of the JAX
  package), quantization included.
- `int8_gemm` (`csrc/int8_gemm.cu`, counted in `int8_gemm.launches`),
  replacing the TPU kernel `_int8_mm_kernel` of tools/probe_int8_pallas.py:
  the int32 accumulator, or with scales given the dequantized product,
  launched on the card or refused.
- `int8_matmul`: the dispatcher. CPU tensors go to `int8_matmul_ref`; CUDA
  tensors quantize the activation with torch ops, then run kernel 10's
  dequantizing instance. Nothing falls back.
- `QDense`: the port's `Dense` with `quant`. With quant="none" it is `Dense`,
  bit for bit; with "int8" it runs `int8_matmul` on a cached per-channel
  quantization of its weight, refreshed whenever the weight's storage or
  version changes (the JAX package quantizes on every call; the results are
  the same). The int8 path is SERVING-only: it raises when autograd would
  need it, as round() has no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ovmono3d_tpu_torch.models.layers import Dense

KERNEL_SOURCES = ["int8_gemm.cu"]
QUANT_MODES = ("none", "int8")
_OUT_MODES = {torch.bfloat16: 1, torch.float32: 2}    # csrc/int8_gemm.cu
_K_MULTIPLE = 32

SERVING_ONLY = (
    "quant='int8' is a SERVING-only option: the int8 round() has zero "
    "gradient, so training through it would silently stop updating the "
    "trunk. Train with quant='none' and enable int8 at inference, under "
    "torch.no_grad() / inference_mode()")


def quantize_int8(x: torch.Tensor, dim: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along `dim`: (q int8 in
    [-127, 127], scale f32 with `dim` kept), x ~= q * scale."""
    # max |x| in one pass (exact: the largest magnitude itself).
    absmax = torch.linalg.vector_norm(x, float("inf"), dim,
                                      keepdim=True).float()
    # The JAX package writes absmax / 127; XLA compiles a division by a
    # constant as the product with its f32 reciprocal, and so does this.
    scale = absmax.clamp(min=1e-12) * (1.0 / 127.0)
    q = (x / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def int8_mm_ref(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """sum_k xq[..., k] * wq[m, k] as int32 [..., M]: xq int8 [..., K], wq
    int8 [M, K]."""
    return (xq.double() @ wq.double().T).to(torch.int32)


def dequantize_ref(acc: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, bias: torch.Tensor | None,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """float(acc) * (x_scale * w_scale) (+ bias), cast to `out_dtype`:
    acc int32 [..., M], x_scale [..., 1], w_scale [M], bias [M] or None."""
    y = acc.float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                    bias: torch.Tensor | None,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain W8A8 product: x [..., K] quantized per row, times the
    quantized weight wq int8 [M, K] with per-channel scales w_scale [M], plus
    bias [M] -> [..., M] in `out_dtype`."""
    xq, x_scale = quantize_int8(x, -1)
    return dequantize_ref(int8_mm_ref(xq, wq), x_scale, w_scale, bias,
                          out_dtype)


@functools.cache
def _kernel():
    """The entry of the built kernel-10 library."""
    from ovmono3d_tpu_torch.utils import cuda_build

    fn = cuda_build.load(KERNEL_SOURCES)["int8_gemm.cu"].int8_gemm_s8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build_kernels() -> None:
    """Compile (or load) the kernel-10 library now rather than at the first
    launch."""
    _kernel()


def check_gemm_inputs(xq: torch.Tensor, wq: torch.Tensor,
                      x_scale: torch.Tensor | None = None,
                      w_scale: torch.Tensor | None = None,
                      bias: torch.Tensor | None = None,
                      out_dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise ValueError unless kernel 10 takes these inputs as they are. The
    device is checked last, so the other checks run on CPU tensors too."""
    for name, x in (("xq", xq), ("wq", wq)):
        if x.dtype != torch.int8 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int8 tensor; "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}'s pointer must be 16-byte aligned")
    (rows, depth), (cols, depth_w) = xq.shape, wq.shape
    if depth != depth_w:
        raise ValueError(f"xq is [R, {depth}], wq is [M, {depth_w}]: the "
                         "depths differ")
    if depth % _K_MULTIPLE or rows == 0 or cols == 0:
        raise ValueError(f"[{rows}, {depth}] x [{cols}, {depth}]: the kernel "
                         f"takes K a multiple of {_K_MULTIPLE} and no empty "
                         "operand")
    named = [("xq", xq), ("wq", wq)]
    if (x_scale is None) != (w_scale is None) or (
            bias is not None and x_scale is None):
        raise ValueError("give both scales (the dequantized product) or "
                         "neither (the int32 accumulator, without bias)")
    if x_scale is not None:
        if out_dtype not in _OUT_MODES:
            raise ValueError(f"out_dtype {out_dtype}; the kernel writes "
                             "bfloat16 or float32")
        for name, x, n in (("x_scale", x_scale, rows),
                           ("w_scale", w_scale, cols), ("bias", bias, cols)):
            if x is None:
                continue
            if (x.dtype != torch.float32 or x.numel() != n
                    or not x.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous f32 tensor of "
                                 f"{n} elements; got {x.dtype} "
                                 f"{tuple(x.shape)}")
            named.append((name, x))
    if torch.is_grad_enabled() and any(x.requires_grad for _, x in named):
        raise ValueError(SERVING_ONLY)
    for name, x in named:
        if x.device.type != "cuda" or x.device != xq.device:
            raise ValueError(f"{name} is on {x.device}; the kernel needs all "
                             "its tensors on one CUDA device")


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor,
              x_scale: torch.Tensor | None = None,
              w_scale: torch.Tensor | None = None,
              bias: torch.Tensor | None = None,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch the CUDA int8 product (kernel 10).

    xq: contiguous int8 [R, K]; wq: contiguous int8 [M, K]; K a multiple of
    32. Without scales, returns the int32 accumulator [R, M]. With x_scale
    (R elements) and w_scale (M elements), f32, and an optional f32 bias [M],
    returns the dequantized product [R, M] in `out_dtype` (bf16 or f32),
    bit for bit `dequantize_ref`'s. Counts each launch in
    `int8_gemm.launches`."""
    check_gemm_inputs(xq, wq, x_scale, w_scale, bias, out_dtype)
    rows, cols, depth = xq.shape[0], wq.shape[0], xq.shape[1]
    raw = x_scale is None
    out = torch.empty((rows, cols), device=xq.device,
                      dtype=torch.int32 if raw else out_dtype)
    fn = _kernel()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = fn(xq.data_ptr(), wq.data_ptr(),
                None if raw else x_scale.data_ptr(),
                None if raw else w_scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                rows, cols, depth, 0 if raw else _OUT_MODES[out_dtype],
                stream)
    if rc != 0:
        raise RuntimeError(
            f"int8_gemm_s8 launch failed with CUDA error {rc} (R={rows}, "
            f"M={cols}, K={depth}, out={out.dtype})")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ W^T + bias through int8 with dynamic per-row scales: x
    [..., K], wq int8 [M, K] with w_scale [M] -> [..., M] in `out_dtype`."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, wq, w_scale, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 product for device {x.device}")
    lead, depth = x.shape[:-1], x.shape[-1]
    xq, x_scale = quantize_int8(x.reshape(-1, depth), -1)
    return int8_gemm(xq, wq, x_scale, w_scale, bias, out_dtype).view(
        *lead, wq.shape[0])


def refuse_quantized(model: torch.nn.Module) -> None:
    """Raise ValueError (SERVING-only) when any product of `model` runs in
    int8: the training entry points call it."""
    if any(isinstance(m, QDense) and m.quant != "none"
           for m in model.modules()):
        raise ValueError(SERVING_ONLY)


class QDense(Dense):
    """`Dense` with the opt-in int8 serving path (flax QDense): the same
    parameters, names and shapes, so checkpoints and the bridge do not
    change."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.bfloat16, bias: bool = True, device=None,
                 quant: str = "none"):
        if quant not in QUANT_MODES:
            raise ValueError(f"quant={quant!r}; the port takes {QUANT_MODES}")
        super().__init__(in_features, out_features, dtype, bias, device)
        self.quant = quant
        self._quantized = None   # (key, wq [M, K] int8, w_scale [M] f32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "none":
            return super().forward(x)
        if torch.is_grad_enabled() and (
                x.requires_grad
                or any(p.requires_grad for p in self.parameters())):
            raise RuntimeError(SERVING_ONLY)
        wq, w_scale = self.quantized_weight()
        return int8_matmul(x, wq, w_scale, self.bias, self.dtype)

    def quantized_weight(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(wq [M, K] int8, w_scale [M] f32): the weight quantized per output
        channel, made again when the weight's storage, place or version
        changed (a bridge load, an in-place edit, a move)."""
        w = self.weight
        key = (w.data_ptr(), w.device, w.dtype, tuple(w.shape),
               None if w.is_inference() else w._version)
        if self._quantized is None or self._quantized[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                wq, w_scale = quantize_int8(w.detach(), -1)
            self._quantized = (key, wq, w_scale.reshape(-1))
        return self._quantized[1], self._quantized[2]
