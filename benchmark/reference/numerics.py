"""The precision of the reference's products.

`Ops("f32")` computes every product in float32 (TF32 must be off: the
harness turns it off before the reference runs). `Ops("fp8")` is the
control: what the configuration computes and keeps in bfloat16 is rounded
to float8 e4m3 with one scale a tensor (amax / 448), the next precision
below bfloat16: the inputs and outputs of the trunk's products and of the
feature pyramid's convolutions, the attention's probabilities and output,
the residual stream, and the maps ROIAlign reads where the configuration
pools in bfloat16; the heads stay float32. A sound program
must read far closer to `Ops("f32")` than the control does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in f32."""
    scale = (x.detach().abs().amax() / E4M3_MAX).clamp(min=1e-30)
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # Straight-through: the rounding is the forward's; gradients pass.
    return x + (q - x).detach()


class Ops:
    """Products of the reference. `low=True` marks a linear map or
    convolution that the configuration states in bfloat16, inputs and
    output; of an einsum, its inputs (an attention's logits stay float32
    in the kernels)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision mode {mode!r}")
        self.mode = mode

    def _in(self, x: torch.Tensor, low: bool) -> torch.Tensor:
        x = x.float()
        return round_fp8(x) if (low and self.mode == "fp8") else x

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation that the configuration keeps in bfloat16."""
        return round_fp8(x.float()) if self.mode == "fp8" else x

    def _out(self, y: torch.Tensor, low: bool) -> torch.Tensor:
        return self.store(y) if low else y

    def linear(self, x, w, b=None, low=False):
        return self._out(F.linear(self._in(x, low), self._in(w, low),
                                  None if b is None else b.float()), low)

    def conv(self, x, w, b=None, stride=1, padding=0, low=False):
        return self._out(F.conv2d(self._in(x, low), self._in(w, low),
                                  None if b is None else b.float(), stride,
                                  padding), low)

    def conv_t(self, x, w, b=None, low=False):
        return self._out(F.conv_transpose2d(
            self._in(x, low), self._in(w, low),
            None if b is None else b.float(), stride=2), low)

    def einsum(self, eq, a, b, low=False):
        return torch.einsum(eq, self._in(a, low), self._in(b, low))
