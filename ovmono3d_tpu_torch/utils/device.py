"""Where the port's entry points run (on the card unless asked for the CPU),
how f32 runs there (no TF32), and small constants kept there."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when it is None; a CUDA device without an index
    gets the current one, so it compares equal to its tensors' devices.
    Raises RuntimeError when CUDA is asked for (or defaulted to) and there
    is no card: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "asks for the CPU (device='cpu')")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def disable_tf32(device: torch.device) -> None:
    """On a CUDA `device`, turn TF32 off for cuBLAS matmuls and cuDNN
    convolutions (`torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32`; cuDNN defaults to TF32), so f32
    products and convolutions keep f32's mantissa, as the JAX package
    computes them. The flags are process-wide: every entry point that places
    a model on the card calls this."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@functools.cache
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values: tuple, device, dtype=torch.float32
                    ) -> torch.Tensor:
    """A small constant tensor made once per (values, dtype, device) and
    reused. Uploading it in every forward would make the host wait for the
    card: a copy from pageable host memory synchronises the stream. Made
    outside inference mode, so autograd may save it; never modify it."""
    return _constant(values, dtype, torch.device(device))
