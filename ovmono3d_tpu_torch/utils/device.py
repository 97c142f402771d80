"""Where the port's entry points run (on the card unless asked for the CPU),
how f32 runs there (no TF32), small constants kept there, and copies between
the host and the card that do not make the host wait (the streams')."""
from __future__ import annotations

import functools

import numpy as np
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


def staged(array) -> torch.Tensor:
    """A host array (numpy or tensor) as a CPU tensor the card can copy from
    without making the host wait: page-locked when there is a card, as it is
    otherwise. PyTorch's pinned allocator keeps the buffer until every copy
    from it has run."""
    host = torch.as_tensor(np.ascontiguousarray(array))
    return host.pin_memory() if torch.cuda.is_available() else host


def to_device_async(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`host` on `device`, copied without a host synchronisation when it is
    page-locked (`staged`) and the device is a card."""
    return host.to(device, non_blocking=host.is_pinned())


class HostCopy:
    """Device tensors gathered into host memory without waiting for them:
    `parts` (dicts of tensors with the same keys, each on one device, their
    first axes in order) are copied into page-locked buffers behind an event
    recorded on each card. `wait()` waits for the events and returns
    {key: the parts concatenated on the first axis}."""

    def __init__(self, parts: list[dict[str, torch.Tensor]]):
        keys = list(parts[0])
        n = sum(p[keys[0]].shape[0] for p in parts)
        self.events = []
        self.host = {}
        on_card = any(p[keys[0]].is_cuda for p in parts)
        for k in keys:
            like = parts[0][k]
            self.host[k] = torch.empty((n, *like.shape[1:]), dtype=like.dtype,
                                       pin_memory=on_card)
        start = 0
        for p in parts:
            stop = start + p[keys[0]].shape[0]
            for k in keys:
                self.host[k][start:stop].copy_(p[k], non_blocking=on_card)
            if p[keys[0]].is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(p[keys[0]].device))
                self.events.append(event)
            start = stop

    def wait(self) -> dict[str, torch.Tensor]:
        for event in self.events:
            event.synchronize()
        return self.host
