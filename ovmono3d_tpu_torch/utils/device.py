"""Where the port's entry points run: on the card unless asked for the CPU."""
from __future__ import annotations

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
