"""Per-stage wall time of a serving call, for the smoke run's breakdowns."""
from __future__ import annotations

import time

import torch


class Stages:
    """Per-stage wall time into trace["ms"] (synchronising the device at
    each mark) when a trace dict is given; nothing otherwise."""

    def __init__(self, trace: dict | None, device: torch.device):
        self.trace, self.device = trace, device
        if trace is not None:
            trace["ms"] = {}
            self._sync()
            self.t = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, stage: str, **tensors) -> None:
        if self.trace is None:
            return
        self._sync()
        now = time.perf_counter()
        self.trace["ms"][stage] = (now - self.t) * 1e3
        self.t = now
        self.trace.update(tensors)
