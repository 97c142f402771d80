"""One rolling checkpoint and a final one (counterpart of
ovmono3d_tpu/train/checkpoint.py; the reference's
PeriodicCheckpointerOnlyOne): `model_recent.pt`, overwritten every period,
and `model_final.pt` at the end, each holding the whole TrainState (model,
optimizer buffers and count, step, loss_ema, skipped, sampling generator).
The recovery target of the training loop's restart."""
from __future__ import annotations

import os
from pathlib import Path

import torch


class SingleCheckpointer:
    def __init__(self, output_dir: str | Path):
        self.dir = Path(output_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.dir / f"{name}.pt"

    def save(self, state, name: str = "model_recent") -> None:
        """Write `state.state_dict()`; a reader never sees half a file."""
        path = self._path(name)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)

    def load(self, state, name: str = "model_recent"):
        """Load the checkpoint into `state` in place and return it, or None
        when there is none."""
        path = self._path(name)
        if not path.exists():
            return None
        state.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        return state

    def has(self, name: str = "model_recent") -> bool:
        return self._path(name).exists()
