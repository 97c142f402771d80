"""One rolling checkpoint and a final one (counterpart of
ovmono3d_tpu/train/checkpoint.py; the reference's
PeriodicCheckpointerOnlyOne): `model_recent.pt`, overwritten every period,
and `model_final.pt` at the end, each holding the whole TrainState (model,
optimizer buffers and count, step, loss_ema, skipped, sampling generator).
The recovery target of the training loop's restart. In a data-parallel run
every process reads the checkpoints and one writes them (`writer`); each
process draws its own sampling uniforms, so every process's generator is
gathered into the file ("rank_generators") and each takes its own back."""
from __future__ import annotations

import logging
import os
from pathlib import Path

import torch

from ovmono3d_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)


class SingleCheckpointer:
    def __init__(self, output_dir: str | Path, writer: bool = True):
        self.dir = Path(output_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.writer = writer

    def _path(self, name: str) -> Path:
        return self.dir / f"{name}.pt"

    def save(self, state, name: str = "model_recent") -> None:
        """Write `state.state_dict()` (nothing when not the writer); a
        reader never sees half a file. Under a process group every process
        calls it: their generators are gathered."""
        gens = (mesh.gather_objects([state.generator.get_state()])
                if mesh.world_size() > 1 else None)
        if not self.writer:
            return
        sd = state.state_dict()
        if gens is not None:
            sd["rank_generators"] = gens
        path = self._path(name)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(sd, tmp)
        os.replace(tmp, path)

    def load(self, state, name: str = "model_recent"):
        """Load the checkpoint into `state` in place and return it, or None
        when there is none. Each process of a group takes its own
        generator; one that the file has none for (the group grew) reseeds
        from rank 0's, offset by its rank and the step."""
        path = self._path(name)
        if not path.exists():
            return None
        sd = torch.load(path, map_location="cpu", weights_only=True)
        state.load_state_dict(sd)
        rank, gens = mesh.rank(), sd.get("rank_generators")
        if gens is not None and rank < len(gens):
            state.generator.set_state(gens[rank])
        elif rank > 0:
            logger.warning("%s holds no sampling generator for rank %d: "
                           "it draws from a new seed", path, rank)
            state.generator.manual_seed(state.generator.initial_seed()
                                        + rank + 1_000_003 * int(state.step))
        return state

    def has(self, name: str = "model_recent") -> bool:
        return self._path(name).exists()
