"""Processes of a data-parallel run over torch.distributed (counterpart of
ovmono3d_tpu/parallel/mesh.py).

The reference's only parallelism is NCCL data parallelism (detectron2's
`launch`); the JAX package runs one program over a device mesh. Here each
process drives one device and holds a share of the batch: the train step
sums gradients and losses over the process group (parallel/train_step.py),
evaluation shards its records (`process_shard`) and gathers what each
process predicted (`gather_objects`). The JAX package's Megatron tensor
parallelism (sharding_rules.py) has no counterpart: the reference has none.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device: str | torch.device = "cuda",
                   timeout_s: float = 300.0) -> bool:
    """Join the process group of a data-parallel run: NCCL when the
    processes drive CUDA devices, gloo on the CPU. Returns whether a group
    is up.

    With `coordinator` ("host:port" or a URL such as tcp://host:port),
    `num_processes` and `process_id` must be given; a failure raises. It
    must never be swallowed: N processes that each went on alone would be N
    independent jobs (every one evaluating and saving the whole run, no
    gradient shared), the JAX package's note on jax.distributed. Without a
    coordinator it joins through the environment `torchrun` sets
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) when all four are there,
    and otherwise does nothing and returns False: one process. A group
    that is already up is kept."""
    if dist.is_initialized():
        return True
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
        return True
    if all(v in os.environ for v in ENV_VARS):
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return True
    return False


def world_size() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_shard(records: list) -> list:
    """This process's disjoint slice of a record list, records[rank::world]
    (InferenceSampler semantics across processes; the train iterator
    offsets its seed by the rank instead)."""
    return records[rank()::world_size()]


def gather_objects(items: list) -> list:
    """Every process's list, concatenated in rank order and the same on
    every process (all_gather_object: the reference gathers its per-rank
    evaluation JSON with comm.gather). The identity with one process."""
    if world_size() == 1:
        return list(items)
    parts: list = [None] * world_size()
    dist.all_gather_object(parts, list(items))
    return [x for part in parts for x in part]
