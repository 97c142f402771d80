"""Processes of a parallel run over torch.distributed (counterpart of
ovmono3d_tpu/parallel/mesh.py).

The reference's only parallelism is NCCL data parallelism (detectron2's
`launch`); the JAX package runs one program over a device mesh of data x
model devices. Here each process drives one device and holds a share of the
batch: the train step sums gradients and losses over the data group
(parallel/train_step.py), evaluation shards its records (`process_shard`)
and gathers what each process predicted (`gather_objects`). With a model
axis (`make_groups`), the processes of one model group hold the same share
of the batch and split the trunk's and the box head's layers between them
(parallel/tensor_parallel.py, the JAX package's sharding_rules.py).
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

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


@dataclass(frozen=True)
class Groups:
    """This process's place on the data x model mesh: its data group (the
    processes holding the same layer shards, each its own share of the
    batch) and its model group (the processes splitting the layers, on the
    same share). Ranks are laid out as the JAX mesh's devices, rank =
    data_rank * n_model + model_rank."""

    n_data: int
    n_model: int
    data: object           # torch.distributed ProcessGroup
    model: object
    data_rank: int
    model_rank: int


def make_groups(n_data: int, n_model: int) -> Groups:
    """The data and model subgroups of the running process group (every
    process must call this, in the same order as its other new_group
    calls). Raises unless n_data * n_model is the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("make_groups needs a process group "
                           "(init_multihost)")
    if n_data * n_model != world_size():
        raise ValueError(f"data {n_data} x model {n_model} != "
                         f"{world_size()} processes")
    me = rank()
    data_rank, model_rank = divmod(me, n_model)
    data = model = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == data_rank:
            model = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == model_rank:
            data = g
    return Groups(n_data, n_model, data, model, data_rank, model_rank)
