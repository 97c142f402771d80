"""One training step over data x model processes (counterpart of
__graft_entry__.py's dryrun_multichip): the batch split over the data axis,
the ViT trunk's and the box head's layers split Megatron-style over the
model axis (parallel/tensor_parallel.py), so the data group's gradient sums
and the model groups' collectives all run.

    python -m ovmono3d_tpu_torch.parallel.dryrun [--device cuda] [--data 2]
        [--model 2] [--config-file C.yaml] [KEY=VALUE ...]

It starts data * model processes joined over a localhost port: on the
cards (the default) one card each, process r on cuda:r, joined by NCCL;
with `--device cpu` on the CPU, one thread each, joined by gloo. It prints
rank 0's loss. Without `--config-file` the model is the JAX dry run's tiny
configuration; the overrides apply after either. The trunk is frozen where
the configuration freezes it (the JAX dry run's trainable mask), so its
sharded layers run forward only; `model.backbone.freeze=false` trains them
too. For example, the flagship across four cards:

    python -m ovmono3d_tpu_torch.parallel.dryrun --data 1 --model 4 \
        --config-file configs/OVMono3D_dinov2_SFP.yaml \
        model.backbone.freeze=false

Exits non-zero when a process fails, the loss is not finite or the
processes disagree on it.
"""
from __future__ import annotations

import argparse
import math
import multiprocessing
import queue
import socket
import time

import numpy as np
import torch

# The JAX dry run's tiny configuration (__graft_entry__._flagship_config
# with tiny=True, square_pad=112).
TINY = [
    "model.backbone.embed_dim=64", "model.backbone.depth=2",
    "model.backbone.num_heads=2", "model.backbone.pretrain_grid=8",
    "model.backbone.out_channels=64", "model.backbone.square_pad=112",
    "model.roi_box.fc_dim=64", "model.roi_box.batch_size_per_image=32",
    "model.rpn.pre_nms_topk_train=128", "model.rpn.post_nms_topk_train=128",
    "model.rpn.pre_nms_topk_test=128", "model.rpn.post_nms_topk_test=64",
    "model.rpn.batch_size_per_image=64", "model.cube.fc_dim=64",
    "model.num_classes=9", "model.max_detections=16",
]
TIMEOUT_S = 300


def dryrun_batch(b: int, s: int = 112) -> dict:
    """The JAX dry run's batch of b images: two GT boxes each, two empty
    slots."""
    rng = np.random.RandomState(0)
    gt_boxes3d = np.array([[[34, 34, 2.0, 0.5, 0.4, 0.6, 0, 0, 2.0],
                            [60, 65, 3.0, 1.0, 0.8, 1.2, 0.1, 0.1, 3.0],
                            [0, 0, 1, 1, 1, 1, 0, 0, 1],
                            [0, 0, 1, 1, 1, 1, 0, 0, 1]]], np.float32)
    batch = {
        "image": rng.rand(b, s, s, 3).astype(np.float32) * 255,
        "K": np.tile(np.array([[200.0, 0, s / 2], [0, 200.0, s / 2],
                               [0, 0, 1]], np.float32), (b, 1, 1)),
        "im_hw": np.full((b, 2), s, np.int32),
        "im_scale_ratio": np.ones((b,), np.float32),
        "gt_boxes": np.tile(np.array([[[8, 8, 60, 60], [30, 30, 90, 100],
                                       [0, 0, 0, 0], [0, 0, 0, 0]]],
                                     np.float32), (b, 1, 1)),
        "gt_classes": np.tile(np.array([[0, 2, 0, 0]], np.int32), (b, 1)),
        "gt_boxes3d": np.tile(gt_boxes3d, (b, 1, 1)),
        "gt_poses": np.tile(np.eye(3, dtype=np.float32), (b, 4, 1, 1)),
        "gt_valid": np.tile(np.array([[True, True, False, False]]), (b, 1)),
    }
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def step_once(n_data: int, n_model: int, device: torch.device,
              config_file: str | None = None,
              opts: tuple[str, ...] = ()) -> dict:
    """In a process of a running group: build the model (seed 0) on
    `device`, shard it, and take one train step on this data rank's image.
    Returns the metrics as floats."""
    from ovmono3d_tpu_torch.config import load_config
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from ovmono3d_tpu_torch.parallel.mesh import make_groups
    from ovmono3d_tpu_torch.parallel.tensor_parallel import apply_tp
    from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                        make_train_step)
    from ovmono3d_tpu_torch.train.optim import Optimizer

    groups = make_groups(n_data, n_model)
    overrides = [*([] if config_file else TINY), *opts]
    cfg = load_config(config_file, overrides=overrides)
    model = build_model(cfg.model, device=device, seed=0)
    apply_tp(model, groups.model)
    opt = Optimizer(cfg.solver, model)
    # The processes of a model group draw the same samples.
    state = create_train_state(model, opt, seed=1 + groups.data_rank)
    step = make_train_step(model, opt, cfg.model.stabilize, groups)
    batch = dryrun_batch(n_data, cfg.model.backbone.square_pad)
    share = slice(groups.data_rank, groups.data_rank + 1)
    _, metrics = step(state, {k: v[share].to(device)
                              for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}


def _worker(rank: int, world: int, n_data: int, n_model: int, port: int,
            device_type: str, config_file: str | None, opts: tuple,
            out: multiprocessing.Queue) -> None:
    from ovmono3d_tpu_torch.parallel.mesh import init_multihost

    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    init_multihost(f"localhost:{port}", world, rank, device=device,
                   timeout_s=TIMEOUT_S)
    try:
        out.put((rank, step_once(n_data, n_model, device, config_file,
                                 opts)))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun(n_data: int = 2, n_model: int = 2, device: str = "cuda",
           config_file: str | None = None, opts: tuple = ()) -> dict:
    """Run the step over n_data * n_model spawned processes, one card each
    on "cuda" (raises when there are fewer cards), on the CPU with "cpu";
    returns rank 0's metrics. Raises when a process fails or times out,
    when the loss is not finite, or when the processes' losses differ."""
    world = n_data * n_model
    device_type = torch.device(device).type
    if device_type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world:
            raise RuntimeError(
                f"{world} processes need {world} cards, and {cards} are "
                "here (the CPU runs with --device cpu)")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, n_data, n_model, port, device_type,
                               config_file, tuple(opts), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while len(results) < world and time.monotonic() < deadline:
            try:
                r, metrics = out.get(timeout=1.0)
                results[r] = metrics
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed or len(results) < world:
        raise RuntimeError(f"dry-run processes {failed} failed; "
                           f"{len(results)} of {world} reported")
    losses = {r: m["total_loss"] for r, m in results.items()}
    if not math.isfinite(losses[0]):
        raise RuntimeError(f"non-finite loss {losses[0]}")
    if len(set(losses.values())) != 1:
        raise RuntimeError(f"the processes disagree on the loss: {losses}")
    return results[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="one card a process over NCCL (default), or the "
                         "CPU over gloo")
    ap.add_argument("--config-file", default=None,
                    help="a configs/*.yaml (default: the tiny dry-run "
                         "configuration)")
    ap.add_argument("opts", nargs="*", metavar="KEY=VALUE",
                    help="config overrides")
    args = ap.parse_args(argv)
    m = dryrun(args.data, args.model, args.device, args.config_file,
               tuple(args.opts))
    print(f"dryrun ok: {args.data * args.model} processes (data={args.data} "
          f"x model={args.model}) on {args.device}, 1 step, "
          f"loss={m['total_loss']:.6f}, skipped={int(m['skipped'])}",
          flush=True)
    return m


if __name__ == "__main__":
    main()
