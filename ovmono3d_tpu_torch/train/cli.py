"""Training of OVMono3D-LIFT (counterpart of tools/train_net.py).

    python -m ovmono3d_tpu_torch.train.cli --config-file \
        configs/OVMono3D_dinov2_SFP.yaml [--resume] [key=value ...]
    python -m ovmono3d_tpu_torch.train.cli --synthetic --device cpu \
        --max-iter 2 --batch-size 8 [key=value ...]
    torchrun --nproc_per_node N -m ovmono3d_tpu_torch.train.cli ...

Registers the configured Omni3D training datasets under
`datasets.data_root` (or, with `--synthetic`, 256 generated records), writes
the category priors to output_dir/priors.npz (the model's prior decodes
read them; the evaluation CLI finds them beside a checkpoint), builds the
model from `seed` (the trunk frozen when `model.backbone.freeze`), the
optimizer (accumulating `solver.grad_accum_steps` micro-steps an update)
and the weighted train iterator, and runs the loop with its stabilisation
restarts (train/loop.py; a restart rebuilds the iterator with seed + 1000
x attempt). `--trunk-ckpt` loads the trunk's released torch checkpoint
after the seeded build, for every backbone (`utils/cnn_convert.py`
`load_cnn_trunk`: a torch.hub DINOv2, open_clip, HF ViTMAE, MiDaS
DPT_Large or segment-anything trunk, or a DLA model-zoo / torchvision CNN
with its BatchNorm statistics; dinov2's depth-fusion conv keeps its init).
Batches are uploaded from page-locked memory without making the host
wait. Hooks: metrics.jsonl and the console line, TensorBoard events
under tb/ (`--tensorboard`, on by default), the training panels every
`vis_period` steps under vis/, and with `--profile` a torch.profiler trace
of steps 11-15 under profile/. Every `test.eval_period` steps the model is
evaluated with the oracle-2D protocol on a held-out set (the first test
dataset's first 64 images; 16 generated ones with `--synthetic`; else a
copy of 64 training records, an optimistic figure), through the
evaluation CLI's `evaluate_dataset` and one inference function built once.
`--eval-only` hands the run to the evaluation CLI.

Data parallelism: under torchrun (or any launcher that sets MASTER_ADDR,
MASTER_PORT, RANK and WORLD_SIZE) each process joins the group (NCCL on the
card, gloo on the CPU), drives the card of its LOCAL_RANK and takes
batch / world images of each step, the batch rounded down to a multiple of
the world size; the train step sums gradients and losses over the group
(parallel/train_step.py). Each process's iterator seed and sampling
generator are offset by its rank; a checkpoint keeps every process's
generator, so each resumes with its own. Rank 0 alone writes checkpoints,
metrics, TensorBoard and panels.

Runs on CUDA unless `--device` names another device; without a card and
without `--device` it raises.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import os
from pathlib import Path

import numpy as np
import torch

from ovmono3d_tpu_torch.config import load_config
from ovmono3d_tpu_torch.data.build import (build_train_iterator,
                                           default_image_loader)
from ovmono3d_tpu_torch.data.datasets import (attach_depth_files,
                                              filter_settings_from_cfg,
                                              get_dataset, simple_register)
from ovmono3d_tpu_torch.data.synthetic import synthetic_records
from ovmono3d_tpu_torch.eval import cli as eval_cli
from ovmono3d_tpu_torch.evaluation.helper import Omni3DEvaluationHelper
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.ops.quant import SERVING_ONLY
from ovmono3d_tpu_torch.parallel import mesh
from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
from ovmono3d_tpu_torch.train.checkpoint import SingleCheckpointer
from ovmono3d_tpu_torch.train.loop import train
from ovmono3d_tpu_torch.train.metrics import (MetricsWriter, ProfilerHook,
                                              TrainVisHook)
from ovmono3d_tpu_torch.train.optim import Optimizer, with_grad_accum
from ovmono3d_tpu_torch.utils.cnn_convert import load_cnn_trunk
from ovmono3d_tpu_torch.utils.device import (resolve_device, staged,
                                             to_device_async)
from ovmono3d_tpu_torch.utils.priors import compute_priors

logger = logging.getLogger("ovmono3d")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training and run the evaluation CLI with "
                         "the same config and opts")
    ap.add_argument("--resume", action="store_true",
                    help="resume from output_dir/model_recent.pt if present")
    ap.add_argument("--checkpoint", default=None,
                    help="with --eval-only: the checkpoint to evaluate")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on 256 generated records")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="images a step over all processes (default "
                         "solver.ims_per_batch)")
    ap.add_argument("--tensorboard", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--trunk-ckpt", default=None,
                    help="the trunk's released torch checkpoint for "
                         "model.backbone.name (torch.hub DINOv2, open_clip, "
                         "HF ViTMAE, MiDaS, segment-anything, a DLA model-zoo "
                         "or torchvision CNN) loaded before training")
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler trace of steps 11-15")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (e.g. cpu)")
    ap.add_argument("opts", nargs="*", default=[])
    return ap.parse_args(argv)


def eval_only_argv(args: argparse.Namespace) -> list[str]:
    """The evaluation CLI's arguments for an --eval-only run."""
    argv = []
    if args.config_file:
        argv += ["--config-file", args.config_file]
    if args.synthetic:
        argv += ["--synthetic"]
    if args.checkpoint:
        argv += ["--checkpoint", args.checkpoint]
    if args.batch_size:
        argv += ["--batch-size", str(args.batch_size)]
    if args.device:
        argv += ["--device", args.device]
    return argv + list(args.opts)


def training_records(cfg, synthetic: bool):
    """(records, image loader, filter settings, category map)."""
    if synthetic:
        return synthetic_records(256, cfg.model.num_classes), None, None, None
    fs = filter_settings_from_cfg(cfg)
    cat_map = {n: i for i, n in enumerate(cfg.datasets.category_names)}
    records = []
    for name in cfg.datasets.train:
        json_path = Path(cfg.datasets.data_root) / "Omni3D" / f"{name}.json"
        simple_register(name, json_path, fs, cat_map)
        records.extend(get_dataset(name))
    if cfg.datasets.depth_dir and cfg.model.backbone.use_depth_fusion:
        attach_depth_files(records, cfg.datasets.depth_dir)
    return (records, default_image_loader(cfg.datasets.data_root), fs,
            cat_map)


def eval_records(cfg, records, synthetic: bool, fs, cat_map) -> list[dict]:
    """The in-train evaluation set with the GT as its oracle 2D boxes."""
    if synthetic:
        held = synthetic_records(16, cfg.model.num_classes, seed=99)
    else:
        held = []
        for name in cfg.datasets.test[:1]:
            json_path = (Path(cfg.datasets.data_root) / "Omni3D"
                         / f"{name}.json")
            if json_path.exists():
                simple_register(name, json_path, fs, cat_map)
                held = get_dataset(name)[:64]
        if not held:
            logger.warning(
                "test.eval_period is set but no test dataset is available; "
                "in-train eval uses 64 TRAINING records (optimistic smoke "
                "metric)")
            held = copy.deepcopy(records[:64])
    for rec in held:
        rec["oracle2d"] = [
            {"bbox2d": a["bbox2d"], "category_id": a["category_id"],
             "score": 1.0}
            for a in rec["annotations"] if a["category_id"] >= 0]
    return held


@dataclasses.dataclass
class TrainRun:
    """A run set up by `build_run`: `train()` runs the loop, and callers
    that time the step (chip_smoke.py) drive `step_fn` on batches of
    `make_data_iter()` themselves."""

    cfg: object
    state: object
    step_fn: object
    make_data_iter: object
    checkpointer: SingleCheckpointer
    hooks: list
    eval_fn: object
    evals: list
    streams: list
    batch_size: int
    world: int

    def train(self) -> dict:
        """The loop to cfg.solver.max_iter; then every data stream is
        closed. Returns {"step", "skipped", "batch_size", "world_size",
        "evals": [the in-train evaluations' summaries]}."""
        try:
            self.state = train(self.cfg, self.state, self.step_fn,
                               self.make_data_iter(),
                               checkpointer=self.checkpointer,
                               hooks=self.hooks, eval_fn=self.eval_fn,
                               data_iter_factory=self.make_data_iter)
        finally:
            self.close()
        step, skipped = int(self.state.step), int(self.state.skipped)
        logger.info("done at step %d (skipped %d)", step, skipped)
        return {"step": step, "skipped": skipped,
                "batch_size": self.batch_size, "world_size": self.world,
                "evals": self.evals}

    def close(self) -> None:
        """Stop the data streams' producer threads."""
        for data in self.streams:
            data.close()


def build_run(args: argparse.Namespace) -> TrainRun:
    """Everything a training run needs, from parsed arguments: the process
    group when a launcher describes one, the records, priors.npz, the
    model, optimizer and train step, a resumed state, the data streams,
    the hooks and the in-train evaluation."""
    cfg = load_config(args.config_file, overrides=args.opts)
    if cfg.model.backbone.quant != "none":
        raise SystemExit(SERVING_ONLY)
    device = resolve_device(args.device)
    if mesh.init_multihost(device=device) and device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   mesh.rank() % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    rank, world = mesh.rank(), mesh.world_size()
    lead = rank == 0

    records, image_loader, fs, cat_map = training_records(cfg,
                                                          args.synthetic)
    logger.info("train records: %d", len(records))
    cube = cfg.model.cube
    priors = compute_priors(
        records, cfg.model.num_classes, cube.cluster_bins,
        virtual_depth=cube.virtual_depth, virtual_focal=cube.virtual_focal,
        test_min=cfg.input.min_size_test, test_max=cfg.input.max_size_test,
        anchor_min=cfg.model.anchors.sizes[0][0],
        anchor_max=cfg.model.anchors.sizes[-1][-1])
    out_dir = Path(cfg.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if lead:
        np.savez(out_dir / "priors.npz", **priors)

    model = build_model(cfg.model, priors={
        k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
        for k, v in priors.items()}, device=device, seed=cfg.seed)
    if args.trunk_ckpt:
        load_cnn_trunk(model, args.trunk_ckpt, cfg.model.backbone.name)
        logger.info("loaded trunk weights from %s", args.trunk_ckpt)
    opt = with_grad_accum(Optimizer(cfg.solver, model),
                          cfg.solver.grad_accum_steps)
    state = create_train_state(model, opt, seed=cfg.seed + 1 + rank)
    step_fn = make_train_step(model, opt, cfg.model.stabilize)
    ckpt = SingleCheckpointer(cfg.output_dir, writer=lead)
    if args.resume and ckpt.has():
        state = ckpt.load(state)
        logger.info("resumed from %s/model_recent.pt at step %d",
                    cfg.output_dir, int(state.step))

    batch_size = args.batch_size or cfg.solver.ims_per_batch
    rounded = max(batch_size // world, 1) * world
    if rounded != batch_size:
        logger.warning("batch size %d adjusted to %d (a multiple of the %d "
                       "processes)", batch_size, rounded, world)
    per_rank = rounded // world
    max_iter = args.max_iter or cfg.solver.max_iter
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, max_iter=max_iter))

    streams = []

    def make_data_iter(attempt: int = 0):
        """A fresh stream a restart attempt (the reference rebuilds its
        loader), each process on its own seed; batches uploaded from
        page-locked memory without a host synchronisation."""
        data = build_train_iterator(cfg, records, per_rank,
                                    image_loader=image_loader,
                                    seed=cfg.seed + 1000 * attempt + rank)
        streams.append(data)
        return ({k: to_device_async(staged(v), device) for k, v in b.items()}
                for b in data)

    hooks = []
    if lead:
        writer = MetricsWriter(cfg.output_dir,
                               use_tensorboard=args.tensorboard)
        hooks.append(writer)
        if cfg.vis_period > 0:
            hooks.append(TrainVisHook(cfg.output_dir, period=cfg.vis_period,
                                      tb=writer.tb))
        if args.profile:
            hooks.append(ProfilerHook(cfg.output_dir))

    evals = []
    eval_fn = None
    if cfg.test.eval_period > 0:
        held = eval_records(cfg, records, args.synthetic, fs, cat_map)
        run = eval_cli.make_run_fn(model)
        class_names = list(cfg.datasets.category_names) or [
            str(i) for i in range(cfg.model.num_classes)]

        def eval_fn(state):
            helper = Omni3DEvaluationHelper(cfg.model.num_classes,
                                            class_names, device=device)
            eval_cli.evaluate_dataset(cfg, model, held, image_loader,
                                      per_rank, helper, "in_train_eval",
                                      run=run)
            result = helper.summarize_dataset("in_train_eval")
            evals.append(result)
            return result

    logger.info("training: %d iters, batch %d (%d a process over %d), "
                "grad accumulation %d, on %s", max_iter, rounded, per_rank,
                world, cfg.solver.grad_accum_steps, device)
    return TrainRun(cfg, state, step_fn, make_data_iter, ckpt, hooks,
                    eval_fn, evals, streams, rounded, world)


def main(argv=None) -> dict:
    """Train; returns `TrainRun.train()`'s summary, or the evaluation CLI's
    with --eval-only."""
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    if args.eval_only:
        return eval_cli.main(eval_only_argv(args))
    return build_run(args).train()


if __name__ == "__main__":
    main()
