"""Data parallelism of the port over torch.distributed, on the CPU with gloo
processes: two processes with half the batch each (and the sampling draws
split by rank) end one train step, and two micro-steps with gradient
accumulation, with the parameters of one process on the whole batch (f32,
atol 1e-6); one process's half non-finite makes both skip; two processes
that resume from a checkpoint, each drawing from its own generator, go on
as if never stopped;
`process_shard` / `gather_objects` across two ranks; the evaluation CLI's
`--data-parallel` over two ranks prints the tables of a single run (the JAX
package's tests/test_cli.py:339-361); `init_multihost` with a coordinator
that does not answer raises.

The processes are this file run as a script (`worker`); each is given a
time limit.
"""
from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from ovmono3d_tpu_torch.config import load_config  # noqa: E402
from ovmono3d_tpu_torch.models.rcnn3d import build_model  # noqa: E402
from ovmono3d_tpu_torch.ops.boxes import uniform_draws  # noqa: E402
from ovmono3d_tpu_torch.parallel import mesh  # noqa: E402
from ovmono3d_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state, make_train_step)
from ovmono3d_tpu_torch.train.checkpoint import (  # noqa: E402
    SingleCheckpointer)
from ovmono3d_tpu_torch.train.optim import (  # noqa: E402
    Optimizer, with_grad_accum)

torch.set_num_threads(2)

# tests/test_cli.py's tiny model, its trunk unfrozen.
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
TRAIN = [*TINY, "model.backbone.freeze=false", "model.exact_roi_pool=true",
         "solver.base_lr=0.01", "solver.warmup_iters=0", "solver.steps=[]"]
B, M, S = 4, 3, 112
WORKER_TIMEOUT = 240


def f32_model(cfg):
    """The tiny model computing in f32 throughout (every module's compute
    dtype set to f32; exact ROI pooling in the config), so one process on
    the whole batch and two on its halves differ only by the order of
    f32 sums."""
    model = build_model(cfg.model, device="cpu", seed=1)
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    return model


def global_batch(seed: int = 0, poison: int | None = None) -> dict:
    """B images with M GT slots each: boxes in front of the camera, their
    2D boxes the projected extents (image `poison` holds a NaN)."""
    rng = np.random.default_rng(seed)
    f = 100.0
    K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
    center = np.stack([rng.uniform(-1, 1, (B, M)),
                       rng.uniform(-.5, .5, (B, M)),
                       rng.uniform(3, 8, (B, M))], -1)
    dims = rng.uniform(0.5, 1.5, (B, M, 3))
    uv = center[..., :2] / center[..., 2:] * f + S / 2
    half = dims[..., :2] * f / center[..., 2:] / 2
    boxes = np.clip(np.concatenate([uv - half, uv + half], -1), 0, S - 1)
    image = rng.uniform(0, 255, (B, S, S, 3))
    if poison is not None:
        image[poison, 0, 0, 0] = np.nan
    valid = np.ones((B, M), bool)
    valid[1::2, -1] = False
    return {
        "image": torch.tensor(image, dtype=torch.float32),
        "K": torch.tensor(np.tile(K, (B, 1, 1))),
        "im_hw": torch.full((B, 2), S, dtype=torch.int32),
        "im_scale_ratio": torch.ones(B),
        "gt_boxes": torch.tensor(boxes, dtype=torch.float32),
        "gt_classes": torch.tensor(rng.integers(0, 9, (B, M))),
        "gt_boxes3d": torch.tensor(np.concatenate([uv, center[..., 2:], dims,
                                                   center], -1),
                                   dtype=torch.float32),
        "gt_poses": torch.eye(3).expand(B, M, 3, 3).contiguous(),
        "gt_valid": torch.tensor(valid),
    }


def batch_draws(model, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    n_anchors = sum(len(model.cfg.anchors.aspect_ratios) * (S // st) ** 2
                    for st in model.feature_strides)
    n_props = model.cfg.rpn.post_nms_topk_train + M
    return {"anchor": uniform_draws((B, 2, n_anchors), g),
            "proposal": uniform_draws((B, 2, n_props), g)}


def train_run(k: int, steps: int, rank: int = 0, world: int = 1,
              poison: int | None = None) -> dict:
    """`steps` train steps of the f32 tiny model (k micro-steps an update)
    on this process's share of each step's global batch and draws."""
    cfg = load_config(None, overrides=TRAIN)
    model = f32_model(cfg)
    opt = with_grad_accum(Optimizer(cfg.solver, model), k)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, cfg.model.stabilize)
    share = slice(rank * B // world, (rank + 1) * B // world)
    losses = []
    for i in range(steps):
        batch = global_batch(seed=i, poison=poison)
        batch["draws"] = batch_draws(model, seed=100 + i)
        state, metrics = step(state, {
            key: ({d: v[share] for d, v in val.items()} if key == "draws"
                  else val[share]) for key, val in batch.items()})
        losses.append(float(metrics["total_loss"]))
    return {"params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "skipped": int(state.skipped), "count": int(opt.count),
            "losses": losses}


def resume_run(rank: int, world: int, ckpt_dir: str) -> dict:
    """Two steps straight on, and the second again after a checkpoint of
    the first was loaded into a fresh state. Each process samples from its
    own generator (seed 1 + rank, as the train CLI seeds it)."""
    cfg = load_config(None, overrides=TRAIN)
    share = slice(rank * B // world, (rank + 1) * B // world)
    batches = [{k: v[share] for k, v in global_batch(seed=i).items()}
               for i in range(2)]

    def fresh():
        model = f32_model(cfg)
        opt = with_grad_accum(Optimizer(cfg.solver, model), 1)
        return (model, create_train_state(model, opt, seed=1 + rank),
                make_train_step(model, opt, cfg.model.stabilize))

    model, state, step = fresh()
    state, _ = step(state, batches[0])
    ckpt = SingleCheckpointer(ckpt_dir, writer=rank == 0)
    ckpt.save(state)
    torch.distributed.barrier()             # the file is written
    state, _ = step(state, batches[1])
    straight = {n: p.detach().clone() for n, p in model.named_parameters()}
    model, state, step = fresh()
    state = ckpt.load(state)
    state, _ = step(state, batches[1])
    return {"straight": straight, "resumed": dict(model.named_parameters()),
            "generator": state.generator.get_state()}


def worker(mode: str, rank: int, world: int, port: int, out: str,
           *extra: str) -> None:
    torch.set_num_threads(1)
    mesh.init_multihost(f"localhost:{port}", world, rank, device="cpu",
                        timeout_s=120)
    if mode == "train":
        k, steps, poison = (int(x) for x in extra)
        torch.save(train_run(k, steps, rank, world,
                             None if poison < 0 else poison), out)
    elif mode == "resume":
        torch.save(resume_run(rank, world, extra[0]), out)
    elif mode == "gather":
        mine = mesh.process_shard(list(range(7)))
        Path(out).write_text(json.dumps({
            "mine": mine, "all": mesh.gather_objects(mine),
            "rank": mesh.rank(), "world": mesh.world_size()}))
    elif mode == "eval":
        from ovmono3d_tpu_torch.eval import cli as eval_cli

        text = io.StringIO()
        with redirect_stdout(text):
            eval_cli.main(EVAL_ARGS + ["--data-parallel"])
        Path(out).write_text(text.getvalue())
    torch.distributed.destroy_process_group()


EVAL_ARGS = ["--synthetic", "--device", "cpu", "--batch-size", "4", *TINY]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp_path: Path, mode: str, *extra: str, world: int = 2
           ) -> list[Path]:
    """Run `world` worker processes of `mode`; returns their output files."""
    port = _free_port()
    outs = [tmp_path / f"{mode}_{r}.out" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world), str(port),
         str(outs[r]), *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors
    return outs


def _same_params(got: dict, want: dict, atol: float) -> None:
    assert got.keys() == want.keys()
    for name, p in got.items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=atol,
                                   msg=name)


@pytest.mark.parametrize("k,steps", [(1, 1), (2, 2)],
                         ids=["one_step", "accumulated"])
def test_two_ranks_equal_one_process_on_the_whole_batch(tmp_path, k, steps):
    want = train_run(k, steps)
    assert want["count"] == 1 and want["skipped"] == 0
    outs = launch(tmp_path, "train", str(k), str(steps), "-1")
    got = [torch.load(o, weights_only=True) for o in outs]
    for g in got:
        assert g["count"] == 1 and g["skipped"] == 0
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=1e-5)
        _same_params(g["params"], want["params"], atol=1e-6)
    # Both ranks hold the same parameters, bit for bit.
    _same_params(got[0]["params"], got[1]["params"], atol=0)


def test_one_ranks_nonfinite_half_makes_both_skip(tmp_path):
    outs = launch(tmp_path, "train", "1", "1", str(B - 1))
    init = train_run(1, 0)["params"]
    for o in outs:
        got = torch.load(o, weights_only=True)
        assert got["skipped"] == 1 and got["count"] == 0
        assert not np.isfinite(got["losses"][0])
        _same_params(got["params"], init, atol=0)


def test_two_ranks_resume_with_their_own_sampling_generators(tmp_path):
    outs = launch(tmp_path, "resume", str(tmp_path / "ckpt"))
    got = [torch.load(o, weights_only=True) for o in outs]
    saved = torch.load(tmp_path / "ckpt" / "model_recent.pt",
                       weights_only=True)
    assert len(saved["rank_generators"]) == 2
    assert not torch.equal(*saved["rank_generators"])
    for g in got:
        _same_params(g["resumed"], g["straight"], atol=0)
    assert not torch.equal(got[0]["generator"], got[1]["generator"])


def test_process_shard_and_gather_objects(tmp_path):
    got = [json.loads(o.read_text()) for o in launch(tmp_path, "gather")]
    assert [g["mine"] for g in got] == [[0, 2, 4, 6], [1, 3, 5]]
    for g in got:
        assert g["all"] == [0, 2, 4, 6, 1, 3, 5]
        assert g["world"] == 2
    assert [g["rank"] for g in got] == [0, 1]
    # One process: its own list, every record.
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.process_shard(list(range(3))) == [0, 1, 2]
    assert mesh.gather_objects([5]) == [5]


def test_eval_cli_data_parallel_prints_the_single_run_tables(tmp_path,
                                                             capsys):
    from ovmono3d_tpu_torch.eval import cli as eval_cli

    eval_cli.main(EVAL_ARGS)
    single = capsys.readouterr().out
    outs = launch(tmp_path, "eval")
    dp = outs[0].read_text()
    assert "overall (all test datasets merged)" in dp
    assert dp == single
    assert outs[1].read_text() == ""           # rank 0 alone prints


def test_init_multihost_refuses_a_coordinator_that_does_not_answer():
    with pytest.raises(ValueError, match="num_processes"):
        mesh.init_multihost("localhost:1", device="cpu")
    # Rank 1 of 2 connects to a port nobody listens on: it must raise, not
    # go on as a one-process job.
    with pytest.raises(Exception) as err:
        mesh.init_multihost(f"localhost:{_free_port()}", 2, 1, device="cpu",
                            timeout_s=3)
    assert not isinstance(err.value, AssertionError)
    assert not torch.distributed.is_initialized()
    assert not mesh.init_multihost(device="cpu")    # no coordinator, no env


if __name__ == "__main__":
    mode, rank, world, port, out, *rest = sys.argv[1:]
    worker(mode, int(rank), int(world), int(port), out, *rest)
