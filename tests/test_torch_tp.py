"""Tensor parallelism of the port (parallel/tensor_parallel.py, the data x
model groups of parallel/mesh.py) on the CPU with gloo processes.

- The port's sharded leaves are the JAX rule's (sharding_rules.py) on the
  JAX tests' tiny config and on the dry run's, axis for axis.
- Data 2 x model 2 processes, each data rank on half the batch (and half
  the sampling draws), against one process on the whole batch: the loss
  (rtol 1e-5), the gradients the optimizer receives (each rank's shard of
  them, within 1e-5 of the largest |gradient| of the tensor) and the
  parameters after one SGD step (atol 1e-6, test_torch_ddp.py's limit), f32
  throughout, the trunk unfrozen.
- A non-finite image on one data rank makes all four skip.
- The dry run (parallel/dryrun.py) over 2 x 2 gloo processes prints its
  loss; over 1 x 2 with the flagship's file cut to the tiny widths and the
  trunk unfrozen, as the cards run it; on CUDA it needs a card a process.
- Refusals: heads that do not split, an int8 serving layer, a box head of
  one FC (a column-parallel layer without its row-parallel partner).

The processes are this file run as a script (`worker`), each with a time
limit.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from ovmono3d_tpu_torch.config import load_config  # noqa: E402
from ovmono3d_tpu_torch.models.rcnn3d import build_model  # noqa: E402
from ovmono3d_tpu_torch.ops.boxes import uniform_draws  # noqa: E402
from ovmono3d_tpu_torch.parallel import mesh  # noqa: E402
from ovmono3d_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from ovmono3d_tpu_torch.parallel.dryrun import TINY  # noqa: E402
from ovmono3d_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state, make_train_step)
from ovmono3d_tpu_torch.train.optim import Optimizer  # noqa: E402

torch.set_num_threads(2)

TRAIN = [*TINY, "model.backbone.freeze=false", "model.exact_roi_pool=true",
         "solver.base_lr=0.01", "solver.warmup_iters=0", "solver.steps=[]"]
N_DATA, N_MODEL = 2, 2
B, M, S = 4, 3, 112
WORKER_TIMEOUT = 240
LOSS_RTOL, GRAD_REL, PARAM_ATOL = 1e-5, 1e-5, 1e-6


def f32_model(cfg):
    """The tiny model computing in f32 throughout."""
    model = build_model(cfg.model, device="cpu", seed=1)
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    return model


def global_batch(poison: int | None = None) -> dict:
    """test_torch_ddp.py's batch: B images, M GT slots in front of the
    camera (image `poison` holds a NaN)."""
    rng = np.random.default_rng(0)
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
        "gt_valid": torch.ones(B, M, dtype=torch.bool),
    }


def batch_draws(model) -> dict:
    g = torch.Generator().manual_seed(100)
    n_anchors = sum(len(model.cfg.anchors.aspect_ratios) * (S // st) ** 2
                    for st in model.feature_strides)
    n_props = model.cfg.rpn.post_nms_topk_train + M
    return {"anchor": uniform_draws((B, 2, n_anchors), g),
            "proposal": uniform_draws((B, 2, n_props), g)}


def train_once(extra: list[str], groups=None, poison: int | None = None
               ) -> dict:
    """One step of the f32 tiny model on this data rank's share (the whole
    batch without groups): the loss, the gradients the optimizer got, the
    parameters after the step."""
    cfg = load_config(None, overrides=[*TRAIN, *extra])
    model = f32_model(cfg)
    if groups is not None:
        tp.apply_tp(model, groups.model)
    opt = Optimizer(cfg.solver, model)
    seen = {}
    step_fn = opt.step

    def spy(grads, skip=None):
        seen.update({n: g.detach().clone()
                     for n, g in zip(opt.names, grads) if g is not None})
        return step_fn(grads, skip)

    opt.step = spy
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, cfg.model.stabilize, groups)
    batch = global_batch(poison)
    batch["draws"] = batch_draws(model)
    d = groups.data_rank if groups is not None else 0
    n = groups.n_data if groups is not None else 1
    share = slice(d * B // n, (d + 1) * B // n)
    state, metrics = step(state, {
        k: ({j: v[share] for j, v in val.items()} if k == "draws"
            else val[share]) for k, val in batch.items()})
    return {"loss": float(metrics["total_loss"]),
            "skipped": int(state.skipped), "grads": seen,
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()}}


def worker(rank: int, world: int, port: int, out: str, *extra: str) -> None:
    torch.set_num_threads(1)
    mesh.init_multihost(f"localhost:{port}", world, rank, device="cpu",
                        timeout_s=120)
    groups = mesh.make_groups(N_DATA, N_MODEL)
    poison = [int(x.split("=")[1]) for x in extra if x.startswith("poison=")]
    extra = [x for x in extra if not x.startswith("poison=")]
    torch.save({"groups": (groups.data_rank, groups.model_rank),
                **train_once(list(extra), groups,
                             poison[0] if poison else None)}, out)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp_path: Path, *extra: str) -> list[dict]:
    world = N_DATA * N_MODEL
    port = _free_port()
    outs = [tmp_path / f"tp_{r}.pt" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port),
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
    return [torch.load(o, weights_only=True) for o in outs]


def shard_of(full: dict, name: str, plan: dict) -> torch.Tensor:
    """This rank's slice of the full tensor `name` by the shard plan."""
    layer, _, leaf = name.rpartition(".")
    if layer not in plan:
        return full[name]
    kind, idx, *_ = plan[layer]
    if kind == "col":
        return full[name][idx]
    return full[name][:, idx] if leaf == "weight" else full[name]


def test_data2_model2_equal_one_process(tmp_path):
    want = train_once([])
    assert want["skipped"] == 0
    cfg = load_config(None, overrides=TRAIN)
    ref = build_model(cfg.model, device="meta")
    got = launch(tmp_path)
    assert sorted(g["groups"] for g in got) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    sharded = tp.sharded_leaves(ref, N_MODEL)
    assert {"box_head.fc1.weight", "box_head.fc2.weight"} <= sharded.keys()
    for g in got:
        plan = tp.shard_plan(ref, N_MODEL, g["groups"][1])
        assert g["skipped"] == 0
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=LOSS_RTOL)
        assert g["grads"].keys() == want["grads"].keys()
        for name, grad in g["grads"].items():
            w = shard_of(want["grads"], name, plan)
            assert grad.shape == w.shape, name
            tol = GRAD_REL * float(w.abs().max()) + 1e-12
            assert float((grad - w).abs().max()) <= tol, name
        for name, p in g["params"].items():
            torch.testing.assert_close(
                p, shard_of(want["params"], name, plan), rtol=0,
                atol=PARAM_ATOL, msg=name)
    # The two model ranks of a data rank hold different shards; the two data
    # ranks of a model rank the same parameters, bit for bit.
    by = {g["groups"]: g for g in got}
    for m in range(N_MODEL):
        for name, p in by[(0, m)]["params"].items():
            assert torch.equal(p, by[(1, m)]["params"][name]), name
    assert not torch.equal(
        by[(0, 0)]["params"]["backbone.vit.block0.mlp.fc1.weight"],
        by[(0, 1)]["params"]["backbone.vit.block0.mlp.fc1.weight"])


def test_one_data_ranks_nonfinite_image_makes_all_four_skip(tmp_path):
    init = train_once([])["params"]          # only for the shapes' check
    got = launch(tmp_path, f"poison={B - 1}")
    cfg = load_config(None, overrides=TRAIN)
    ref = build_model(cfg.model, device="meta")
    fresh = {k: p.detach() for k, p in f32_model(cfg).named_parameters()}
    for g in got:
        plan = tp.shard_plan(ref, N_MODEL, g["groups"][1])
        assert g["skipped"] == 1
        for name, p in g["params"].items():
            assert torch.equal(p, shard_of(fresh, name, plan)), name
            assert p.dim() == init[name].dim()


def test_sharded_leaves_are_the_jax_rule():
    import __graft_entry__ as ge
    from test_model import tiny_config
    from test_torch_rcnn3d import port_config

    from ovmono3d_tpu.models.rcnn3d import build_model as jax_build
    from ovmono3d_tpu.parallel.mesh import make_mesh
    from ovmono3d_tpu.parallel.sharding_rules import tp_param_shardings
    from ovmono3d_tpu_torch.utils.flax_bridge import plan as bridge_plan

    mesh_ = make_mesh(n_data=4, n_model=2)
    for what, jc in (("jax tests' tiny", tiny_config().model),
                     ("dry run's", ge._flagship_config(
                         square_pad=112, tiny=True).model)):
        model = jax_build(jc)
        s = jc.backbone.square_pad
        params = jax.eval_shape(
            model.init, jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
            jnp.eye(3)[None], jnp.full((1, 2), s, jnp.int32), jnp.ones((1,)))
        port = build_model(port_config(jc), device="meta")
        names = bridge_plan(port, params)
        want = {}
        for path, sh in jax.tree_util.tree_flatten_with_path(
                tp_param_shardings(params, mesh_))[0]:
            spec = tuple(sh.spec)
            if "model" not in spec:
                continue
            key = "/".join(getattr(k, "key", str(k)) for k in path[1:])
            # A flax kernel [in, out] is the torch weight [out, in].
            want[names[key][0]] = 0 if spec[-1] == "model" else 1
        got = tp.sharded_leaves(port, 2)
        assert got == want, what
        assert len(got) == 6 * jc.backbone.depth + 3, what


def test_refusals_and_a_group_of_one():
    cfg = load_config(None, overrides=TINY)
    model = build_model(cfg.model, device="meta")
    assert tp.sharded_leaves(model, 1) == {}
    with pytest.raises(ValueError, match="heads do not split"):
        tp.shard_plan(model, 4, 0)         # 2 heads over 4 ranks
    cfg = load_config(None, overrides=[*TINY, "model.backbone.quant=int8"])
    with pytest.raises(ValueError, match="int8"):
        tp.shard_plan(build_model(cfg.model, device="meta"), 2, 0)


def test_an_unpaired_column_parallel_layer_is_refused():
    cfg = load_config(None, overrides=[*TINY, "model.roi_box.num_fc=1"])
    model = build_model(cfg.model, device="meta")
    assert "box_head.fc1.weight" in tp.sharded_leaves(model, 2)
    with pytest.raises(ValueError, match="box_head.fc1 splits over 2 ranks "
                                         "but box_head.fc2 does not"):
        tp.shard_plan(model, 2, 0)


def test_dryrun_prints_the_loss(capsys):
    from ovmono3d_tpu_torch.parallel import dryrun

    metrics = dryrun.main(["--device", "cpu", "--data", "2", "--model", "2"])
    out = capsys.readouterr().out
    assert "dryrun ok: 4 processes (data=2 x model=2) on cpu, 1 step" in out
    assert np.isfinite(metrics["total_loss"]) and metrics["skipped"] == 0


def test_dryrun_of_a_config_file_with_the_trunk_unfrozen(capsys):
    """The cards' invocation (the flagship's file, the trunk trained), cut
    to the tiny widths and run over 1 x 2 gloo processes."""
    from ovmono3d_tpu_torch.parallel import dryrun

    metrics = dryrun.main(["--device", "cpu", "--data", "1", "--model", "2",
                           "--config-file",
                           str(REPO / "configs/OVMono3D_dinov2_SFP.yaml"),
                           *TINY, "model.backbone.freeze=false"])
    out = capsys.readouterr().out
    assert "dryrun ok: 2 processes (data=1 x model=2) on cpu, 1 step" in out
    assert np.isfinite(metrics["total_loss"]) and metrics["skipped"] == 0


def test_dryrun_on_cuda_needs_a_card_a_process():
    from ovmono3d_tpu_torch.parallel import dryrun

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("the cards are here")
    with pytest.raises(RuntimeError, match="4 processes need 4 cards"):
        dryrun.main(["--data", "2", "--model", "2"])


if __name__ == "__main__":
    rank_, world_, port_, out_, *rest = sys.argv[1:]
    worker(int(rank_), int(world_), int(port_), out_, *rest)
