"""The port's training step against the JAX package: the optimizer against
optax, the parameter groups and trunk freezing, the bridge on the training
tree, the in-graph skip semantics, the checkpoint and the restart loop, and
the whole slice -- compute_losses and one SGD step of the tiny model with the
trunk unfrozen, at matched weights, batch and sampling draws.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu.parallel import train_step as jts
from ovmono3d_tpu.train import optim as joptim
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.models.vit import LayerScale
from ovmono3d_tpu_torch.parallel.train_step import (
    GAMMA,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from ovmono3d_tpu_torch.train import optim as toptim
from ovmono3d_tpu_torch.train.checkpoint import SingleCheckpointer
from ovmono3d_tpu_torch.train.loop import train
from ovmono3d_tpu_torch.utils import flax_bridge
from test_model import _gt, tiny_config
from test_torch_rcnn3d import _spread, port_config, to_flax, training_tree
from test_torch_train_ops import jax_draws

torch.set_num_threads(2)

B, S = 2, 112


# ---------------------------------------------------------------- optimizer

class _Groups(nn.Module):
    """One parameter of each group: default (lin.weight, ls.gamma), bias
    (lin.bias) and norm (norm.weight / norm.bias)."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.norm = nn.LayerNorm(3)
        self.ls = LayerScale(3)


def _flax_tree(mod: _Groups) -> dict:
    t = {n: p.detach().numpy().copy() for n, p in mod.named_parameters()}
    return {"params": {
        "lin": {"kernel": t["lin.weight"].T, "bias": t["lin.bias"]},
        "norm": {"scale": t["norm.weight"], "bias": t["norm.bias"]},
        "ls": {"gamma": t["ls.gamma"]}}}


@pytest.mark.parametrize("kind,clip", [
    ("sgd", 0.0), ("sgd", 0.5), ("adam", 0.0), ("adamw", 0.0),
    ("adam+amsgrad", 0.0), ("adamw+amsgrad", 0.0)])
def test_optimizer_matches_optax(kind, clip):
    """3 steps: linear warmup over the first 2 and a decay at step 2, with
    weight decay, a bias LR factor and a norm group without decay."""
    rng = np.random.default_rng(0)
    solver = tcfg.SolverConfig(
        type=kind, base_lr=0.1, warmup_iters=2, warmup_factor=0.1,
        steps=(2,), gamma=0.1, weight_decay=1e-2, weight_decay_norm=0.0,
        bias_lr_factor=2.0, clip_gradients=clip)
    mod = _Groups()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    params = jax.tree.map(jnp.asarray, _flax_tree(mod))
    tx = joptim.build_optimizer(
        joptim.SolverConfig(**dataclasses.asdict(solver)), params)
    opt_state = tx.init(params)
    opt = toptim.Optimizer(solver, mod)
    for _ in range(3):
        grads_t = [torch.from_numpy(rng.normal(size=p.shape).astype(
            np.float32)) for p in opt.params]
        named = dict(zip(opt.names, grads_t))
        grads_j = jax.tree.map(jnp.asarray, {"params": {
            "lin": {"kernel": named["lin.weight"].numpy().T,
                    "bias": named["lin.bias"].numpy()},
            "norm": {"scale": named["norm.weight"].numpy(),
                     "bias": named["norm.bias"].numpy()},
            "ls": {"gamma": named["ls.gamma"].numpy()}}})
        updates, opt_state = tx.update(grads_j, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step(grads_t)
        got = _flax_tree(mod)
        # f32 on both sides: elementwise updates, a few ulp apart.
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=1e-6, atol=1e-6), got, params)
    assert int(opt.count) == 3


def test_warmup_multistep_schedule():
    sched = toptim.warmup_multistep(1.0, (100, 200), 0.1, 10, 0.1)
    for count, want in ((0, 0.1), (10, 1.0), (150, 0.1), (250, 0.01)):
        np.testing.assert_allclose(float(sched(torch.tensor(count))), want,
                                   rtol=1e-6)


def test_optimizer_skip_keeps_params_and_buffers():
    mod = _Groups()
    opt = toptim.Optimizer(tcfg.SolverConfig(warmup_iters=0), mod)
    opt.step([torch.ones_like(p) for p in opt.params])
    before = [p.detach().clone() for p in opt.params]
    trace = [t.clone() for t in opt.state["trace"]]
    nan = [torch.full_like(p, float("nan")) for p in opt.params]
    opt.step(nan, skip=torch.tensor(True))
    for a, b in zip(opt.params, before):
        assert torch.equal(a, b)
    for a, b in zip(opt.state["trace"], trace):
        assert torch.equal(a, b)
    assert int(opt.count) == 1


def test_entry_points_default_to_cuda():
    """build_model runs on the card unless asked for the CPU, and raises
    when there is none; the optimizer, the train state and the train step
    follow the model's device, so a model on the CPU is the one way to
    train there."""
    cfg = port_config(tiny_config().model)
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    opt = toptim.Optimizer(tcfg.SolverConfig(), model)
    state = create_train_state(model, opt)
    assert opt.device == state.step.device == torch.device("cpu")
    assert {t.device.type for t in (opt.count, state.loss_ema,
                                    *opt.state["trace"])} == {"cpu"}


# ------------------------------------------------------------ the slice


def _unfrozen_tiny():
    cfg = tiny_config()
    bb = dataclasses.replace(cfg.model.backbone, freeze=False)
    solver = dataclasses.replace(cfg.solver, base_lr=0.01, warmup_iters=0,
                                 steps=())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=bb), solver=solver)


def _np_batch():
    rng = np.random.default_rng(0)
    gt = jax.tree.map(np.asarray, _gt())
    return {
        "image": (rng.random((B, S, S, 3)) * 255).astype(np.float32),
        "K": np.tile(np.array([[100.0, 0, 56], [0, 100.0, 56], [0, 0, 1]],
                              np.float32), (B, 1, 1)),
        "im_hw": np.array([[112, 112], [98, 84]], np.int32),
        "im_scale_ratio": np.array([2.0, 1.5], np.float32),
        "gt_boxes": gt.boxes, "gt_classes": gt.classes,
        "gt_boxes3d": gt.boxes3d.astype(np.float32),
        "gt_poses": gt.poses.astype(np.float32), "gt_valid": gt.valid,
    }


def _step_draws(state_rng, anchors: int, proposals: int) -> dict:
    """The uniforms the JAX train step draws from its state's rng: the
    step key splits into the anchor and proposal keys, one per image."""
    _, step_rng = jax.random.split(state_rng)
    rng_anchor, rng_prop = jax.random.split(step_rng)
    return {
        "anchor": np.stack([jax_draws(k, anchors)
                            for k in jax.random.split(rng_anchor, B)]),
        "proposal": np.stack([jax_draws(k, proposals)
                              for k in jax.random.split(rng_prop, B)]),
    }


def slice_models():
    """The tiny unfrozen config, the numpy batch, the JAX model and one set
    of weights in both packages (flax tree, and loaded into the port's
    model), prepared as `slice_pair` says."""
    cfg = _unfrozen_tiny()
    batch = _np_batch()
    jmodel = jax_build_model(cfg.model)
    tree = training_tree(jmodel, batch["image"].shape, batch["gt_boxes"].shape[1])
    port = build_model(port_config(cfg.model), device="cpu", seed=1)
    params = _spread(to_flax(port, tree))
    params["params"]["rpn_head"]["objectness"]["kernel"] *= 0.0
    for head, fcs in (("box_head", ("fc1", "fc2")),
                      ("cube_head", ("shared_fc1", "shared_fc2"))):
        for fc in fcs:
            params["params"][head][fc]["bias"] += 3.0
    flax_bridge.load_flax_params(port, params)
    return cfg, batch, jmodel, params, port


def slice_draws(cfg, batch, state_rng) -> dict:
    """The port's `draws` for the JAX step taken from a state with rng
    `state_rng`."""
    n_anchors = sum(3 * h * w for h, w in ((16, 16), (8, 8), (4, 4)))
    return {k: torch.from_numpy(v) for k, v in _step_draws(
        state_rng, n_anchors,
        cfg.model.rpn.post_nms_topk_train + batch["gt_boxes"].shape[1]
    ).items()}


def update_errors(params, new_params, before, port, plan) -> dict:
    """{module key: (||d_port - d_jax||^2, ||d_jax||^2)} of the parameters'
    updates, d_jax from the flax trees `params` -> `new_params`, d_port from
    `before` to `port`'s parameters now; and every trunk parameter must have
    moved."""
    old = flax_bridge._flatten(params["params"])
    new = flax_bridge._flatten(jax.tree.map(np.asarray,
                                            new_params["params"]))
    now = dict(port.named_parameters())
    groups: dict = {}
    for path, (full, perm, flip) in plan.items():
        d_jax = new[path] - old[path]
        if flip:
            d_jax = d_jax[::-1, ::-1]
        if perm is not None:
            d_jax = np.transpose(d_jax, perm)
        d_port = (now[full] - before[full]).detach().numpy()
        key = ".".join(full.split(".")[:2])
        err, ref = groups.get(key, (0.0, 0.0))
        groups[key] = (err + float(((d_port - d_jax) ** 2).sum()),
                       ref + float((d_jax ** 2).sum()))
        if full.startswith("backbone.vit."):
            assert np.abs(d_port).max() > 0, full
    return groups


@pytest.fixture(scope="module")
def slice_pair():
    """One JAX train step and one port train step from the same weights,
    batch and draws. The bf16 trunk rounds at different places in the two
    frameworks, so two choices keep discrete decisions out of the
    comparison: the RPN objectness kernel is zeroed, so every anchor ties
    and both sides select proposals by index (an order taken from
    bf16-perturbed scores would differ), and the head MLPs' biases start at
    3, so no ReLU of the box and cube heads sits at its kink, where that
    rounding switches whole units on or off for a sample (with them at 0,
    a few units of the 32-wide heads flip and their gradients differ by
    tens of percent)."""
    cfg, batch, jmodel, params, port = slice_models()
    tx = joptim.build_optimizer(cfg.solver, params)
    state = jts.create_train_state(jax.tree.map(jnp.asarray, params), tx,
                                   jax.random.PRNGKey(2))
    state1, jmetrics = jax.jit(jts.make_train_step(jmodel, tx, 0.01))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["draws"] = slice_draws(cfg, batch, state.rng)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = toptim.Optimizer(port_config_solver(cfg.solver), port)
    tstate = create_train_state(port, opt)
    tstate, tmetrics = make_train_step(port, opt, 0.01)(
        tstate, tbatch)
    jnew = flax_bridge.plan(port, params)
    return params, state1, jmetrics, before, port, tmetrics, jnew


def port_config_solver(solver) -> tcfg.SolverConfig:
    return tcfg.SolverConfig(**{f.name: getattr(solver, f.name)
                                for f in dataclasses.fields(tcfg.SolverConfig)})


LOSSES = ["rpn/cls", "rpn/loc", "box/cls", "box/reg", "cube/loss_xy",
          "cube/loss_z", "cube/loss_dims", "cube/loss_pose", "cube/loss_joint",
          "cube/loss_uncert", "total_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_slice_losses_match_jax(slice_pair, name):
    """Every loss of compute_losses (and the total) within the 2e-2 bf16
    allowance of the serving slice: the trunk and ROI pooling run in bf16 on
    both sides, rounded at different places."""
    _, _, jmetrics, _, _, tmetrics, _ = slice_pair
    want = float(jmetrics[name])
    got = float(tmetrics[name])
    assert np.isfinite(got)
    assert abs(got - want) <= 2e-2 * abs(want) + 1e-6, (got, want)
    assert float(tmetrics["skipped"]) == float(jmetrics["skipped"]) == 0.0


def test_slice_sgd_step_matches_jax(slice_pair):
    """The parameters after one SGD step, as their update against the JAX
    step's: ||d_port - d_jax|| <= 2e-2 ||d_jax|| (the bf16 allowance, as
    above) over the trunk, the pyramid and each head layer, and every trunk
    parameter moved. Measured on this seed: at most 1.8e-2 (rpn_head.conv),
    7.3e-3 for the trunk."""
    params, state1, _, before, port, _, plan = slice_pair
    groups = update_errors(params, state1.params, before, port, plan)
    for key, (err, ref) in groups.items():
        assert np.sqrt(err) <= 2e-2 * np.sqrt(ref), (key, err, ref)


def test_bridge_loads_the_training_tree_strictly():
    cfg = _unfrozen_tiny()
    tree = training_tree(jax_build_model(cfg.model), (B, S, S, 3), 3)
    port = build_model(port_config(cfg.model), device="meta")
    plan = flax_bridge.plan(port, tree)
    assert len(plan) == len(dict(port.named_parameters()))
    assert {p.split("/")[0] for p in plan} == {
        "backbone", "rpn_head", "box_head", "cube_head"}
    assert plan["rpn_head/conv/kernel"][0] == "rpn_head.conv.weight"
    assert plan["box_head/fc1/kernel"][0] == "box_head.fc1.weight"
    flat = flax_bridge._flatten(tree["params"])
    del flat["box_head/bbox_pred/bias"]
    pruned: dict = {}
    for path, leaf in flat.items():
        d = pruned
        *mods, name = path.split("/")
        for m in mods:
            d = d.setdefault(m, {})
        d[name] = leaf
    with pytest.raises(KeyError, match="box_head.bbox_pred.bias"):
        flax_bridge.plan(port, pruned)


def test_param_groups_and_freeze_match_jax():
    cfg = tiny_config()
    tree = training_tree(jax_build_model(cfg.model), (B, S, S, 3), 3)
    port = build_model(port_config(cfg.model), device="meta")
    plan = flax_bridge.plan(port, tree)
    jlabels = flax_bridge._flatten(joptim.param_group_labels(tree)["params"])
    jmask = flax_bridge._flatten(joptim.freeze_backbone_mask(tree)["params"])
    tlabels = toptim.param_group_labels(port)
    tmask = toptim.freeze_backbone_mask(port)
    for path, (full, _, _) in plan.items():
        assert tlabels[full] == jlabels[path], path
        assert tmask[full] == jmask[path], path
        # freeze=True (the tiny config's default) freezes exactly the mask.
        assert dict(port.named_parameters())[full].requires_grad == \
            jmask[path], path
    assert {"default", "bias", "norm"} == set(tlabels.values())
    assert tlabels["backbone.vit.block0.ls1.gamma"] == "default"


# ------------------------------------------------- skip semantics (port)


@pytest.fixture(scope="module")
def port_setup():
    cfg = _unfrozen_tiny()
    model = build_model(port_config(cfg.model), device="cpu", seed=3)
    batch = {k: torch.from_numpy(v) for k, v in _np_batch().items()}
    return cfg, model, batch


def _fresh(port_setup, seed=0):
    cfg, model, batch = port_setup
    model = build_model(port_config(cfg.model), device="cpu", seed=3)
    opt = toptim.Optimizer(port_config_solver(cfg.solver), model)
    state = create_train_state(model, opt, seed=seed)
    step = make_train_step(model, opt, cfg.model.stabilize)
    return state, step, dict(batch)


def _poisoned(batch):
    bad = dict(batch)
    bad["image"] = batch["image"].clone()
    bad["image"][0, 0, 0, 0] = float("nan")
    return bad


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_skip_on_nonfinite_batch(port_setup):
    state, step, batch = _fresh(port_setup)
    before = _params(state)
    state, metrics = step(state, _poisoned(batch))
    assert float(metrics["skipped"]) == 1.0
    assert int(state.skipped) == 1 and int(state.step) == 1
    for a, b in zip(before, _params(state)):
        assert torch.equal(a, b)
    assert int(state.optimizer.count) == 0
    assert all(int(t.count_nonzero()) == 0
               for t in state.optimizer.state["trace"])


def test_nan_first_step_does_not_poison_ema(port_setup):
    state, step, batch = _fresh(port_setup, seed=5)
    state, m1 = step(state, _poisoned(batch))
    assert float(m1["skipped"]) == 1.0
    assert float(state.loss_ema) < 0
    before = _params(state)
    state, m2 = step(state, batch)
    assert float(m2["skipped"]) == 0.0
    assert float(state.loss_ema) > 0
    assert any(not torch.equal(a, b) for a, b in zip(before, _params(state)))


def test_loss_ema_reference_semantics(port_setup):
    state, step, batch = _fresh(port_setup, seed=4)
    state, m1 = step(state, batch)
    loss1 = float(m1["total_loss"])
    np.testing.assert_allclose(float(state.loss_ema),
                               2.0 * loss1 * (1 - GAMMA) + loss1 * GAMMA,
                               rtol=1e-6)
    # A poisoned step skips and freezes the EMA.
    ema = float(state.loss_ema)
    state, m2 = step(state, _poisoned(batch))
    assert float(m2["skipped"]) == 1.0
    assert float(state.loss_ema) == ema
    # An exploded loss (above 4x the EMA) skips too, and leaves the
    # parameters and the momentum buffers as they were.
    state.loss_ema.fill_(1e-6)
    before = _params(state)
    trace = [t.clone() for t in state.optimizer.state["trace"]]
    state, m3 = step(state, batch)
    assert float(m3["skipped"]) == 1.0
    assert int(state.skipped) == 2 and int(state.optimizer.count) == 1
    for a, b in zip(before, _params(state)):
        assert torch.equal(a, b)
    for a, b in zip(trace, state.optimizer.state["trace"]):
        assert torch.equal(a, b)
    assert float(state.loss_ema) == pytest.approx(1e-6)


def test_checkpoint_round_trip(port_setup, tmp_path):
    state, step, batch = _fresh(port_setup)
    state, _ = step(state, batch)
    ckpt = SingleCheckpointer(tmp_path)
    assert not ckpt.has()
    ckpt.save(state)
    saved = state.snapshot()
    state, _ = step(state, batch)
    assert int(state.step) == 2
    assert ckpt.load(state) is state
    assert int(state.step) == 1
    for (name, p) in state.model.named_parameters():
        assert torch.equal(p.detach(), saved["model"][name]), name
    for a, b in zip(state.optimizer.state["trace"],
                    saved["optimizer"]["state"]["trace"].values()):
        assert torch.equal(a, b)
    assert ckpt.load(state, "missing") is None


def test_eval_step_runs_oracle_inference(port_setup):
    _, model, batch = port_setup
    boxes = torch.tensor([[[10.0, 10, 50, 50]], [[5.0, 5, 60, 60]]])
    det = make_eval_step(model)(dict(
        batch, oracle_boxes=boxes, oracle_classes=torch.zeros(B, 1),
        oracle_scores=torch.ones(B, 1),
        oracle_valid=torch.ones(B, 1, dtype=torch.bool)))
    assert det.corners3d.shape == (B, 1, 8, 3)
    assert bool(torch.isfinite(det.corners3d).all())


class _FakeState:
    """The loop's view of a train state: step / skipped tensors, a host
    snapshot and a restore."""

    def __init__(self):
        self.params = torch.zeros(())
        self.step = torch.zeros((), dtype=torch.int64)
        self.skipped = torch.zeros((), dtype=torch.int32)

    def state_dict(self):
        return {"params": self.params, "step": self.step,
                "skipped": self.skipped}

    def snapshot(self):
        return {k: v.clone() for k, v in self.state_dict().items()}

    def load_state_dict(self, sd):
        for k, v in sd.items():
            getattr(self, k).copy_(v)


def test_restart_restores_initial_state_and_rebuilds_iterator():
    """Divergence before any checkpoint restores the initial state and pulls
    a fresh data stream (reference train_net.py:296-325)."""
    cfg = tcfg.Config(
        model=tcfg.ModelConfig(stabilize=0.5),
        solver=tcfg.SolverConfig(max_iter=6, checkpoint_period=2,
                                 max_training_attempts=5),
        test=tcfg.TestConfig(eval_period=0))
    made = []
    calls = {"n": 0}

    def factory(attempt):
        made.append(attempt)
        return itertools.count()

    def step_fn(state, batch):
        calls["n"] += 1
        state.params += 1.0
        state.step += 1
        state.skipped += int(calls["n"] <= 2)    # first two steps skip
        return state, {"total_loss": torch.zeros(())}

    final = train(cfg, _FakeState(), step_fn, itertools.count(),
                  data_iter_factory=factory)
    assert made == [1, 2]          # each of the two skipping steps restarts
    assert int(final.step) == 6
    assert float(final.params) == 6.0
