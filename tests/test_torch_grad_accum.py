"""Gradient accumulation in the port (train/optim.py `with_grad_accum`, the
JAX package's optax.MultiSteps): k = 2 on one micro-batch with the draws
pinned changes nothing after the first micro-step and equals one plain step
after the second (atol 1e-6); the optimizer fed the same gradients as the
JAX package's `with_grad_accum` over 4 updates with a skipped micro-step
(f32, 1e-6); the tiny model's train step after 2 micro-steps against the
JAX step's on shared draws (the slice tests' 2e-2 allowance of
tests/test_torch_train_step.py); a skipped micro-step leaves the
accumulator and the micro-count as they were; a checkpoint taken
mid-accumulation resumes to the same parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ovmono3d_tpu.parallel import train_step as jts
from ovmono3d_tpu.train import optim as joptim
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
from ovmono3d_tpu_torch.train import optim as toptim
from ovmono3d_tpu_torch.train.checkpoint import SingleCheckpointer
from ovmono3d_tpu_torch.utils import flax_bridge
from test_torch_rcnn3d import port_config
from test_torch_train_step import (_flax_tree, _Groups, _np_batch,
                                   _unfrozen_tiny, port_config_solver,
                                   slice_draws, slice_models, update_errors)

torch.set_num_threads(2)

SLICE_TOL = 2e-2


def _setup(k: int, seed: int = 3):
    cfg = _unfrozen_tiny()
    model = build_model(port_config(cfg.model), device="cpu", seed=seed)
    opt = toptim.with_grad_accum(
        toptim.Optimizer(port_config_solver(cfg.solver), model), k)
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, cfg.model.stabilize)
    return cfg, model, state, step


@pytest.fixture(scope="module")
def batch():
    cfg = _unfrozen_tiny()
    np_batch = _np_batch()
    out = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    out["draws"] = slice_draws(cfg, np_batch, jax.random.PRNGKey(7))
    return out


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_k1_is_the_optimizer_itself():
    cfg = _unfrozen_tiny()
    model = build_model(port_config(cfg.model), device="meta")
    opt = toptim.Optimizer(port_config_solver(cfg.solver), model)
    assert toptim.with_grad_accum(opt, 1) is opt
    with pytest.raises(ValueError, match="grad_accum_steps=0"):
        toptim.with_grad_accum(opt, 0)


def test_two_micro_steps_equal_one_plain_step(batch):
    _, plain_model, plain_state, plain_step = _setup(1)
    plain_state, _ = plain_step(plain_state, batch)
    _, model, state, step = _setup(2)
    before = _params(model)
    state, metrics = step(state, batch)
    assert float(metrics["skipped"]) == 0.0
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert int(state.optimizer.count) == 0
    assert int(state.optimizer.mini_step) == 1
    state, _ = step(state, batch)
    assert int(state.optimizer.count) == 1
    assert int(state.optimizer.mini_step) == 0
    assert all(int(a.count_nonzero()) == 0 for a in state.optimizer.acc)
    want = dict(plain_model.named_parameters())
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[n].detach(), rtol=0,
                                   atol=1e-6, msg=n)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_accumulation_matches_optax_multisteps(kind):
    """k = 2 over 9 micro-steps, the 4th skipped (the JAX train step then
    keeps its whole state, MultiSteps' included): the warmup and the decay
    at update 2 follow the update count, each update is the mean of its
    micro-gradients, and nothing moves between updates."""
    rng = np.random.default_rng(1)
    solver = tcfg.SolverConfig(
        type=kind, base_lr=0.1, warmup_iters=2, warmup_factor=0.1,
        steps=(2,), gamma=0.1, weight_decay=1e-2, weight_decay_norm=0.0,
        bias_lr_factor=2.0)
    mod = _Groups()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    params = jax.tree.map(jnp.asarray, _flax_tree(mod))
    tx = joptim.with_grad_accum(joptim.build_optimizer(
        joptim.SolverConfig(**dataclasses.asdict(solver)), params), 2)
    opt_state = tx.init(params)
    opt = toptim.with_grad_accum(toptim.Optimizer(solver, mod), 2)
    for micro in range(9):
        grads_t = [torch.from_numpy(rng.normal(size=p.shape).astype(
            np.float32)) for p in opt.params]
        skip = micro == 3
        named = dict(zip(opt.names, grads_t))
        grads_j = jax.tree.map(jnp.asarray, {"params": {
            "lin": {"kernel": named["lin.weight"].numpy().T,
                    "bias": named["lin.bias"].numpy()},
            "norm": {"scale": named["norm.weight"].numpy(),
                     "bias": named["norm.bias"].numpy()},
            "ls": {"gamma": named["ls.gamma"].numpy()}}})
        if not skip:
            updates, opt_state = tx.update(grads_j, opt_state, params)
            params = optax.apply_updates(params, updates)
        opt.step(grads_t, skip=torch.tensor(skip))
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=1e-6, atol=1e-6), _flax_tree(mod), params)
        assert int(opt.mini_step) == int(opt_state.mini_step)
        assert int(opt.count) == int(opt_state.gradient_step)
    assert int(opt.count) == 4


def test_two_micro_steps_match_jax_train_step():
    """Both packages' train steps with k = 2 on the tiny unfrozen model,
    the JAX step's draws given to the port, twice on one micro-batch with
    the JAX state's rng pinned (as tests/test_train_step.py does), so the
    update is one step's: its deviation from the JAX update is the slice
    tests'. (With the second micro-step's own draws the bf16 noise of the
    RPN conv's gradient, 1.8e-2 on one step, measured 4.0e-2 against a
    mean gradient that partly cancels; every other layer stays under
    7e-3.)"""
    cfg, batch, jmodel, params, port = slice_models()
    tx = joptim.with_grad_accum(joptim.build_optimizer(cfg.solver, params),
                                2)
    rng = jax.random.PRNGKey(2)
    state = jts.create_train_state(jax.tree.map(jnp.asarray, params), tx,
                                   rng)
    jstep = jax.jit(jts.make_train_step(jmodel, tx, 0.01))
    opt = toptim.with_grad_accum(
        toptim.Optimizer(port_config_solver(cfg.solver), port), 2)
    tstate = create_train_state(port, opt)
    tstep = make_train_step(port, opt, 0.01)
    before = _params(port)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    tbatch["draws"] = slice_draws(cfg, batch, rng)
    for _ in range(2):
        state, jm = jstep(state.replace(rng=rng), jbatch)
        tstate, tm = tstep(tstate, tbatch)
        assert float(jm["skipped"]) == float(tm["skipped"]) == 0.0
    assert int(tstate.optimizer.count) == 1
    groups = update_errors(params, state.params, before, port,
                           flax_bridge.plan(port, params))
    for key, (err, ref) in groups.items():
        assert np.sqrt(err) <= SLICE_TOL * np.sqrt(ref), (key, err, ref)


def test_skipped_micro_step_leaves_the_accumulator(batch):
    _, model, state, step = _setup(2)
    state, _ = step(state, batch)
    acc = [a.clone() for a in state.optimizer.acc]
    before = _params(model)
    bad = dict(batch)
    bad["image"] = batch["image"].clone()
    bad["image"][0, 0, 0, 0] = float("nan")
    state, metrics = step(state, bad)
    assert float(metrics["skipped"]) == 1.0
    assert int(state.optimizer.mini_step) == 1
    assert int(state.optimizer.count) == 0
    for a, b in zip(acc, state.optimizer.acc):
        assert torch.equal(a, b)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    # The next good micro-step completes the update.
    state, _ = step(state, batch)
    assert int(state.optimizer.count) == 1


def test_checkpoint_mid_accumulation_resumes_exactly(batch, tmp_path):
    _, model, state, step = _setup(2)
    state, _ = step(state, batch)
    SingleCheckpointer(tmp_path).save(state)
    state, _ = step(state, batch)
    want = _params(model)
    _, resumed_model, resumed, rstep = _setup(2, seed=11)
    assert SingleCheckpointer(tmp_path).load(resumed) is resumed
    assert int(resumed.optimizer.mini_step) == 1
    resumed, _ = rstep(resumed, batch)
    for n, p in resumed_model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
