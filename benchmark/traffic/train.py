"""Closed-loop training traffic: one step in flight, as the port's train CLI
runs it.

Set-up builds the model on the card with the benchmark's seeded weights,
the port's optimizer, train state and `make_train_step` (the train CLI's
entry: `RCNN3D.compute_losses`, autograd, the skip rule, SGD), and a pool
of distinct batches from the generator, held on the device. It drives that
same state through its first three steps on three different batches (the
steps the reference follows), then hands it to the window. The window runs
steps over the pool for `seconds`, reading the losses back every 20 steps
as the train CLI's MetricsWriter does, and closes with a synchronize.
After it, the program's state is freed and the float32 reference trains
from the same weights on the same three batches and draws.
"""
from __future__ import annotations

import gc
import time

import torch

from benchmark import compare, generator, harness, weights
from benchmark.reference import train as ref_train
from benchmark.reference.numerics import Ops

METRICS_PERIOD = 20          # train/metrics.py MetricsWriter's read cadence
CHECKED_STEPS = 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(run: harness.Run, device):
    """(model, optimizer, state, step_fn, weights) at the config's sizes."""
    from ovmono3d_tpu_torch.models.rcnn3d import build_model, freeze_trunk
    from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                        make_train_step)
    from ovmono3d_tpu_torch.train.optim import Optimizer, with_grad_accum
    from ovmono3d_tpu_torch.utils.device import disable_tf32

    cfg = run.port()
    model = build_model(cfg.model, device="meta").to_empty(device=device)
    w = weights.draw(weights.specs_of(model), run.seed, device,
                     run.cfg.get("weight_means"))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    freeze_trunk(model, cfg.model.backbone.freeze)
    disable_tf32(torch.device(device))
    opt = with_grad_accum(Optimizer(cfg.solver, model),
                          cfg.solver.grad_accum_steps)
    state = create_train_state(model, opt, seed=run.seed)
    step = make_train_step(model, opt, cfg.model.stabilize)
    return model, opt, state, step, w


def first_steps(opt, state, step, pool, w) -> tuple:
    """The program's readings of its first three steps: each step's total
    loss, the first gradient as the optimizer received it (its momentum
    trace after one step, less the weight decay of the initial weights)
    and each leaf's change after three steps."""
    losses = []
    for i in range(CHECKED_STEPS):
        state, m = step(state, pool[i])
        losses.append(m)
        if i == 0:
            grad = {}
            for n, t, label in zip(opt.names, opt.state["trace"], opt.labels):
                grad[n] = t.detach().clone() - opt.groups[label][1] * w[n]
    delta = {n: p.detach() - w[n] for n, p in zip(opt.names, opt.params)}
    losses = [{k: float(v) for k, v in m.items()
               if k not in ("total_loss", "skipped")} for m in losses]
    return state, {"loss": [sum(m.values()) for m in losses],
                   "losses": losses, "grad": grad, "delta": delta}


def reference_batch(b: dict) -> dict:
    out = {k: v for k, v in b.items() if k != "draws"}
    out["draws_anchor"] = b["draws"]["anchor"]
    out["draws_proposal"] = b["draws"]["proposal"]
    return out


def reference(run: harness.Run, w: dict, batches: list, mode: str = "f32"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    remat = not run.cfg["model"]["backbone"]["freeze"]
    return ref_train.run_steps(Ops(mode), w, run.cfg,
                               [reference_batch(b) for b in batches], remat)


def run(run: harness.Run) -> None:
    device = torch.device(run.device)
    model, opt, state, step, w = build(run, device)
    g = torch.Generator(device=device).manual_seed(run.seed)
    pool = [generator.train_batch(g, run.cfg, run.traffic, device)
            for _ in range(run.traffic["pool"])]
    state, prog = first_steps(opt, state, step, pool, w)
    sync(device)
    run.e2e["setup_s"] = time.perf_counter() - run.started

    b = run.traffic["batch"]
    skipped, m = torch.zeros((), device=device), None
    window = harness.Window(run, lambda: sync(device))
    while window.next():
        i = window.units - 1
        state, m = step(state, pool[(CHECKED_STEPS + i) % len(pool)])
        skipped += m["skipped"]
        if window.units % METRICS_PERIOD == 0:
            run.work["losses"] = {k: float(v) for k, v in m.items()}
    window_s = window.close()
    steps = window.units
    run.e2e["train_img_per_s"] = steps * b / window_s
    run.attempted, run.failed = steps, int(skipped)
    run.traced = window.traced
    run.work.update(steps=window.traced_units,
                    images=window.traced_units * b)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    check_t0 = time.perf_counter()
    checked = pool[:CHECKED_STEPS]
    del model, opt, state, step, pool, m, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(run, w, checked)
    limits = run.traffic["limits"]
    run.checks.update((k, (v, limits[k]))
                      for k, v in compare.train_numbers(prog, ref).items()
                      if k in limits)
    run.notes.append(f"losses program {prog['loss']} reference "
                     f"{ref['loss']} skipped {ref['skipped']}")
    nums = compare.train_numbers(prog, ref)
    nums.update(compare.train_diagnostics(prog, ref))
    run.notes.append("readings " + " ".join(f"{k}={v!r}" for k, v in
                                              nums.items()))
    run.notes.append(f"check_s={time.perf_counter() - check_t0!r}")
