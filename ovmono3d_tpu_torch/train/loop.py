"""Host-side training loop with stabilisation restarts (counterpart of
ovmono3d_tpu/train/loop.py; reference tools/train_net.py:140-473).

The per-step skip is decided on the card (parallel/train_step.py). This loop
adds the outer layer: when the fraction of skipped updates since the last
checkpoint reaches MODEL.STABILIZE, it restores the last checkpoint (or, when
there is none yet, the initial state) and rebuilds the data stream, up to
`max_training_attempts` times. The step counter is kept on the host, and
`skipped` is read from the card only at the sparse check steps, so the loop
does not wait for the card every step.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Iterator

from ovmono3d_tpu_torch.config import Config
from ovmono3d_tpu_torch.ops.quant import SERVING_ONLY
from ovmono3d_tpu_torch.train.checkpoint import SingleCheckpointer

logger = logging.getLogger(__name__)


def train(cfg: Config, state, step_fn: Callable, data_iter: Iterator,
          checkpointer: SingleCheckpointer | None = None,
          hooks: list[Callable] | None = None,
          eval_fn: Callable | None = None,
          data_iter_factory: Callable[[int], Iterator] | None = None):
    """Run up to cfg.solver.max_iter steps with restart on divergence.

    `state` is a TrainState (or anything with `step` and `skipped` scalar
    tensors, `snapshot()` and `load_state_dict()`); `step_fn(state, batch)
    -> (state, metrics)`. Restart: if the skipped fraction since the last
    checkpoint reaches cfg.model.stabilize after at least half a checkpoint
    period, reload `model_recent` -- or the initial state when no
    checkpoint exists yet -- and rebuild the data stream with
    `data_iter_factory(attempt)`. `eval_fn(state) -> dict` runs every
    cfg.test.eval_period steps unless the current step diverged. Returns
    the final state. Refuses cfg.model.backbone.quant="int8" (SERVING-only).
    """
    if cfg.model.backbone.quant != "none":
        raise ValueError(SERVING_ONLY)
    solver = cfg.solver
    stabilize = cfg.model.stabilize
    attempts = 0
    period = max(solver.checkpoint_period, 1)
    eval_period = cfg.test.eval_period
    step = int(state.step)
    last_ckpt_step = step
    last_ckpt_skipped = int(state.skipped)
    # At most every 20 steps (bounded restart-detection delay), but never
    # sparser than the half-checkpoint-period gate that arms the check.
    stab_check_every = max(1, min(20, period // 2))
    # Host copy of the entry state: the restart target until the first
    # checkpoint lands.
    init_state = state.snapshot() if stabilize > 0 else None

    while step < solver.max_iter:
        t0 = time.time()
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        step += 1

        for hook in hooks or ():
            hook(step, state, metrics, batch=batch)

        since_ckpt = step - last_ckpt_step
        check_stab = (stabilize > 0 and since_ckpt >= period // 2
                      and step % stab_check_every == 0)
        skipped_since = (int(state.skipped) - last_ckpt_skipped
                         if check_stab else 0)
        if check_stab and skipped_since / max(since_ckpt, 1) >= stabilize:
            attempts += 1
            logger.warning(
                "divergence: %d/%d skipped since last ckpt; restart %d/%d",
                skipped_since, since_ckpt, attempts,
                solver.max_training_attempts)
            if attempts >= solver.max_training_attempts:
                raise RuntimeError("exceeded max training attempts")
            if checkpointer is not None and checkpointer.has():
                state = checkpointer.load(state)
            elif init_state is not None:
                state.load_state_dict(init_state)
            if data_iter_factory is not None:
                data_iter = data_iter_factory(attempts)
            step = int(state.step)
            last_ckpt_step = step
            last_ckpt_skipped = int(state.skipped)
            continue

        def diverged_now() -> bool:
            # The current step's skip flag, read only at the sparse
            # eval / checkpoint steps.
            return stabilize > 0 and float(metrics.get("skipped", 0.0)) > 0

        if (eval_fn is not None and eval_period > 0
                and step % eval_period == 0 and not diverged_now()):
            results = eval_fn(state)
            logger.info("in-train eval @ iter %d: %s", step,
                        {k: round(float(v), 2) for k, v in results.items()
                         if isinstance(v, (int, float))})

        if checkpointer is not None and step % period == 0:
            # No periodic save when the current step diverged or the skip
            # fraction since the last checkpoint reached 0.5 * STABILIZE: a
            # restart must not reload a poisoned checkpoint.
            skipped_now = int(state.skipped) if stabilize > 0 else 0
            frac = ((skipped_now - last_ckpt_skipped)
                    / max(step - last_ckpt_step, 1))
            if not diverged_now() and (stabilize <= 0
                                       or frac < 0.5 * stabilize):
                checkpointer.save(state)
                last_ckpt_step = step
                last_ckpt_skipped = skipped_now

        if step % 20 == 0:
            logger.info("iter %d loss %.4f (%.3fs/it)", step,
                        float(metrics["total_loss"]), time.time() - t0)

    if checkpointer is not None:
        checkpointer.save(state, name="model_final")
    for hook in hooks or ():
        if hasattr(hook, "close"):
            hook.close()
    return state
