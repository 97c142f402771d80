"""Train and eval steps with in-graph stabilisation (counterpart of
ovmono3d_tpu/parallel/train_step.py).

The reference skips the optimizer step when the batch loss explodes (above
TOLERANCE times its rolling mean) or any gradient is non-finite
(train_net.py:187-292). Here, as in the JAX package, that decision is a
device-side tensor: the step never waits for the host. On a skip the
parameters and the optimizer state (its count included) stay as they were,
the rolling mean is frozen and `skipped` counts one more. The rolling mean
starts at the sentinel -1 and is set to twice the first finite loss.

One process, one card: data parallelism across cards (DDP) is queued.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ovmono3d_tpu_torch.models.rcnn3d import RCNN3D
from ovmono3d_tpu_torch.ops.quant import refuse_quantized
from ovmono3d_tpu_torch.structures import GroundTruth
from ovmono3d_tpu_torch.train.optim import Optimizer

TOLERANCE = 4.0  # loss-spike multiplier (train_net.py:178-250)
GAMMA = 0.02     # rolling-average gain (train_net.py:189, ~50-step window)


@dataclass
class TrainState:
    """What a training run carries from step to step, on the card. The
    model's parameters and the optimizer's buffers are updated in place."""

    model: RCNN3D
    optimizer: Optimizer
    step: torch.Tensor          # int64 scalar: train_step calls so far
    loss_ema: torch.Tensor      # f32 scalar: rolling mean of the total loss
    skipped: torch.Tensor       # int32 scalar: skipped updates so far
    generator: torch.Generator  # the sampling draws

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "loss_ema": self.loss_ema,
                "skipped": self.skipped,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            self.model.load_state_dict(sd["model"])
            self.optimizer.load_state_dict(sd["optimizer"])
            for key in ("step", "loss_ema", "skipped"):
                getattr(self, key).copy_(sd[key])
        self.generator.set_state(sd["generator"])

    def snapshot(self) -> dict:
        """A host copy of the whole state, for `load_state_dict`."""
        def host(x):
            if isinstance(x, dict):
                return {k: host(v) for k, v in x.items()}
            return x.detach().to("cpu", copy=True)
        return host(self.state_dict())


def create_train_state(model: RCNN3D, optimizer: Optimizer,
                       seed: int = 0) -> TrainState:
    """A fresh state on the optimizer's (the model's) device; the sampling
    generator is seeded with `seed`. Refuses a model built with
    quant="int8" (SERVING-only)."""
    refuse_quantized(model)
    dev = optimizer.device
    return TrainState(
        model=model, optimizer=optimizer,
        step=torch.zeros((), dtype=torch.int64, device=dev),
        loss_ema=torch.full((), -1.0, device=dev),
        skipped=torch.zeros((), dtype=torch.int32, device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed))


def _all_finite(grads: list[torch.Tensor]) -> torch.Tensor:
    """One device-side flag: every element of every gradient is finite.
    0 * x is 0 for finite x and NaN for inf or NaN, so the norms of the
    zeroed gradients sum to 0 exactly when all are finite."""
    zeroed = torch._foreach_mul(grads, 0.0)
    return torch.stack(torch._foreach_norm(zeroed)).sum() == 0


def make_train_step(model: RCNN3D, optimizer: Optimizer,
                    stabilize: float = 0.01):
    """Returns train_step(state, batch) -> (state, metrics).

    `batch` holds image, K, im_hw, im_scale_ratio, gt_boxes, gt_classes,
    gt_boxes3d, gt_poses, gt_valid and optionally depth and draws (the
    sampling uniforms, see RCNN3D.compute_losses; else they come from
    state.generator). Runs on the model's device. Frozen parameters
    (requires_grad False) get no gradient and no update, like the JAX package's
    trainable_mask. `metrics` are device tensors: the losses, total_loss
    and skipped (1.0 on a skipped step). Refuses a model built with
    quant="int8" (SERVING-only).
    """
    refuse_quantized(model)

    def train_step(state: TrainState, batch: dict):
        gt = GroundTruth(boxes=batch["gt_boxes"], classes=batch["gt_classes"],
                         boxes3d=batch["gt_boxes3d"], poses=batch["gt_poses"],
                         valid=batch["gt_valid"])
        losses = model.compute_losses(
            batch["image"], batch["K"], batch["im_hw"],
            batch["im_scale_ratio"], gt, generator=state.generator,
            draws=batch.get("draws"), depth=batch.get("depth"))
        total = sum(losses.values())
        grads = torch.autograd.grad(total, optimizer.params,
                                    allow_unused=True)

        with torch.no_grad():
            loss_finite = torch.isfinite(total)
            safe_total = torch.where(loss_finite, total,
                                     torch.zeros_like(total))
            # The rolling mean starts at 2x the first FINITE loss; a
            # non-finite first loss keeps the -1 sentinel (else every later
            # step would trip total > 4 * 0 and training would skip forever).
            ema = torch.where((state.loss_ema < 0) & loss_finite,
                              2.0 * safe_total, state.loss_ema)
            skip = (~_all_finite([g for g in grads if g is not None])
                    | ~loss_finite)
            if stabilize > 0:
                skip = skip | ((ema > 0) & (total > TOLERANCE * ema))
            optimizer.step(grads, skip)
            state.loss_ema.copy_(torch.where(
                skip, ema, ema * (1.0 - GAMMA) + safe_total * GAMMA))
            state.step.add_(1)
            state.skipped.add_(skip.to(state.skipped.dtype))
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["skipped"] = skip.float()
        return state, metrics

    return train_step


def make_eval_step(model: RCNN3D):
    """Oracle-mode eval step (the reference's evaluation protocol):
    eval_step(batch) -> Detections, without autograd."""

    def eval_step(batch: dict):
        with torch.inference_mode():
            return model(batch["image"], batch["K"], batch["im_hw"],
                         batch["im_scale_ratio"], batch.get("depth"),
                         oracle_boxes=batch["oracle_boxes"],
                         oracle_classes=batch["oracle_classes"],
                         oracle_scores=batch["oracle_scores"],
                         oracle_valid=batch["oracle_valid"])

    return eval_step
