"""Train and eval steps with in-graph stabilisation (counterpart of
ovmono3d_tpu/parallel/train_step.py).

The reference skips the optimizer step when the batch loss explodes (above
TOLERANCE times its rolling mean) or any gradient is non-finite
(train_net.py:187-292). Here, as in the JAX package, that decision is a
device-side tensor: the step never waits for the host. On a skip the
parameters and the optimizer state (its count included) stay as they were,
the rolling mean is frozen and `skipped` counts one more. The rolling mean
starts at the sentinel -1 and is set to twice the first finite loss.

Data parallelism: with a torch.distributed process group up, each process
runs its share of the batch and the step sums the gradients, the total
loss and each loss over the group in one flat `all_reduce`, before the
finiteness flag and the skip decision, so every process takes the same
update and the same skip (two processes that disagreed on a skip would
drift apart silently). The losses' normalizers are counted over the whole
batch (`compute_losses`' count reduction), so each process's loss is its
share of the global batch's loss, and the summed gradients are the global
batch's gradient, as in the JAX package's one program over a sharded batch
(averaging per-process losses over local counts, as detectron2's DDP does,
is another result). `DistributedDataParallel` is not used: its reducer
hooks do not fire under `torch.autograd.grad`. Without a group the step
makes no collective call.

Tensor parallelism: given `groups` (parallel/mesh.py `make_groups`) the
sums run over the data group alone, and the model (tensor_parallel.py
`apply_tp` over groups.model) holds its shards. The processes of a model
group compute the same loss on the same share, so they must draw the same
samples (seed the state's generator by the data rank, or pass the draws);
their shards' gradients differ, so the skip flag is also reduced over the
model group (a max), and every process takes the same decision. Global-norm
clipping over shards is not implemented and is refused.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ovmono3d_tpu_torch.models.rcnn3d import RCNN3D
from ovmono3d_tpu_torch.ops.quant import refuse_quantized
from ovmono3d_tpu_torch.structures import GroundTruth
from ovmono3d_tpu_torch.train.optim import Optimizer
from ovmono3d_tpu_torch.utils.trace import span

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


def _sum_over_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """A count summed over the process group (the whole group when None),
    outside autograd."""
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_reduce_flat(tensors: list[torch.Tensor],
                     group=None) -> list[torch.Tensor]:
    """Sum `tensors` over the process group with one all_reduce of a flat
    buffer; returns views of the summed buffer shaped as the inputs."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(model: RCNN3D, optimizer: Optimizer,
                    stabilize: float = 0.01, groups=None):
    """Returns train_step(state, batch) -> (state, metrics).

    `batch` holds image, K, im_hw, im_scale_ratio, gt_boxes, gt_classes,
    gt_boxes3d, gt_poses, gt_valid and optionally depth and draws (the
    sampling uniforms, see RCNN3D.compute_losses; else they come from
    state.generator). Runs on the model's device. Frozen parameters
    (requires_grad False) get no gradient and no update, like the JAX package's
    trainable_mask. `metrics` are device tensors: the losses, total_loss
    and skipped (1.0 on a skipped step); under a process group the losses
    are the global batch's. `optimizer` may be `with_grad_accum`'s wrapper.
    `groups`: the data x model groups of a tensor-parallel run (the sums go
    over groups.data). Each call is a unit span, train.step, holding the
    model's spans, train.backward and train.optimizer (with
    train.all_reduce under a process group). Refuses a model built with
    quant="int8" (SERVING-only).
    """
    refuse_quantized(model)
    grouped = dist.is_available() and dist.is_initialized()
    data_group = groups.data if groups is not None else None
    model_group = (groups.model if groups is not None and groups.n_model > 1
                   else None)
    inner = getattr(optimizer, "inner", optimizer)      # GradAccum's
    if model_group is not None and inner.clip > 0:
        raise NotImplementedError("global-norm clipping of tensor-parallel "
                                  "shards")

    def count_reduce(x):
        return _sum_over_group(x, data_group)

    def train_step(state: TrainState, batch: dict):
        with span("train.step", unit=True):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: dict):
        gt = GroundTruth(boxes=batch["gt_boxes"], classes=batch["gt_classes"],
                         boxes3d=batch["gt_boxes3d"], poses=batch["gt_poses"],
                         valid=batch["gt_valid"])
        losses = model.compute_losses(
            batch["image"], batch["K"], batch["im_hw"],
            batch["im_scale_ratio"], gt, generator=state.generator,
            draws=batch.get("draws"), depth=batch.get("depth"),
            count_reduce=count_reduce if grouped else None)
        total = sum(losses.values())
        with span("train.backward"):
            grads = torch.autograd.grad(total, optimizer.params,
                                        allow_unused=True)
        with span("train.optimizer"):
            if grouped:
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(optimizer.params, grads)]
                names = list(losses)
                with span("train.all_reduce"):
                    summed = _all_reduce_flat(
                        grads + [total.detach()]
                        + [losses[k].detach() for k in names], data_group)
                grads = summed[:len(grads)]
                total = summed[len(grads)]
                losses = dict(zip(names, summed[len(grads) + 1:]))
            with torch.no_grad():
                loss_finite = torch.isfinite(total)
                safe_total = torch.where(loss_finite, total,
                                         torch.zeros_like(total))
                # The rolling mean starts at 2x the first FINITE loss; a
                # non-finite first loss keeps the -1 sentinel (else every
                # later step would trip total > 4 * 0 and training would
                # skip forever).
                ema = torch.where((state.loss_ema < 0) & loss_finite,
                                  2.0 * safe_total, state.loss_ema)
                skip = (~_all_finite([g for g in grads if g is not None])
                        | ~loss_finite)
                if stabilize > 0:
                    skip = skip | ((ema > 0) & (total > TOLERANCE * ema))
                if model_group is not None:
                    flag = skip.float()
                    with span("train.all_reduce"):
                        dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                                        group=model_group)
                    skip = flag > 0
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
