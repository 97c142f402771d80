"""Optimizer: per-parameter LR / weight-decay groups, the warmup-multistep
schedule, gradient clipping, trunk freezing and gradient accumulation
(`with_grad_accum`, optax.MultiSteps' semantics) (counterpart of
ovmono3d_tpu/train/optim.py, which builds one optax chain).

The update is written out here rather than taken from torch.optim, for two
reasons: it reproduces optax's arithmetic (the adam variants' bias
corrections, optax's amsgrad, the SGD trace), and the train step's skip is a
device-side decision: on a skipped step the parameters and every optimizer
buffer, the step count included, stay exactly as they were, with no host
synchronisation. torch.optim's SGD would decay its momentum on a zeroed
gradient.

On the card, kind "sgd" takes the multi-tensor kernel (ops/optim_kernels.py:
every leaf in one launch, the same arithmetic bit for bit) and refuses a
leaf the kernel cannot take; the adam kinds, and every optimizer on the
CPU, run the per-leaf update below (`optim_kernels.use_multi_tensor`).

Groups (detectron2 / reference solver/build.py:20-46): "norm" parameters
(LayerNorm weights and biases, and anything under a module whose name
contains a norm keyword) take weight_decay_norm; other biases take
weight_decay_bias (default: weight_decay) and base_lr * bias_lr_factor;
the rest take weight_decay. LayerScale `gamma` is not a norm parameter.

What trains: every parameter with requires_grad, and every buffer with it
(`trainable`): an unfrozen CNN trunk's BatchNorm statistics, which the JAX
train step differentiates and updates like parameters (its whole variables
tree is the optimizer's; models/rcnn3d.py `freeze_trunk`). They fall in the
"norm" group.
"""
from __future__ import annotations

import torch
from torch import nn

from ovmono3d_tpu_torch.config import SolverConfig
from ovmono3d_tpu_torch.models.layers import FrozenBatchNorm2d
from ovmono3d_tpu_torch.models.vit import LayerNormBf16Out
from ovmono3d_tpu_torch.ops import optim_kernels

NORM_KEYWORDS = ("norm", "layernorm", "ln", "bn")
KINDS = ("sgd", "adam", "adamw", "adam+amsgrad", "adamw+amsgrad")
GROUPS = ("default", "bias", "norm")
B1, B2 = 0.9, 0.999                 # optax's adam / amsgrad defaults


def warmup_multistep(base_lr: float, steps: tuple[int, ...], gamma: float,
                     warmup_iters: int, warmup_factor: float):
    """detectron2 WarmupMultiStepLR as a function of the update count (an
    integer tensor) -> f32 learning-rate tensor on the count's device:
    linear warmup from warmup_factor, then a factor gamma at each step."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warmup = torch.where(
            count < warmup_iters,
            warmup_factor + (1 - warmup_factor) * c / max(warmup_iters, 1),
            torch.ones_like(c))
        if steps:
            n = sum((count >= s).float() for s in steps)
            decay = torch.pow(torch.full_like(c, gamma), n)
        else:
            decay = 1.0
        return base_lr * warmup * decay

    return schedule


def _is_norm_or_bias(name: str, module: nn.Module) -> tuple[bool, bool]:
    """(is_norm, is_bias) for parameter `name` of `module`, by the JAX
    package's rule on the flax path: the module path holds a norm keyword,
    or the leaf is a LayerNorm's scale (its torch `weight`)."""
    keys = name.lower().split(".")
    is_bias = keys[-1] == "bias"
    is_norm = any(kw in k for k in keys[:-1] for kw in NORM_KEYWORDS) or (
        keys[-1] == "weight"
        and isinstance(module, (nn.LayerNorm, LayerNormBf16Out,
                                FrozenBatchNorm2d)))
    return is_norm, is_bias


def trainable(model: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of what an update changes: the parameters, then the
    buffers, that require grad."""
    return [(n, t) for n, t in (*model.named_parameters(),
                                *model.named_buffers()) if t.requires_grad]


def param_group_labels(model: nn.Module) -> dict[str, str]:
    """{parameter name: "default" | "bias" | "norm"}, and the same for the
    trainable buffers."""
    labels = {}
    names = [n for n, _ in model.named_parameters()]
    names += [n for n, b in model.named_buffers() if b.requires_grad]
    for name in names:
        mod = model.get_submodule(name.rpartition(".")[0])
        is_norm, is_bias = _is_norm_or_bias(name, mod)
        labels[name] = "norm" if is_norm else "bias" if is_bias else "default"
    return labels


def freeze_backbone_mask(model: nn.Module) -> dict[str, bool]:
    """{parameter name: trainable}. The backbone's trunk is frozen, its
    pyramid (sfp / fpn) and every head stay trainable (reference
    train_net.py:431-434 freezes backbone.net)."""
    mask = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        in_trunk = (len(keys) > 2 and keys[0] == "backbone"
                    and keys[1] not in ("sfp", "fpn"))
        mask[name] = not in_trunk
    return mask


def clip_gradients(grads: list[torch.Tensor],
                   max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm reaches max_norm."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    return [torch.where(norm < max_norm, g, (g / norm) * max_norm)
            for g in grads]


class Optimizer:
    """sgd | adam | adamw | adam+amsgrad | adamw+amsgrad over the trainable
    (requires_grad) parameters and buffers of `model`, with the groups, the
    schedule and optional global-norm clipping of `cfg`.

    Adam variants use coupled L2 decay (added to the gradient before the
    moments, torch.optim.Adam semantics); AdamW variants decoupled decay
    (added to the normalised update, scaled by the LR). All keep optax's
    arithmetic, eps = cfg.adam_eps. Buffers live beside the parameters, on
    the model's device (build_model puts it on the card unless asked for
    the CPU).
    """

    def __init__(self, cfg: SolverConfig, model: nn.Module):
        if cfg.type not in KINDS:
            raise ValueError(f"solver type {cfg.type!r}; expected one of "
                             f"{KINDS}")
        self.kind = cfg.type
        self.momentum = cfg.momentum
        self.eps = cfg.adam_eps
        self.clip = cfg.clip_gradients
        labels = param_group_labels(model)
        self.names = [n for n, _ in trainable(model)]
        self.params = [t for _, t in trainable(model)]
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise ValueError(f"trainable parameters on {devices}; expected "
                             "one device")
        (self.device,) = devices
        self.labels = [labels[n] for n in self.names]

        wd_bias = (cfg.weight_decay if cfg.weight_decay_bias is None
                   else cfg.weight_decay_bias)
        factors = {"default": 1.0, "bias": cfg.bias_lr_factor, "norm": 1.0}
        wds = {"default": cfg.weight_decay, "bias": wd_bias,
               "norm": cfg.weight_decay_norm}
        # Every group's schedule in one [3] tensor, GROUPS' order; each
        # group's own is its entry.
        self._lrs = warmup_multistep(
            torch.tensor([cfg.base_lr * factors[g] for g in GROUPS],
                         dtype=torch.float32, device=self.device),
            cfg.steps, cfg.gamma, cfg.warmup_iters, cfg.warmup_factor)
        lrs = self._lrs
        self.groups = {g: ((lambda count, i=i: lrs(count)[i]), wds[g])
                       for i, g in enumerate(GROUPS)}
        # Updates applied so far (optax's count; a skipped step leaves it).
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        buffers = (("trace",) if self.kind == "sgd" else
                   ("mu", "nu", "nu_max") if self.kind.endswith("amsgrad")
                   else ("mu", "nu"))
        self.state = {b: [torch.zeros_like(p) for p in self.params]
                      for b in buffers}
        # The multi-tensor kernel's tables, or None (the per-leaf update).
        self.kernel = None
        if optim_kernels.use_multi_tensor(self.kind, self.params, self.names):
            self.kernel = optim_kernels.MultiTensorSGD(
                self.params, self.state["trace"],
                [GROUPS.index(g) for g in self.labels],
                [wds[g] for g in self.labels])

    def lr(self, label: str) -> torch.Tensor:
        """The learning rate of a group at the current count."""
        return self.groups[label][0](self.count)

    def all_finite(self, grads: list[torch.Tensor | None]) -> torch.Tensor:
        """A device bool: no element of `grads` (one per trainable leaf,
        None for an unused one) is an inf or a NaN. The kernel's one pass
        where the update takes it; else 0 * g is 0 for finite g and NaN
        otherwise, so the norms of the zeroed gradients sum to 0 exactly
        when all are finite."""
        if self.kernel is not None:
            return optim_kernels.all_finite(self.kernel, grads)
        zeroed = torch._foreach_mul([g for g in grads if g is not None], 0.0)
        return torch.stack(torch._foreach_norm(zeroed)).sum() == 0

    def _updates(self, grads: list[torch.Tensor], new: dict) -> list:
        """The steps to add to the parameters (optax's updates), writing
        the new buffers into `new`."""
        count1 = (self.count + 1).float()
        neg = -self._lrs(self.count)
        lrs = {label: neg[i] for i, label in enumerate(GROUPS)}
        out = []
        for i, (p, g, label) in enumerate(zip(self.params, grads,
                                              self.labels)):
            wd = self.groups[label][1]
            if self.kind == "sgd":
                u = g + wd * p if wd else g
                trace = u + self.momentum * self.state["trace"][i]
                new["trace"].append(trace)
                out.append(trace * lrs[label])
                continue
            decoupled = self.kind.startswith("adamw")
            u = g + wd * p if (wd and not decoupled) else g
            mu = (1 - B1) * u + B1 * self.state["mu"][i]
            nu = (1 - B2) * (u * u) + B2 * self.state["nu"][i]
            new["mu"].append(mu)
            new["nu"].append(nu)
            mu_hat = mu / (1 - B1 ** count1)
            nu_hat = nu / (1 - B2 ** count1)
            if self.kind.endswith("amsgrad"):
                nu_hat = torch.maximum(self.state["nu_max"][i], nu_hat)
                new["nu_max"].append(nu_hat)
            step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if decoupled:
                step = step + wd * p
            out.append(step * lrs[label])
        return out

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor | None],
             skip: torch.Tensor | None = None) -> None:
        """Apply one update from `grads` (one per trainable parameter, None
        for an unused one). With `skip` (a bool tensor) true, nothing
        changes: the gradients are replaced by zeros for the arithmetic, as
        in the JAX step, and every parameter and buffer keeps its value."""
        if skip is None:
            skip = torch.zeros((), dtype=torch.bool, device=self.device)
        if self.kernel is not None:
            if self.clip > 0:
                grads = clip_gradients(
                    [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self.params, grads)], self.clip)
            optim_kernels.sgd_update(self.kernel, grads,
                                     self._lrs(self.count), skip,
                                     self.momentum)
            self.count.add_((~skip).to(self.count.dtype))
            return
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        grads = [torch.where(skip, torch.zeros_like(g), g) for g in grads]
        if self.clip > 0:
            grads = clip_gradients(grads, self.clip)
        new = {b: [] for b in self.state}
        updates = self._updates(grads, new)
        for p, u in zip(self.params, updates):
            p.copy_(torch.where(skip, p, p + u))
        for b, bufs in self.state.items():
            for old, nb in zip(bufs, new[b]):
                old.copy_(torch.where(skip, old, nb))
        self.count.add_((~skip).to(self.count.dtype))

    def state_dict(self) -> dict:
        return {"count": self.count,
                "state": {b: dict(zip(self.names, bufs))
                          for b, bufs in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            self.count.copy_(sd["count"])
            for b, bufs in self.state.items():
                for name, buf in zip(self.names, bufs):
                    buf.copy_(sd["state"][b][name])



class GradAccum:
    """`optax.MultiSteps` over an `Optimizer`: k micro-steps an update.

    Each micro-step folds its gradient into a running mean (optax's Welford
    form, acc += (g - acc) / (n + 1)); the k-th applies the inner optimizer
    to that mean and clears it. So the inner count, and with it the LR
    schedule, advances once every k micro-steps, and the first k - 1 change
    no parameter. A skipped micro-step (`skip` true) leaves the
    accumulator, the micro-count and the inner optimizer as they were, so a
    poisoned gradient never enters the mean. The accumulator and the
    micro-count are in `state_dict`, so a checkpoint taken mid-accumulation
    resumes exactly. Everything stays on the device: no host
    synchronisation.
    """

    def __init__(self, inner: Optimizer, k: int):
        self.inner = inner
        self.k = k
        self.names, self.params, self.device = (inner.names, inner.params,
                                                inner.device)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = torch.zeros((), dtype=torch.int32, device=self.device)

    @property
    def count(self) -> torch.Tensor:
        """The inner optimizer's count of applied updates."""
        return self.inner.count

    def lr(self, label: str) -> torch.Tensor:
        return self.inner.lr(label)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor | None],
             skip: torch.Tensor | None = None) -> None:
        """One micro-step; `grads` and `skip` as `Optimizer.step`."""
        if skip is None:
            skip = torch.zeros((), dtype=torch.bool, device=self.device)
        n = self.mini_step
        mean = []
        for acc, p, g in zip(self.acc, self.params, grads):
            g = torch.zeros_like(p) if g is None else g
            g = torch.where(skip, torch.zeros_like(g), g)
            mean.append(acc + (g - acc) / (n + 1))
        emit = (n == self.k - 1) & ~skip
        self.inner.step(mean, skip=~emit)
        for acc, m in zip(self.acc, mean):
            acc.copy_(torch.where(skip, acc,
                                  torch.where(emit, torch.zeros_like(m), m)))
        self.mini_step.copy_(torch.where(skip, n, (n + 1) % self.k))

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": dict(zip(self.names, self.acc))}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        with torch.no_grad():
            self.mini_step.copy_(sd["mini_step"])
            for name, acc in zip(self.names, self.acc):
                acc.copy_(sd["acc"][name])


def with_grad_accum(optimizer: Optimizer, k: int):
    """`optimizer` accumulating gradients over k micro-steps per update
    (solver.grad_accum_steps; the JAX package's optax.MultiSteps wrapper):
    k micro-batches of n reproduce one update on a batch of k * n. The
    optimizer itself for k = 1."""
    if k < 1:
        raise ValueError(f"grad_accum_steps={k}; expected >= 1")
    return optimizer if k == 1 else GradAccum(optimizer, k)
