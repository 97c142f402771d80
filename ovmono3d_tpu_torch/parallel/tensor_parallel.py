"""Megatron tensor parallelism over the `model` process group (counterpart
of ovmono3d_tpu/parallel/sharding_rules.py).

The rule is the JAX package's: a linear layer named `fc1` or `qkv` is
column-parallel (its output features, and its bias, split over the group),
one named `fc2` or `proj` row-parallel (its input features split, its bias
whole), matched by module name wherever the model has one; a layer whose
split dimension does not divide by the group's size stays whole. On the
flagship and the tiny configurations that is every ViT block's qkv, proj,
fc1 and fc2 and the box head's fc1 and fc2 (`sharded_leaves`).

GSPMD inserts the collectives for the JAX package; here they are explicit
(Megatron-LM's pair of autograd functions). A column-parallel layer's input
goes through `f` (identity forward, all-reduce of the gradient backward);
a row-parallel layer's partial product through `g` (all-reduce forward,
identity backward), then its bias. Siblings (qkv, proj) and (fc1, fc2) of
one module are pairs: the module's own forward carries the shard from one
to the other through per-head attention or an elementwise activation. A
layer whose sibling would not be split is refused (every shipped
configuration's box head has its fc1 and fc2).

The JAX kernel's columns split contiguously, which GSPMD reshards around
the attention; eager PyTorch needs whole heads on a rank, so a qkv (whose
parent module has `num_heads`) splits by head within each of its q, k and v
thirds
(rank r holds heads [r H / n, (r + 1) H / n) of each), and the partner proj
takes those heads' input features. The arithmetic is the same; the layout
is the port's. Such a qkv needs num_heads divisible by the group's size.

`apply_tp` slices the parameters in place (the Parameter objects stay, so
build the optimizer after it) and sets each sharded layer's forward.
Collectives run in f32. A sharded model's state_dict holds each rank's
shards.
"""
from __future__ import annotations

import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

COL_PARALLEL = ("fc1", "qkv")      # output features split
ROW_PARALLEL = ("fc2", "proj")     # input features split
PAIRS = {"qkv": "proj", "fc1": "fc2"}
PARTNER = {**PAIRS, **{row: col for col, row in PAIRS.items()}}


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sharded_leaves(model: nn.Module, n: int) -> dict[str, int]:
    """{parameter name: the torch axis split over a group of n}: the JAX
    rule's leaves (a flax kernel's output axis is the torch weight's 0)."""
    if n == 1:
        return {}
    out = {}
    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if not isinstance(mod, nn.Linear):
            continue
        if leaf in COL_PARALLEL and mod.out_features % n == 0:
            out[f"{name}.weight"] = 0
            if mod.bias is not None:
                out[f"{name}.bias"] = 0
        elif leaf in ROW_PARALLEL and mod.in_features % n == 0:
            out[f"{name}.weight"] = 1
    return out


def _dtype(mod: nn.Linear) -> torch.dtype | None:
    """The compute dtype of the port's Dense (None: the input's, as
    nn.Linear)."""
    return getattr(mod, "dtype", None)


def _col_forward(self, x: torch.Tensor) -> torch.Tensor:
    x = _CopyToGroup.apply(x, self.tp_group)
    dt = _dtype(self) or x.dtype
    b = None if self.bias is None else self.bias.to(dt)
    return F.linear(x.to(dt), self.weight.to(dt), b)


def _row_forward(self, x: torch.Tensor) -> torch.Tensor:
    dt = _dtype(self) or x.dtype
    y = _ReduceFromGroup.apply(F.linear(x.to(dt), self.weight.to(dt)),
                               self.tp_group)
    return y if self.bias is None else y + self.bias.to(dt)


def _shard_rows(mod: nn.Linear, parent: nn.Module, leaf: str, n: int,
                r: int) -> torch.Tensor:
    """The global output features of a column-parallel layer that rank r
    holds: whole heads of each of its thirds for a qkv (under a module with
    `num_heads`), else a contiguous block."""
    size = mod.out_features // n
    if leaf != "qkv":
        return torch.arange(r * size, (r + 1) * size)
    heads = getattr(parent, "num_heads", None)
    if heads is None:
        raise ValueError("a qkv layer under a module without num_heads")
    if heads % n:
        raise ValueError(f"{heads} heads do not split over {n} ranks: the "
                         "port splits qkv by head")
    dim = mod.out_features // 3
    return torch.cat([torch.arange(t * dim + r * dim // n,
                                   t * dim + (r + 1) * dim // n)
                      for t in range(3)])


def shard_plan(model: nn.Module, n: int, r: int) -> dict[str, tuple]:
    """What rank r of n holds, from the unsliced model: {layer name:
    ("col", the weight's rows and the bias's elements) or ("row", the
    weight's columns)}. Raises for a layer whose partner would not be
    split."""
    leaves = sharded_leaves(model, n)
    modules = dict(model.named_modules())
    plan = {}
    for name, mod in modules.items():
        if f"{name}.weight" not in leaves:
            continue
        if getattr(mod, "quant", "none") != "none":
            raise ValueError(f"{name}: tensor parallelism of an int8 serving "
                             "layer")
        parent_name, _, leaf = name.rpartition(".")
        parent = modules[parent_name]
        partner = f"{parent_name}.{PARTNER[leaf]}"
        if f"{partner}.weight" not in leaves:
            raise ValueError(f"{name} splits over {n} ranks but {partner} "
                             "does not")
        if leaf in COL_PARALLEL:
            plan[name] = ("col", _shard_rows(mod, parent, leaf, n, r))
        else:
            cols = _shard_rows(modules[partner], parent, PARTNER[leaf], n, r)
            if leaf == "proj":               # the q third: the heads' order
                cols = cols[:len(cols) // 3]
            plan[name] = ("row", cols)
    return plan


def apply_tp(model: nn.Module, group) -> dict[str, int]:
    """Shard `model` over the process group `group` (the model axis) in
    place; returns `sharded_leaves`. With a group of one nothing changes.
    Refuses a layer on the int8 serving path and a layer whose partner
    would not be split."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    leaves = sharded_leaves(model, n)
    plan = shard_plan(model, n, r)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, (kind, idx) in plan.items():
            mod = modules[name]
            mod.tp_group = group
            if kind == "col":
                mod.weight.data = mod.weight.data[idx].clone()
                if mod.bias is not None:
                    mod.bias.data = mod.bias.data[idx].clone()
                mod.out_features = len(idx)
                mod.forward = types.MethodType(_col_forward, mod)
            else:
                mod.weight.data = mod.weight.data[:, idx].clone()
                mod.in_features = len(idx)
                mod.forward = types.MethodType(_row_forward, mod)
    return leaves
