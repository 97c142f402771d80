"""flax-style dense layers and convolutions on channels-last (NHWC) maps, and
flax's default initializers, shared by the port's models.

`Dense` is flax's `nn.Dense` (and the JAX package's `QDense` with
quant="none"): f32 parameters, the product in its `dtype`; ops/quant.py's
`QDense` adds the int8 serving path on top of it.

`Conv` and `ConvTranspose` keep f32 parameters in PyTorch's layouts (OIHW,
IOHW) and compute in their `dtype`, as flax's `nn.Conv(dtype=...)` does. A
conv sees the NCHW view of an NHWC tensor, which is PyTorch's channels_last
layout, so no copies are made. `ConvTranspose` is the kernel-2, stride-2
upsampling of the feature pyramid, SAM's mask decoder and Depth-Pro; the
bridge flips the flax kernel into it (utils/flax_bridge.py). `conv_norm_pair`
is the 1x1 conv -> LayerNorm -> 3x3 conv -> LayerNorm of SAM's neck and of
every pyramid level. `LayerNorm` and `GroupNorm` are flax's with
`dtype=float32`: f32 statistics and output whatever the input's dtype.
`FrozenBatchNorm2d` is flax's `nn.BatchNorm(use_running_average=True)` over
the CNN trunks' NCHW maps, the only way the JAX package runs its BatchNorms.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_TRUNC = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax lecun_normal: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """Linear with f32 parameters, computed in `dtype` (flax Dense/QDense
    with quant="none")."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.bfloat16,
                 bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)

    def init_lecun(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Conv(nn.Conv2d):
    """flax nn.Conv over [B, H, W, C] with explicit symmetric padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax nn.ConvTranspose with a 2x2 kernel and stride 2 over
    [B, H, W, C] -> [B, 2H, 2W, C']."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_channels, out_channels, 2, stride=2, bias=bias,
                         device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype), b, stride=2)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(dtype=float32): the input in f32, f32 out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm over [B, C, H, W] maps with its running statistics, in f32,
    in training too: flax's nn.BatchNorm(use_running_average=True), which is
    how every BatchNorm of the JAX package's CNN trunks runs (no caller
    passes train=True). The affine `weight` (flax's scale) and `bias` are
    parameters; `running_mean` and `running_var` (flax's batch_stats mean
    and var) are buffers that `train()` neither switches to batch
    statistics nor updates. y = (x - mean) * (rsqrt(var + eps) * weight) +
    bias, flax's order of operations."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.empty(num_features, device=device))
        self.register_buffer("running_var",
                             torch.empty(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean[:, None, None])
                * mul[:, None, None] + self.bias[:, None, None])

    def init_weights(self) -> None:
        """flax's: scale 1, bias 0, mean 0, var 1."""
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm over [B, H, W, C] maps, in f32. Written out: a
    group of one value (a 1x1 map) is normalized to the bias, as in flax,
    where F.group_norm refuses it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = x.float().reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


def conv_norm_pair(x: torch.Tensor, conv1: nn.Conv2d, norm1: nn.LayerNorm,
                   conv2: nn.Conv2d, norm2: nn.LayerNorm,
                   dtype: torch.dtype) -> torch.Tensor:
    """[B, H, W, C] -> 1x1 conv -> LayerNorm -> 3x3 conv (padding 1) ->
    LayerNorm: the convs without bias in `dtype`, the norms in f32 (output
    f32)."""
    w1 = conv1.weight[:, :, 0, 0].to(dtype)
    x = norm1(F.linear(x.to(dtype), w1).float())
    x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv2.weight.to(dtype),
                 padding=1)
    return norm2(x.permute(0, 2, 3, 1).float())


def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers over every Linear, conv, LayerNorm,
    GroupNorm and FrozenBatchNorm2d of `module`: lecun-normal kernels
    (fan-in over kh * kw * in / groups), zero biases, unit scales, and the
    BatchNorms' mean 0 and var 1."""
    for mod in module.modules():
        if isinstance(mod, FrozenBatchNorm2d):
            mod.init_weights()
            continue
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, mod.in_features, generator)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = mod.kernel_size
            lecun_normal_(mod.weight, mod.in_channels // mod.groups * kh * kw,
                          generator)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(mod.weight)
        else:
            continue
        if mod.bias is not None:
            nn.init.zeros_(mod.bias)


def init_seeded(model: nn.Module, seed: int) -> nn.Module:
    """`model` (built on the meta device, with an `init_weights(generator)`)
    materialized on the CPU and filled from torch.Generator(seed), so a
    seed gives the same weights whatever device the model moves to. Raises
    if a parameter or buffer (the BatchNorms' statistics) is left unset."""
    model = model.to_empty(device="cpu")
    tensors = [*model.named_parameters(), *model.named_buffers()]
    with torch.no_grad():
        for _, t in tensors:
            t.fill_(float("nan"))
        model.init_weights(torch.Generator().manual_seed(seed))
        unset = [name for name, t in tensors if torch.isnan(t).any()]
    if unset:
        raise RuntimeError(f"parameters left uninitialized: {unset}")
    return model
