"""Simple Feature Pyramid over a ViT trunk, in PyTorch.

Counterpart of ovmono3d_tpu/models/sfp.py (detectron2's SimpleFeaturePyramid
as the reference uses it). From the trunk's [B, h, w, C] map, each scale
factor builds one level:

  2.0 -> ConvTranspose(C -> C/2, k2 s2)
  1.0 -> identity
  0.5 -> max-pool k2 s2
  4.0 -> ConvTranspose(C -> C/2) -> LN -> GELU -> ConvTranspose(-> C/4)

each followed by [conv 1x1 -> LN -> conv 3x3 -> LN] into `out_channels`.
Convs run in the compute dtype, LayerNorms in f32, outputs are f32. Maps stay
channels-last (NHWC); a conv sees the NCHW view of an NHWC tensor, which is
PyTorch's channels_last layout, so no copies are made.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.vit import lecun_normal_


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_transpose(conv: nn.ConvTranspose2d, x: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    y = F.conv_transpose2d(_nchw(x.to(dtype)), conv.weight.to(dtype),
                           conv.bias.to(dtype), stride=2)
    return _nhwc(y)


class _OutConvs(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.lateral = nn.Conv2d(in_channels, out_channels, 1, bias=False,
                                 device=device)
        self.lateral_norm = nn.LayerNorm(out_channels, eps=1e-6, device=device)
        self.output = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                                bias=False, device=device)
        self.output_norm = nn.LayerNorm(out_channels, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1 = self.lateral.weight[:, :, 0, 0].to(self.dtype)
        x = self.lateral_norm(F.linear(x.to(self.dtype), w1).float())
        x = F.conv2d(_nchw(x.to(self.dtype)), self.output.weight.to(self.dtype),
                     padding=1)
        return self.output_norm(_nhwc(x).float())


class SimpleFeaturePyramid(nn.Module):
    """Scale stages over one [B, h, w, C] trunk map -> {name: [B, H, W, out]}."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 scale_factors=(2.0, 1.0, 0.5), trunk_stride: int = 14,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        self.trunk_stride = trunk_stride
        self.dtype = dtype
        dim = in_channels
        for i, scale in enumerate(self.scale_factors):
            stage_in = dim
            if scale == 4.0:
                self.add_module(f"up4a_{i}", nn.ConvTranspose2d(
                    dim, dim // 2, 2, stride=2, device=device))
                self.add_module(f"up4_norm_{i}", nn.LayerNorm(
                    dim // 2, eps=1e-6, device=device))
                self.add_module(f"up4b_{i}", nn.ConvTranspose2d(
                    dim // 2, dim // 4, 2, stride=2, device=device))
                stage_in = dim // 4
            elif scale == 2.0:
                self.add_module(f"up2_{i}", nn.ConvTranspose2d(
                    dim, dim // 2, 2, stride=2, device=device))
                stage_in = dim // 2
            elif scale not in (1.0, 0.5):
                raise ValueError(f"unsupported scale {scale}")
            self.add_module(f"stage_{i}", _OutConvs(
                stage_in, out_channels, dtype, device))

    @property
    def strides(self) -> list[int]:
        return [round(self.trunk_stride / s) for s in self.scale_factors]

    @property
    def feature_names(self) -> list[str]:
        return [f"p{int(math.log2(s))}" for s in self.strides]

    def forward(self, feat: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for i, scale in enumerate(self.scale_factors):
            x = feat
            if scale == 4.0:
                x = _conv_transpose(getattr(self, f"up4a_{i}"), x, self.dtype)
                x = getattr(self, f"up4_norm_{i}")(x.float())
                x = F.gelu(x)
                x = _conv_transpose(getattr(self, f"up4b_{i}"), x, self.dtype)
            elif scale == 2.0:
                x = _conv_transpose(getattr(self, f"up2_{i}"), x, self.dtype)
            elif scale == 0.5:
                x = _nhwc(F.max_pool2d(_nchw(x), 2, 2))
            out[self.feature_names[i]] = getattr(self, f"stage_{i}")(x)
        return out

    def init_weights(self, generator: torch.Generator) -> None:
        """flax defaults: lecun-normal kernels (fan-in over kh*kw*in), zero
        biases, unit LayerNorms."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = (mod.in_channels * mod.kernel_size[0]
                          * mod.kernel_size[1])
                lecun_normal_(mod.weight, fan_in, generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
