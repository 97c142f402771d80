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
channels-last (NHWC), through the convs of models/layers.py.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import (ConvTranspose, conv_norm_pair,
                                              init_flax_defaults)


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
        return conv_norm_pair(x, self.lateral, self.lateral_norm, self.output,
                              self.output_norm, self.dtype)


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
                self.add_module(f"up4a_{i}", ConvTranspose(
                    dim, dim // 2, dtype=dtype, device=device))
                self.add_module(f"up4_norm_{i}", nn.LayerNorm(
                    dim // 2, eps=1e-6, device=device))
                self.add_module(f"up4b_{i}", ConvTranspose(
                    dim // 2, dim // 4, dtype=dtype, device=device))
                stage_in = dim // 4
            elif scale == 2.0:
                self.add_module(f"up2_{i}", ConvTranspose(
                    dim, dim // 2, dtype=dtype, device=device))
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
                x = getattr(self, f"up4a_{i}")(x)
                x = getattr(self, f"up4_norm_{i}")(x.float())
                x = F.gelu(x)
                x = getattr(self, f"up4b_{i}")(x)
            elif scale == 2.0:
                x = getattr(self, f"up2_{i}")(x)
            elif scale == 0.5:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
                x = x.permute(0, 2, 3, 1)
            out[self.feature_names[i]] = getattr(self, f"stage_{i}")(x)
        return out

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default initializers: lecun-normal kernels (fan-in over
        kh*kw*in), zero biases, unit LayerNorms."""
        init_flax_defaults(self, generator)
