"""ResNet trunks in PyTorch (counterpart of ovmono3d_tpu/models/resnet.py):
the torchvision layout re-exposed as p2-p6 maps for the FPN of
models/dla.py. ResNet-50 by default; `depths` and `bottleneck` give 18, 34
and 101. NCHW, f32, frozen BatchNorms (models/layers.py FrozenBatchNorm2d),
flax's module names (`stem`, `layer1_block0.conv1.bn`, `downsample`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.dla import ConvBN


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 to 4 * features, with a 1x1 projection
    of the input where its width or stride differs."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 device=None):
        super().__init__()
        out_ch = 4 * features
        self.downsample = (ConvBN(cin, out_ch, 1, stride, device=device)
                           if cin != out_ch or stride > 1 else None)
        self.conv1 = ConvBN(cin, features, 1, 1, device=device)
        self.conv2 = ConvBN(features, features, 3, stride, device=device)
        self.conv3 = ConvBN(features, out_ch, 1, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        return F.relu(self.conv3(h) + residual)


class ResBasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.downsample = (ConvBN(cin, features, 1, stride, device=device)
                           if cin != features or stride > 1 else None)
        self.conv1 = ConvBN(cin, features, 3, stride, device=device)
        self.conv2 = ConvBN(features, features, 3, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.conv1(x))
        return F.relu(self.conv2(h) + residual)


class ResNet(nn.Module):
    """NCHW image -> {'p2': /4 ... 'p6': /64}: layer1-4 and an extra 2x2
    max pool (reference resnet.py:12-96)."""

    def __init__(self, depths=(3, 4, 6, 3), width: int = 64,
                 bottleneck: bool = True, device=None):
        super().__init__()
        self.depths = tuple(depths)
        block = Bottleneck if bottleneck else ResBasicBlock
        expansion = 4 if bottleneck else 1
        self.stem = ConvBN(3, width, 7, 2, device=device)
        cin = width
        self.out_channels = {}
        for si, depth in enumerate(self.depths):
            feats = width * 2**si
            for bi in range(depth):
                self.add_module(f"layer{si + 1}_block{bi}", block(
                    cin, feats, 2 if (bi == 0 and si > 0) else 1, device))
                cin = feats * expansion
            self.out_channels[f"p{si + 2}"] = cin
        self.out_channels["p6"] = cin

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu(self.stem(x))
        # The JAX module pads with zeros, then pools without padding: the
        # same as torch's -inf padding only because x follows a ReLU.
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        out = {}
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                x = getattr(self, f"layer{si + 1}_block{bi}")(x)
            out[f"p{si + 2}"] = x
        out["p6"] = F.max_pool2d(x, 2, 2)
        return out
