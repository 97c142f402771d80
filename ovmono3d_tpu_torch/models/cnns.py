"""DenseNet-121, MNASNet 1.0 and ShuffleNetV2 x1.0 trunks in PyTorch
(counterpart of ovmono3d_tpu/models/cnns.py): the torchvision layouts, each
returning raw {'p2': /4 ... 'p6': /64} maps for the FPN of models/dla.py.
p6 is the reference's parameter-free max_pool2d(kernel_size=1, stride=2),
every other pixel. NCHW, f32, frozen BatchNorms (models/layers.py
FrozenBatchNorm2d), flax's module names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import FrozenBatchNorm2d


def _conv(cin: int, cout: int, kernel: int = 1, stride: int = 1,
          groups: int = 1, device=None) -> nn.Conv2d:
    """A bias-free conv with flax's symmetric padding kernel // 2."""
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups,
                     bias=False, device=device)


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool over a zero-padded map, as the JAX module pads (the
    inputs follow a ReLU, so zero padding is max-safe)."""
    return F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)


def _subsample2(x: torch.Tensor) -> torch.Tensor:
    """max_pool2d(kernel=1, stride=2): every other pixel."""
    return x[:, :, ::2, ::2]


# -- DenseNet-121 (torchvision densenet121) ----------------------------------

class DenseLayer(nn.Module):
    """BN-ReLU-1x1(4g) -> BN-ReLU-3x3(g), concatenated onto the input."""

    def __init__(self, cin: int, growth: int = 32, device=None):
        super().__init__()
        self.norm1 = FrozenBatchNorm2d(cin, device=device)
        self.conv1 = _conv(cin, 4 * growth, 1, device=device)
        self.norm2 = FrozenBatchNorm2d(4 * growth, device=device)
        self.conv2 = _conv(4 * growth, growth, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class DenseBlock(nn.Module):
    def __init__(self, layers: int, cin: int, growth: int = 32, device=None):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                cin + i * growth, growth, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"denselayer{i + 1}")(x)
        return x


class Transition(nn.Module):
    def __init__(self, cin: int, features: int, device=None):
        super().__init__()
        self.norm = FrozenBatchNorm2d(cin, device=device)
        self.conv = _conv(cin, features, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """DenseNet-121: p2-p5 of 256 / 512 / 1024 / 1024 channels at strides
    4-32 as the reference slices `base.features` (densenet.py:24-37); p5 is
    norm5's output (no ReLU)."""

    def __init__(self, block_layers=(6, 12, 24, 16), growth: int = 32,
                 init_features: int = 64, device=None):
        super().__init__()
        self.block_layers = tuple(block_layers)
        self.conv0 = _conv(3, init_features, 7, 2, device=device)
        self.norm0 = FrozenBatchNorm2d(init_features, device=device)
        ch = init_features
        self.out_channels = {}
        for i, layers in enumerate(self.block_layers):
            self.add_module(f"denseblock{i + 1}", DenseBlock(
                layers, ch, growth, device))
            ch += layers * growth
            if i < 3:
                self.out_channels[f"p{i + 2}"] = ch
            if i < len(self.block_layers) - 1:
                self.add_module(f"transition{i + 1}", Transition(
                    ch, ch // 2, device))
                ch //= 2
        self.norm5 = FrozenBatchNorm2d(ch, device=device)
        self.out_channels.update(p5=ch, p6=ch)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = _maxpool3(F.relu(self.norm0(self.conv0(x))))
        out = {}
        for i in range(len(self.block_layers)):
            x = getattr(self, f"denseblock{i + 1}")(x)
            if i < 3:
                out[f"p{i + 2}"] = x
            if i < len(self.block_layers) - 1:
                x = getattr(self, f"transition{i + 1}")(x)
        out["p5"] = self.norm5(x)
        out["p6"] = _subsample2(out["p5"])
        return out


# -- MNASNet 1.0 (torchvision mnasnet1_0) ------------------------------------

class InvertedResidual(nn.Module):
    """MBConv: 1x1 expand -> kxk depthwise -> 1x1 project (+ the input where
    stride 1 keeps the width)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, expansion: int = 3, device=None):
        super().__init__()
        mid = cin * expansion
        self.residual = stride == 1 and cin == features
        self.expand = _conv(cin, mid, 1, device=device)
        self.bn1 = FrozenBatchNorm2d(mid, device=device)
        self.depthwise = _conv(mid, mid, kernel, stride, groups=mid,
                               device=device)
        self.bn2 = FrozenBatchNorm2d(mid, device=device)
        self.project = _conv(mid, features, 1, device=device)
        self.bn3 = FrozenBatchNorm2d(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.expand(x)))
        h = F.relu(self.bn2(self.depthwise(h)))
        h = self.bn3(self.project(h))
        return h + x if self.residual else h


class MNASNet(nn.Module):
    """MNASNet-1.0: p2-p5 of 24 / 40 / 96 / 320 channels at strides 4-32
    (the reference's `base.layers` slices, mnasnet.py:24-37)."""

    # (out, kernel, stride, expansion, repeats) per stack, torchvision order.
    STACKS = ((24, 3, 2, 3, 3), (40, 5, 2, 3, 3), (80, 5, 2, 6, 3),
              (96, 3, 1, 6, 2), (192, 5, 2, 6, 4), (320, 3, 1, 6, 1))
    TAPS = {0: "p2", 1: "p3", 3: "p4", 5: "p5"}

    def __init__(self, device=None):
        super().__init__()
        self.stem_conv = _conv(3, 32, 3, 2, device=device)
        self.stem_bn = FrozenBatchNorm2d(32, device=device)
        self.sep_dw = _conv(32, 32, 3, groups=32, device=device)
        self.sep_bn1 = FrozenBatchNorm2d(32, device=device)
        self.sep_pw = _conv(32, 16, 1, device=device)
        self.sep_bn2 = FrozenBatchNorm2d(16, device=device)
        cin = 16
        self.out_channels = {}
        for si, (ch, k, s, e, reps) in enumerate(self.STACKS):
            for ri in range(reps):
                self.add_module(f"stack{si}_block{ri}", InvertedResidual(
                    cin, ch, k, s if ri == 0 else 1, e, device))
                cin = ch
            if si in self.TAPS:
                self.out_channels[self.TAPS[si]] = ch
        self.out_channels["p6"] = cin

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.relu(self.sep_bn1(self.sep_dw(x)))
        x = self.sep_bn2(self.sep_pw(x))
        out = {}
        for si, (*_, reps) in enumerate(self.STACKS):
            for ri in range(reps):
                x = getattr(self, f"stack{si}_block{ri}")(x)
            if si in self.TAPS:
                out[self.TAPS[si]] = x
        out["p6"] = _subsample2(out["p5"])
        return out


# -- ShuffleNetV2 x1.0 (torchvision shufflenet_v2_x1_0) ----------------------

def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """[B, C, H, W] with channel g * (C / groups) + i moved to i * groups + g:
    the JAX module's NHWC reshape / swap, and torchvision's shuffle."""
    b, c, h, w = x.shape
    return (x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class ShuffleUnit(nn.Module):
    """Channel split + right branch + shuffle (stride 1), or the two-branch
    downsample (stride 2); `features` is the total output width."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.stride = stride
        branch = features // 2
        if stride > 1:
            self.branch1_dw = _conv(cin, cin, 3, 2, groups=cin, device=device)
            self.branch1_bn1 = FrozenBatchNorm2d(cin, device=device)
            self.branch1_pw = _conv(cin, branch, 1, device=device)
            self.branch1_bn2 = FrozenBatchNorm2d(branch, device=device)
        self.branch2_pw1 = _conv(cin if stride > 1 else cin // 2, branch, 1,
                                 device=device)
        self.branch2_bn1 = FrozenBatchNorm2d(branch, device=device)
        self.branch2_dw = _conv(branch, branch, 3, stride, groups=branch,
                                device=device)
        self.branch2_bn2 = FrozenBatchNorm2d(branch, device=device)
        self.branch2_pw2 = _conv(branch, branch, 1, device=device)
        self.branch2_bn3 = FrozenBatchNorm2d(branch, device=device)

    def _right(self, h: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.branch2_bn1(self.branch2_pw1(h)))
        h = self.branch2_bn2(self.branch2_dw(h))
        return F.relu(self.branch2_bn3(self.branch2_pw2(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            left, right = x.chunk(2, dim=1)
            right = self._right(right)
        else:
            left = self.branch1_bn1(self.branch1_dw(x))
            left = F.relu(self.branch1_bn2(self.branch1_pw(left)))
            right = self._right(x)
        return channel_shuffle(torch.cat([left, right], dim=1), 2)


class ShuffleNetV2(nn.Module):
    """ShuffleNetV2-x1.0: p2-p5 of 24 / 116 / 232 / 464 channels at strides
    4-32 (reference shufflenet.py:22-42; conv5 is unused there too)."""

    def __init__(self, stage_repeats=(4, 8, 4),
                 stage_channels=(116, 232, 464), device=None):
        super().__init__()
        self.stages = tuple(zip(stage_repeats, stage_channels))
        self.conv1 = _conv(3, 24, 3, 2, device=device)
        self.conv1_bn = FrozenBatchNorm2d(24, device=device)
        cin = 24
        self.out_channels = {"p2": 24}
        for si, (reps, ch) in enumerate(self.stages):
            for ri in range(reps):
                self.add_module(f"stage{si + 2}_unit{ri}", ShuffleUnit(
                    cin, ch, 2 if ri == 0 else 1, device))
                cin = ch
            self.out_channels[f"p{si + 3}"] = ch
        self.out_channels["p6"] = cin

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = _maxpool3(F.relu(self.conv1_bn(self.conv1(x))))
        out = {"p2": x}
        for si, (reps, _) in enumerate(self.stages):
            for ri in range(reps):
                x = getattr(self, f"stage{si + 2}_unit{ri}")(x)
            out[f"p{si + 3}"] = x
        out["p6"] = _subsample2(out["p5"])
        return out
