"""DLA (Deep Layer Aggregation) trunk and the FPN of the CNN backbones, in
PyTorch (counterpart of ovmono3d_tpu/models/dla.py).

The original Cube R-CNN backbone (cubercnn/modeling/backbone/dla.py):
residual units composed by hierarchical Tree aggregation, returning the raw
p2-p6 stage maps for the FPN. DLA-34 by default; `DLA_PRESETS` holds the ten
variants. Maps are NCHW and everything runs in f32, as the JAX modules do
(no dtype is passed there). Every BatchNorm is `FrozenBatchNorm2d`: the JAX
package normalises with the running statistics, in training too.

Submodules carry the flax module names (`level2.tree1.conv1.bn`,
`fpn.lateral_p2`, ...) so utils/flax_bridge.py maps both the params and the
batch_stats trees mechanically. A Tree whose input width differs from its
output holds a `project` ConvBN even where its forward does not use it
(levels > 1), as the flax module and the released checkpoints do.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import FrozenBatchNorm2d


class ConvBN(nn.Module):
    """Conv (no bias, padding kernel // 2) -> frozen BatchNorm."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False, device=device)
        self.bn = FrozenBatchNorm2d(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = ConvBN(cin, features, 3, stride, device=device)
        self.conv2 = ConvBN(features, features, 3, 1, device=device)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = F.relu(self.conv1(x))
        return F.relu(self.conv2(out) + residual)


class DLABottleneck(nn.Module):
    """1-3-1 bottleneck unit, bottle width features // 2 (reference
    dla.py:71-109); `cardinality` > 0 is DLABottleneckX, the grouped
    ResNeXt-style 3x3 of width features * cardinality / 32 (:112-152)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 cardinality: int = 0, device=None):
        super().__init__()
        bottle = (features * cardinality // 32 if cardinality
                  else features // 2)
        self.conv1 = ConvBN(cin, bottle, 1, 1, device=device)
        self.conv2 = ConvBN(bottle, bottle, 3, stride,
                            groups=cardinality or 1, device=device)
        self.conv3 = ConvBN(bottle, features, 1, 1, device=device)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        return F.relu(self.conv3(out) + residual)


def _make_block(block: str, cin: int, features: int, stride: int,
                cardinality: int, device) -> nn.Module:
    if block == "basic":
        return BasicBlock(cin, features, stride, device)
    if block == "bottleneck":
        return DLABottleneck(cin, features, stride, 0, device)
    if block == "bottleneckx":
        return DLABottleneck(cin, features, stride, cardinality, device)
    raise ValueError(f"unknown DLA block '{block}'")


class Root(nn.Module):
    def __init__(self, cin: int, features: int, residual: bool = False,
                 device=None):
        super().__init__()
        self.residual = residual
        self.conv = ConvBN(cin, features, 1, 1, device=device)

    def forward(self, xs: list[torch.Tensor]) -> torch.Tensor:
        out = self.conv(torch.cat(xs, dim=1))
        if self.residual:
            out = out + xs[0]
        return F.relu(out)


class Tree(nn.Module):
    """Hierarchical aggregation of `levels` levels. `children_ch` are the
    widths of the children a parent Tree hands to this one (its root
    concatenates them)."""

    def __init__(self, levels: int, cin: int, features: int, stride: int = 1,
                 level_root: bool = False, root_residual: bool = False,
                 block: str = "basic", cardinality: int = 32,
                 children_ch: tuple[int, ...] = (), device=None):
        super().__init__()
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        ch = list(children_ch)
        self.project = (ConvBN(cin, features, 1, 1, device=device)
                        if cin != features else None)
        if level_root:
            ch.append(cin)
        kw = dict(root_residual=root_residual, block=block,
                  cardinality=cardinality, device=device)
        if levels == 1:
            self.tree1 = _make_block(block, cin, features, stride,
                                     cardinality, device)
            self.tree2 = _make_block(block, features, features, 1,
                                     cardinality, device)
            self.root = Root(2 * features + sum(ch), features, root_residual,
                             device)
        else:
            self.tree1 = Tree(levels - 1, cin, features, stride, **kw)
            self.tree2 = Tree(levels - 1, features, features, 1,
                              children_ch=(*ch, features), **kw)

    def forward(self, x, children=None):
        children = list(children) if children else []
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            proj = bottom if self.project is None else self.project(bottom)
            x1 = self.tree1(x, proj)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DLA(nn.Module):
    """DLA trunk: NCHW image -> {'p2': /4 ... 'p6': /64} raw stage maps
    (channels[2:] and channels[5] again for p6, the extra 2x2 max pool),
    as the reference DLABackbone's p2-p6 (dla.py:417-484)."""

    def __init__(self, levels=(1, 1, 1, 2, 2, 1),
                 channels=(16, 32, 64, 128, 256, 512),
                 root_residual: bool = False, block: str = "basic",
                 cardinality: int = 32, device=None):
        super().__init__()
        ch = channels
        self.base = ConvBN(3, ch[0], 7, 1, device=device)
        self.level0 = ConvBN(ch[0], ch[0], 3, 1, device=device)
        self.level1 = ConvBN(ch[0], ch[1], 3, 2, device=device)
        kw = dict(root_residual=root_residual, block=block,
                  cardinality=cardinality, device=device)
        for i in (2, 3, 4, 5):
            self.add_module(f"level{i}", Tree(
                levels[i], ch[i - 1], ch[i], 2, level_root=i > 2, **kw))
        self.out_channels = {"p2": ch[2], "p3": ch[3], "p4": ch[4],
                             "p5": ch[5], "p6": ch[5]}

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu(self.base(x))
        x = F.relu(self.level0(x))
        x = F.relu(self.level1(x))
        out = {}
        for i in (2, 3, 4, 5):
            x = getattr(self, f"level{i}")(x)
            out[f"p{i}"] = x
        out["p6"] = F.max_pool2d(x, 2, 2)
        return out


# Variant presets (reference dla.py:312-414).
DLA_PRESETS: dict[str, dict[str, Any]] = {
    "dla34": dict(levels=(1, 1, 1, 2, 2, 1),
                  channels=(16, 32, 64, 128, 256, 512), block="basic"),
    "dla46_c": dict(levels=(1, 1, 1, 2, 2, 1),
                    channels=(16, 32, 64, 64, 128, 256), block="bottleneck"),
    "dla46x_c": dict(levels=(1, 1, 1, 2, 2, 1),
                     channels=(16, 32, 64, 64, 128, 256),
                     block="bottleneckx"),
    "dla60x_c": dict(levels=(1, 1, 1, 2, 3, 1),
                     channels=(16, 32, 64, 64, 128, 256),
                     block="bottleneckx"),
    "dla60": dict(levels=(1, 1, 1, 2, 3, 1),
                  channels=(16, 32, 128, 256, 512, 1024),
                  block="bottleneck"),
    "dla60x": dict(levels=(1, 1, 1, 2, 3, 1),
                   channels=(16, 32, 128, 256, 512, 1024),
                   block="bottleneckx"),
    "dla102": dict(levels=(1, 1, 1, 3, 4, 1),
                   channels=(16, 32, 128, 256, 512, 1024),
                   block="bottleneck", root_residual=True),
    "dla102x": dict(levels=(1, 1, 1, 3, 4, 1),
                    channels=(16, 32, 128, 256, 512, 1024),
                    block="bottleneckx", root_residual=True),
    "dla102x2": dict(levels=(1, 1, 1, 3, 4, 1),
                     channels=(16, 32, 128, 256, 512, 1024),
                     block="bottleneckx", cardinality=64,
                     root_residual=True),
    "dla169": dict(levels=(1, 1, 2, 3, 5, 1),
                   channels=(16, 32, 128, 256, 512, 1024),
                   block="bottleneck", root_residual=True),
}


class FPN(nn.Module):
    """Top-down FPN over the trunk's {name: [B, C_name, H, W]} maps
    (`in_channels`): a 1x1 lateral conv per level, each coarser level
    nearest-upsampled onto the next finer one's size and added, then a 3x3
    output conv; biases on every conv. The upsample is
    jax.image.resize(method="nearest"), which maps pixel centres (half-pixel),
    i.e. F.interpolate's "nearest-exact", not its "nearest"; the two differ
    where a ratio is not exactly 2."""

    def __init__(self, in_channels: dict[str, int], out_channels: int = 256,
                 device=None):
        super().__init__()
        self.names = sorted(in_channels)
        for n in self.names:
            self.add_module(f"lateral_{n}", nn.Conv2d(
                in_channels[n], out_channels, 1, device=device))
            self.add_module(f"output_{n}", nn.Conv2d(
                out_channels, out_channels, 3, padding=1, device=device))

    def forward(self, feats: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        out, prev = {}, None
        for n in reversed(self.names):
            cur = getattr(self, f"lateral_{n}")(feats[n])
            if prev is not None:
                cur = cur + F.interpolate(prev, size=cur.shape[-2:],
                                          mode="nearest-exact")
            prev = cur
            out[n] = getattr(self, f"output_{n}")(cur)
        return out
