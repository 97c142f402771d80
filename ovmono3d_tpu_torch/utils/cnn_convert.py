"""Trunk checkpoints for `--trunk-ckpt`: torch state dicts -> the JAX
package's trees, loaded into a model's trunk (counterpart of
ovmono3d_tpu/utils/cnn_convert.py).

The reference loads its trunks' pretrained weights at backbone build time:
the foundation ViTs from torch.hub / open_clip / HF (dino.py:29,
clip.py:23-28, mae.py:21, midas_final.py:23-24, sam.py:27-38), the CNNs from
the DLA model zoo and torchvision (dla.py:300-310, resnet.py, densenet.py,
mnasnet.py, shufflenet.py). The ViT converters live in
utils/checkpoint_convert.py and utils/sam_convert.py; the CNN converters
here map those state dicts onto models/dla.py, models/resnet.py and
models/cnns.py. CNN trunks carry BatchNorm running statistics, so every CNN
converter returns both collections,

    {"params": <tree>, "batch_stats": <tree>}

with the layout rules

  torch Conv2d  [out, in/groups, kh, kw] -> kernel [kh, kw, in/groups, out]
  torch BN weight / bias                 -> params {scale, bias}
  torch BN running_mean / running_var    -> batch_stats {mean, var}

and flax_bridge carries both into the trunk (the statistics into the
FrozenBatchNorm2d buffers). Every converter consumes its keys strictly:
unknown leftovers (other than classifier heads and num_batches_tracked)
raise, so a naming drift in a released checkpoint fails loudly.
`load_cnn_trunk` dispatches on cfg.model.backbone.name and loads the model
in place; dinov2's depth-fusion conv is the model's own (dino.py:83-105), no
foundation checkpoint holds it, and it keeps the model's initialization.
"""
from __future__ import annotations

import logging

import numpy as np
from torch import nn

from ovmono3d_tpu_torch.models.dla import DLA_PRESETS
from ovmono3d_tpu_torch.utils.checkpoint_convert import (convert_clip_vit,
                                                         convert_dinov2_vit,
                                                         convert_mae_vit,
                                                         convert_midas_vit)
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from ovmono3d_tpu_torch.utils.load import _state
from ovmono3d_tpu_torch.utils.sam_convert import convert_sam_encoder

logger = logging.getLogger(__name__)

VIT_TRUNKS = ("dinov2", "clip", "mae", "midas", "sam")


def _conv(w):  # torch Conv2d OIHW -> Flax HWIO (grouped convs included)
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


class _State:
    """Strict key-consuming view over a flat torch state dict."""

    def __init__(self, state: dict[str, np.ndarray]):
        self.state = dict(state)
        self.used: set[str] = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.state:
            raise KeyError(f"checkpoint is missing '{key}'")
        self.used.add(key)
        return np.asarray(self.state[key])

    def has(self, key: str) -> bool:
        return key in self.state

    def finish(self, ignore_prefixes: tuple[str, ...] = ()):
        leftovers = [
            k for k in self.state
            if k not in self.used
            and not k.endswith("num_batches_tracked")
            and not any(k.startswith(p) for p in ignore_prefixes)
        ]
        if leftovers:
            raise ValueError(
                f"{len(leftovers)} unconsumed checkpoint keys, e.g. "
                f"{sorted(leftovers)[:5]}"
            )

    # -- composite helpers -------------------------------------------------

    def convbn(self, conv_key: str, bn_key: str):
        """torch (conv, bn) pair -> our ConvBN module variables."""
        p = {
            "conv": {"kernel": _conv(self.take(conv_key + ".weight"))},
            "bn": {"scale": self.take(bn_key + ".weight"),
                   "bias": self.take(bn_key + ".bias")},
        }
        s = {"bn": {"mean": self.take(bn_key + ".running_mean"),
                    "var": self.take(bn_key + ".running_var")}}
        return p, s

    def conv(self, key: str, bias: bool = False):
        p = {"kernel": _conv(self.take(key + ".weight"))}
        if bias:
            p["bias"] = self.take(key + ".bias")
        return p

    def bn(self, key: str):
        p = {"scale": self.take(key + ".weight"),
             "bias": self.take(key + ".bias")}
        s = {"mean": self.take(key + ".running_mean"),
             "var": self.take(key + ".running_var")}
        return p, s


def _set(params: dict, stats: dict, name: str, ps):
    p, s = ps
    params[name] = p
    if s:
        stats[name] = s


# ---------------------------------------------------------------------------
# DLA (reference dla.py module layout; model-zoo 'dla34'..'dla169' weights)
# ---------------------------------------------------------------------------


def _dla_block(st: _State, prefix: str, block: str):
    p, s = {}, {}
    _set(p, s, "conv1", st.convbn(f"{prefix}.conv1", f"{prefix}.bn1"))
    _set(p, s, "conv2", st.convbn(f"{prefix}.conv2", f"{prefix}.bn2"))
    if block in ("bottleneck", "bottleneckx"):
        _set(p, s, "conv3", st.convbn(f"{prefix}.conv3", f"{prefix}.bn3"))
    return p, s


def _dla_tree(st: _State, prefix: str, levels: int, block: str):
    p, s = {}, {}
    if levels == 1:
        _set(p, s, "tree1", _dla_block(st, f"{prefix}.tree1", block))
        _set(p, s, "tree2", _dla_block(st, f"{prefix}.tree2", block))
        root_p = {"conv": {"kernel": _conv(st.take(f"{prefix}.root.conv.weight"))},
                  "bn": {"scale": st.take(f"{prefix}.root.bn.weight"),
                         "bias": st.take(f"{prefix}.root.bn.bias")}}
        root_s = {"bn": {"mean": st.take(f"{prefix}.root.bn.running_mean"),
                         "var": st.take(f"{prefix}.root.bn.running_var")}}
        p["root"] = {"conv": root_p}
        s["root"] = {"conv": root_s}
    else:
        _set(p, s, "tree1",
             _dla_tree(st, f"{prefix}.tree1", levels - 1, block))
        _set(p, s, "tree2",
             _dla_tree(st, f"{prefix}.tree2", levels - 1, block))
    if st.has(f"{prefix}.project.0.weight"):
        _set(p, s, "project",
             st.convbn(f"{prefix}.project.0", f"{prefix}.project.1"))
    return p, s


def convert_dla(state: dict[str, np.ndarray],
                levels=(1, 1, 1, 2, 2, 1), block: str = "basic") -> dict:
    """DLA model-zoo state dict -> models.dla.DLA variables
    (reference dla.py:235-310; key layout from base_layer/levelN/Tree
    attribute names)."""
    st = _State(state)
    params: dict = {}
    stats: dict = {}
    _set(params, stats, "base", st.convbn("base_layer.0", "base_layer.1"))
    _set(params, stats, "level0", st.convbn("level0.0", "level0.1"))
    _set(params, stats, "level1", st.convbn("level1.0", "level1.1"))
    for i in (2, 3, 4, 5):
        _set(params, stats, f"level{i}",
             _dla_tree(st, f"level{i}", levels[i], block))
    st.finish(ignore_prefixes=("fc.",))
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# ResNet (torchvision layout: conv1/bn1/layer{1..4}.{i}.conv*/downsample)
# ---------------------------------------------------------------------------


def convert_resnet(state: dict[str, np.ndarray],
                   depths=(3, 4, 6, 3), bottleneck: bool = True) -> dict:
    """torchvision ResNet state dict -> models.resnet.ResNet variables
    (reference resnet.py:12-96 wraps torchvision trunks)."""
    st = _State(state)
    params: dict = {}
    stats: dict = {}
    _set(params, stats, "stem", st.convbn("conv1", "bn1"))
    n_convs = 3 if bottleneck else 2
    for si, depth in enumerate(depths):
        for bi in range(depth):
            t = f"layer{si + 1}.{bi}"
            p, s = {}, {}
            for ci in range(1, n_convs + 1):
                _set(p, s, f"conv{ci}", st.convbn(f"{t}.conv{ci}",
                                                  f"{t}.bn{ci}"))
            if st.has(f"{t}.downsample.0.weight"):
                _set(p, s, "downsample",
                     st.convbn(f"{t}.downsample.0", f"{t}.downsample.1"))
            name = f"layer{si + 1}_block{bi}"
            params[name] = p
            stats[name] = s
    st.finish(ignore_prefixes=("fc.",))
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# DenseNet-121 (torchvision `features.*` layout)
# ---------------------------------------------------------------------------


def convert_densenet(state: dict[str, np.ndarray],
                     block_layers=(6, 12, 24, 16)) -> dict:
    """torchvision densenet121 state dict -> models.cnns.DenseNet variables
    (reference densenet.py:14-37 slices `base.features`)."""
    st = _State(state)
    params: dict = {}
    stats: dict = {}
    params["conv0"] = st.conv("features.conv0")
    p, s = st.bn("features.norm0")
    params["norm0"], stats["norm0"] = p, s
    for bi, layers in enumerate(block_layers):
        bp, bs = {}, {}
        for li in range(layers):
            t = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            lp, ls = {}, {}
            n1p, n1s = st.bn(f"{t}.norm1")
            lp["norm1"], ls["norm1"] = n1p, n1s
            lp["conv1"] = st.conv(f"{t}.conv1")
            n2p, n2s = st.bn(f"{t}.norm2")
            lp["norm2"], ls["norm2"] = n2p, n2s
            lp["conv2"] = st.conv(f"{t}.conv2")
            bp[f"denselayer{li + 1}"] = lp
            bs[f"denselayer{li + 1}"] = ls
        params[f"denseblock{bi + 1}"] = bp
        stats[f"denseblock{bi + 1}"] = bs
        if bi < len(block_layers) - 1:
            t = f"features.transition{bi + 1}"
            tp, ts = {}, {}
            np_, ns_ = st.bn(f"{t}.norm")
            tp["norm"], ts["norm"] = np_, ns_
            tp["conv"] = st.conv(f"{t}.conv")
            params[f"transition{bi + 1}"] = tp
            stats[f"transition{bi + 1}"] = ts
    p, s = st.bn("features.norm5")
    params["norm5"], stats["norm5"] = p, s
    st.finish(ignore_prefixes=("classifier.",))
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# MNASNet-1.0 (torchvision `layers.*` flat-Sequential layout)
# ---------------------------------------------------------------------------

_MNASNET_STACKS = ((24, 3), (40, 3), (80, 3), (96, 2), (192, 4), (320, 1))


def convert_mnasnet(state: dict[str, np.ndarray]) -> dict:
    """torchvision mnasnet1_0 state dict -> models.cnns.MNASNet variables
    (reference mnasnet.py:14-37 slices `base.layers`; stem at indices 0-7,
    stacks at 8-13, each _InvertedResidual's ops under `.layers.{0,1,3,4,6,7}`)."""
    st = _State(state)
    params: dict = {}
    stats: dict = {}
    params["stem_conv"] = st.conv("layers.0")
    p, s = st.bn("layers.1")
    params["stem_bn"], stats["stem_bn"] = p, s
    params["sep_dw"] = st.conv("layers.3")
    p, s = st.bn("layers.4")
    params["sep_bn1"], stats["sep_bn1"] = p, s
    params["sep_pw"] = st.conv("layers.6")
    p, s = st.bn("layers.7")
    params["sep_bn2"], stats["sep_bn2"] = p, s
    for si, (_, reps) in enumerate(_MNASNET_STACKS):
        for ri in range(reps):
            t = f"layers.{8 + si}.{ri}.layers"
            name = f"stack{si}_block{ri}"
            bp, bs = {}, {}
            bp["expand"] = st.conv(f"{t}.0")
            p, s = st.bn(f"{t}.1")
            bp["bn1"], bs["bn1"] = p, s
            bp["depthwise"] = st.conv(f"{t}.3")
            p, s = st.bn(f"{t}.4")
            bp["bn2"], bs["bn2"] = p, s
            bp["project"] = st.conv(f"{t}.6")
            p, s = st.bn(f"{t}.7")
            bp["bn3"], bs["bn3"] = p, s
            params[name] = bp
            stats[name] = bs
    st.finish(ignore_prefixes=("layers.14", "layers.15", "layers.16",
                               "classifier."))
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# ShuffleNetV2 x1.0 (torchvision conv1/stage{2,3,4}/conv5 layout)
# ---------------------------------------------------------------------------

_SHUFFLE_REPEATS = (4, 8, 4)


def convert_shufflenet(state: dict[str, np.ndarray]) -> dict:
    """torchvision shufflenet_v2_x1_0 state dict -> models.cnns.ShuffleNetV2
    variables (reference shufflenet.py:14-42; conv5 is unused there and
    ignored here)."""
    st = _State(state)
    params: dict = {}
    stats: dict = {}
    params["conv1"] = st.conv("conv1.0")
    p, s = st.bn("conv1.1")
    params["conv1_bn"], stats["conv1_bn"] = p, s
    for si, reps in enumerate(_SHUFFLE_REPEATS):
        for ri in range(reps):
            t = f"stage{si + 2}.{ri}"
            name = f"stage{si + 2}_unit{ri}"
            up, us = {}, {}
            if ri == 0:  # downsample unit: branch1 = dw conv, bn, 1x1, bn
                up["branch1_dw"] = st.conv(f"{t}.branch1.0")
                p, s = st.bn(f"{t}.branch1.1")
                up["branch1_bn1"], us["branch1_bn1"] = p, s
                up["branch1_pw"] = st.conv(f"{t}.branch1.2")
                p, s = st.bn(f"{t}.branch1.3")
                up["branch1_bn2"], us["branch1_bn2"] = p, s
            # branch2 = 1x1, bn, relu, dw, bn, 1x1, bn, relu
            up["branch2_pw1"] = st.conv(f"{t}.branch2.0")
            p, s = st.bn(f"{t}.branch2.1")
            up["branch2_bn1"], us["branch2_bn1"] = p, s
            up["branch2_dw"] = st.conv(f"{t}.branch2.3")
            p, s = st.bn(f"{t}.branch2.4")
            up["branch2_bn2"], us["branch2_bn2"] = p, s
            up["branch2_pw2"] = st.conv(f"{t}.branch2.5")
            p, s = st.bn(f"{t}.branch2.6")
            up["branch2_bn3"], us["branch2_bn3"] = p, s
            params[name] = up
            stats[name] = us
    st.finish(ignore_prefixes=("conv5.", "fc."))
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# Loading into a model
# ---------------------------------------------------------------------------

RESNET_DEPTHS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
                 "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                 "resnet": (3, 4, 6, 3)}


def convert_trunk(state: dict, backbone_name: str) -> tuple[str, dict]:
    """(the `model.backbone` attribute the trunk sits under, the converted
    tree) of a trunk state dict, by cfg.model.backbone.name: a ViT's params
    tree for `vit`, or a CNN's {params, batch_stats} for `dla`, `resnet`,
    `densenet`, `mnasnet` or `shufflenet`."""
    name = "dla34" if backbone_name == "dla" else backbone_name
    if name in VIT_TRUNKS:
        return "vit", _convert_vit_trunk(state, name)
    if name in DLA_PRESETS:
        preset = DLA_PRESETS[name]
        return "dla", convert_dla(state, levels=preset["levels"],
                                  block=preset["block"])
    if name in RESNET_DEPTHS:
        return "resnet", convert_resnet(
            state, depths=RESNET_DEPTHS[name],
            bottleneck=name not in ("resnet18", "resnet34"))
    if name.startswith("densenet"):
        return "densenet", convert_densenet(state)
    if name.startswith("mnasnet"):
        return "mnasnet", convert_mnasnet(state)
    if name.startswith("shufflenet"):
        return "shufflenet", convert_shufflenet(state)
    raise ValueError(f"no converter for backbone '{backbone_name}'")


def load_cnn_trunk(model: nn.Module, path, backbone_name: str) -> None:
    """CLI-facing: load a torch trunk checkpoint (`path`, or the state dict
    `load_torch_state` read) into an RCNN3D's trunk in place, dispatching on
    cfg.model.backbone.name: the foundation ViTs (hub dinov2, open_clip
    'openai' towers, HF ViTMAE, MiDaS DPT_Large, segment-anything encoders)
    into `model.backbone.vit`, the CNN families (DLA model zoo, torchvision
    layouts) into `model.backbone.<trunk>` with their BatchNorm statistics
    (the JAX package's graft into variables[...]['backbone'][trunk]).
    Strict: every parameter and buffer of the trunk is filled, shapes
    checked leaf by leaf, but dinov2's depth-fusion conv."""
    state = _state(path)
    trunk, converted = convert_trunk(state, backbone_name)
    module = getattr(model.backbone, trunk)
    keep = [n for n, _ in module.named_parameters()
            if n.startswith("depth_fusion.") and "depth_fusion" not in converted]
    load_flax_params(module, converted, keep=keep)
    logger.info("loaded the %s trunk (%d torch keys)", backbone_name,
                len(state))


def _convert_vit_trunk(state: dict, name: str) -> dict:
    """Dispatch a foundation-trunk state dict to its ViT converter,
    tolerating both bare and wrapper-prefixed key layouts."""
    def has(prefix):
        return any(k.startswith(prefix) for k in state)

    if name == "dinov2":
        depth = 0
        while f"blocks.{depth}.norm1.weight" in state:
            depth += 1
        return convert_dinov2_vit(state, depth=depth)
    if name == "clip":
        return convert_clip_vit(state,
                                prefix="visual." if has("visual.") else "")
    if name == "mae":
        return convert_mae_vit(state, prefix="vit." if has("vit.") else "")
    if name == "midas":
        return convert_midas_vit(
            state,
            prefix="pretrained.model." if has("pretrained.model.") else "",
        )
    if name == "sam":
        depth = 0
        pre = "image_encoder." if has("image_encoder.") else ""
        while f"{pre}blocks.{depth}.norm1.weight" in state:
            depth += 1
        return convert_sam_encoder(state, depth=depth, prefix=pre)
    raise ValueError(f"no ViT converter for '{name}'")
