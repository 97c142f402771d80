"""Trunk checkpoints for `--trunk-ckpt` (counterpart of the ViT half of
ovmono3d_tpu/utils/cnn_convert.py).

The reference downloads the foundation trunk at backbone build time
(dino.py:29). `load_cnn_trunk` converts a torch.hub DINOv2 state dict and
loads it into `model.backbone.vit` in place; the depth-fusion 1x1 conv is
the model's own (dino.py:83-105) and no foundation checkpoint holds it, so
it keeps the model's initialization. The CLIP, MAE, MiDaS and SAM trunks
convert (`_convert_vit_trunk`) but have no model to load into: the port's
detector backbone builds only dinov2 (ROADMAP queue 1 item 9). The CNN
families (DLA, ResNet, DenseNet, MNASNet, ShuffleNet) and their converters
are item 9 too.
"""
from __future__ import annotations

import logging

from torch import nn

from ovmono3d_tpu_torch.utils.checkpoint_convert import (convert_clip_vit,
                                                         convert_dinov2_vit,
                                                         convert_mae_vit,
                                                         convert_midas_vit)
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from ovmono3d_tpu_torch.utils.load import _state
from ovmono3d_tpu_torch.utils.sam_convert import convert_sam_encoder

logger = logging.getLogger(__name__)

VIT_TRUNKS = ("dinov2", "clip", "mae", "midas", "sam")


def load_cnn_trunk(model: nn.Module, path, backbone_name: str) -> None:
    """CLI-facing: load a torch trunk checkpoint (`path`, or the state dict
    `load_torch_state` read) into an RCNN3D's trunk in place, dispatching on
    cfg.model.backbone.name."""
    if backbone_name not in VIT_TRUNKS:
        raise NotImplementedError(
            f"--trunk-ckpt for backbone {backbone_name!r}: the CNN trunks "
            "and their converters are ROADMAP queue 1 item 9")
    if backbone_name != "dinov2":
        raise NotImplementedError(
            f"--trunk-ckpt for the {backbone_name} trunk: its model is "
            "ROADMAP queue 1 item 9")
    state = _state(path)
    converted = _convert_vit_trunk(state, backbone_name)
    vit = model.backbone.vit
    keep = [n for n, _ in vit.named_parameters()
            if n.startswith("depth_fusion.")]
    load_flax_params(vit, converted, keep=keep)
    logger.info("loaded the %s trunk (%d torch keys)", backbone_name,
                len(state))


def _convert_vit_trunk(state: dict, name: str) -> dict:
    """Dispatch a foundation-trunk state dict to its ViT converter,
    tolerating both bare and wrapper-prefixed key layouts. Every trunk
    converts (held to the JAX function by tests/test_torch_convert.py); only
    dinov2's tree has a model to load into yet."""
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
