"""Converter coverage at the released checkpoints' full sizes, on the meta
device (the counterpart of tests/test_converter_fullsize.py for the port).

The HF models are built on the meta device and their state dicts taken as
zero-byte numpy arrays (`release_states.SHAPE_ONLY`): the keys and shapes of
GroundingDINO Swin-B, SAM ViT-H (encoder, prompt encoder and mask decoder)
and Depth-Pro in no memory. Each goes through the port's shim and converter
and `flax_bridge.plan` onto the port's full-size module on the meta device:
every leaf lands on one parameter with its shape, and every parameter is
filled. Elements are counted too: the state's, less the keys the converter
leaves unread (`release_states.IGNORED`), equal the tree's, so no released
tensor is dropped unnoticed. The flagship LIFT layout, which has no HF
model, comes from `release_states.lift_state`; the other generators are
held to the HF layouts key for key.
"""
import re

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.config import flagship_config
from ovmono3d_tpu_torch.models.backbones import SAM_ARCHS, VIT_PRESETS
from ovmono3d_tpu_torch.models.depth import DepthPro
from ovmono3d_tpu_torch.models.ovmono3d import build_gdino
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils import release_states as rs
from ovmono3d_tpu_torch.utils.cnn_convert import _convert_vit_trunk
from ovmono3d_tpu_torch.utils.depth_convert import convert_depth_pro
from ovmono3d_tpu_torch.utils.flax_bridge import _flatten, plan
from ovmono3d_tpu_torch.utils.gdino_convert import convert_groundingdino
from ovmono3d_tpu_torch.utils.hf_shims import (hf_gdino_to_original_keys,
                                               hf_sam_to_original_keys)
from ovmono3d_tpu_torch.utils.lift_convert import convert_ovmono3d_lift
from ovmono3d_tpu_torch.utils.sam_convert import (convert_sam_encoder,
                                                  convert_sam_segmenter)

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

SWINB_DEPTHS = (2, 2, 18, 2)


def meta_state(cls, *args, **kwargs) -> dict:
    """An HF model's state dict as zero-byte arrays of its shapes."""
    with torch.device("meta"):
        model = cls(*args, **kwargs)
    return {k: np.empty(tuple(v.shape), rs.SHAPE_ONLY)
            for k, v in model.state_dict().items()}


def shapes(state: dict) -> dict:
    return {k: tuple(np.shape(v)) for k, v in state.items()}


def covered(module, state: dict, tree: dict, ignored, keep=()) -> int:
    """plan() maps the tree onto every parameter of `module` but `keep`;
    the state's elements less the ignored keys' equal the tree's. Returns
    the leaves."""
    n = len(plan(module, tree, keep))
    assert n == len(dict(module.named_parameters())) - len(keep) > 0
    skip = [k for k in state if any(re.search(p, k) for p in ignored)]
    read = sum(int(np.prod(np.shape(v))) for k, v in state.items()
               if k not in skip)
    assert read == sum(int(np.prod(np.shape(v)))
                       for v in _flatten(tree).values())
    return n


@pytest.fixture(scope="module")
def hf_gdino_swinb():
    """GroundingDINO SwinB (groundingdino_swinb_cogcoor.pth's geometry):
    Swin-B 128 (2, 2, 18, 2) window 12, BERT-base, 6 + 6 layers, 900
    queries, text length 256; renamed to the original keys."""
    from transformers import (BertConfig, GroundingDinoConfig,
                              GroundingDinoForObjectDetection, SwinConfig)

    swin = SwinConfig(image_size=384, patch_size=4, embed_dim=128,
                      depths=list(SWINB_DEPTHS), num_heads=[4, 8, 16, 32],
                      window_size=12,
                      out_features=["stage2", "stage3", "stage4"])
    cfg = GroundingDinoConfig(
        backbone_config=swin, text_config=BertConfig(), d_model=256,
        encoder_layers=6, decoder_layers=6, num_queries=900,
        encoder_attention_heads=8, decoder_attention_heads=8,
        encoder_ffn_dim=2048, decoder_ffn_dim=2048, num_feature_levels=4,
        max_text_len=256)
    return hf_gdino_to_original_keys(
        meta_state(GroundingDinoForObjectDetection, cfg), SWINB_DEPTHS, 6, 6)


@pytest.fixture(scope="module")
def hf_sam_vith():
    """sam_vit_h_4b8939.pth's geometry in the original keys: the image
    encoder (1280 wide, 32 blocks, window 14, global 7/15/23/31) renamed,
    the prompt encoder and mask decoder through the shim."""
    from transformers import SamConfig, SamModel
    from transformers.models.sam.configuration_sam import SamVisionConfig

    vision = SamVisionConfig(hidden_size=1280, output_channels=256,
                             num_hidden_layers=32, num_attention_heads=16,
                             image_size=1024, patch_size=16, window_size=14,
                             global_attn_indexes=[7, 15, 23, 31],
                             mlp_dim=5120)
    hf = meta_state(SamModel, SamConfig(vision_config=vision))
    state = hf_sam_to_original_keys(hf)
    for k, v in hf.items():
        if k.startswith("vision_encoder."):
            state["image_encoder." + k[len("vision_encoder."):]
                  .replace("patch_embed.projection", "patch_embed.proj")
                  .replace("layers.", "blocks.")
                  .replace("layer_norm1", "norm1")
                  .replace("layer_norm2", "norm2")
                  .replace("neck.conv1", "neck.0")
                  .replace("neck.norm1", "neck.1")
                  .replace("neck.conv2", "neck.2")
                  .replace("neck.norm2", "neck.3")] = v
    return state


@pytest.fixture(scope="module")
def hf_depth_pro():
    """apple/DepthPro-hf's geometry: three ViT-L/16 trunks at 384^2, the
    1536 pyramid, fusion 256, the FOV head."""
    from transformers import DepthProConfig
    from transformers.models.depth_pro.modeling_depth_pro import (
        DepthProForDepthEstimation)

    vit = dict(model_type="dinov2", hidden_size=1024, num_hidden_layers=24,
               num_attention_heads=16, image_size=384, patch_size=16)
    cfg = DepthProConfig(patch_model_config=vit, image_model_config=vit,
                         fov_model_config=vit)
    return meta_state(DepthProForDepthEstimation, cfg, use_fov_model=True)


def test_gdino_swinb_maps_onto_the_port(hf_gdino_swinb):
    n = covered(build_gdino(device="meta"), hf_gdino_swinb,
                convert_groundingdino(hf_gdino_swinb), ())
    assert n > 500


def test_sam_vith_encoder_maps_onto_the_port(hf_sam_vith):
    enc = VisionTransformer(device="meta", pos_interp_offset=0.0,
                            use_depth_fusion=False,
                            **{**VIT_PRESETS["sam"], **SAM_ARCHS["vit_h"]})
    part = {k: v for k, v in hf_sam_vith.items()
            if k.startswith("image_encoder.")}
    assert covered(enc, part, convert_sam_encoder(part, depth=32), ()) > 300


def test_sam_segmenter_maps_onto_the_port(hf_sam_vith):
    part = {k: v for k, v in hf_sam_vith.items()
            if not k.startswith("image_encoder.")}
    covered(SamSegmenter(device="meta"), part, convert_sam_segmenter(part),
            rs.IGNORED["sam"])


def test_depth_pro_maps_onto_the_port(hf_depth_pro):
    n = covered(DepthPro(device="meta"), hf_depth_pro,
                convert_depth_pro(hf_depth_pro), rs.IGNORED["depth_pro"])
    assert n > 300


def test_flagship_lift_maps_onto_the_port():
    cfg = flagship_config()
    state = rs.lift_state(cfg, shape_only=True)
    n = covered(build_model(cfg, device="meta"), state,
                convert_ovmono3d_lift(state), rs.IGNORED["lift"])
    assert n > 150
    assert state["backbone.net.vit.pos_embed"].shape == (1, 37 * 37 + 1, 768)


def test_dinov2_hub_trunk_maps_onto_the_flagship_trunk():
    state = rs.dinov2_hub_state(shape_only=True)
    vit = build_model(flagship_config(), device="meta").backbone.vit
    covered(vit, state, _convert_vit_trunk(state, "dinov2"),
            rs.IGNORED["dinov2"], keep=("depth_fusion.weight",
                                        "depth_fusion.bias"))


@pytest.mark.parametrize("layout", ["gdino", "sam", "depth_pro"])
def test_release_states_hold_the_hf_layouts(layout, hf_gdino_swinb,
                                            hf_sam_vith, hf_depth_pro):
    """The generators at full size give the released layouts' keys and
    shapes: Depth-Pro's is HF's own; GroundingDINO's and SAM's read keys are
    the shims' renames, and their other keys (the original modules' buffers,
    shared copies and unused prompt parts) are the converters' IGNORED."""
    made = {"gdino": lambda: rs.gdino_state(shape_only=True),
            "sam": lambda: rs.sam_state(shape_only=True),
            "depth_pro": lambda: rs.depth_pro_state(shape_only=True)}[
        layout]()
    hf = {"gdino": hf_gdino_swinb, "sam": hf_sam_vith,
          "depth_pro": hf_depth_pro}[layout]

    def read(state):
        return shapes({k: v for k, v in state.items()
                       if not any(re.search(p, k)
                                  for p in rs.IGNORED[layout])})

    assert read(made) == read(hf)
    extra = sorted(set(made) - set(hf))
    if layout == "depth_pro":
        assert extra == []
    else:
        assert extra and set(extra) - set(read(made)) == set(extra)
