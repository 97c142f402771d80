"""The port's checkpoint converters against the JAX package's: the same seeded
numpy state dict in a released key layout (utils/release_states.py, or a
tiny HF model's for the key shims) through both, and the two trees equal
exactly -- the same paths, shapes, dtypes and values. A missing key, an extra
key or a misshapen tensor gives the same outcome on both sides: the same
exception, or equal trees."""
import dataclasses

import numpy as np
import pytest
import torch

from ovmono3d_tpu.utils import checkpoint_convert as jcc
from ovmono3d_tpu.utils import cnn_convert as jcnn
from ovmono3d_tpu.utils import depth_convert as jdc
from ovmono3d_tpu.utils import gdino_convert as jgc
from ovmono3d_tpu.utils import hf_shims as jhf
from ovmono3d_tpu.utils import lift_convert as jlc
from ovmono3d_tpu.utils import sam_convert as jsc
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.utils import checkpoint_convert as tcc
from ovmono3d_tpu_torch.utils import cnn_convert as tcnn
from ovmono3d_tpu_torch.utils import depth_convert as tdc
from ovmono3d_tpu_torch.utils import gdino_convert as tgc
from ovmono3d_tpu_torch.utils import hf_shims as thf
from ovmono3d_tpu_torch.utils import lift_convert as tlc
from ovmono3d_tpu_torch.utils import release_states as rs
from ovmono3d_tpu_torch.utils import sam_convert as tsc

torch.set_num_threads(2)

# Tiny widths of every layout (a few blocks, narrow).
GDINO_KW = dict(hidden_dim=32, nheads=2, enc_layers=2, dec_layers=2,
                num_queries=16, enc_points=2, dec_points=2, ffn_dim=64,
                swin_embed_dim=8, swin_depths=(1, 2, 1, 1),
                swin_heads=(1, 2, 4, 8), swin_window=4, bert_layers=2,
                bert_hidden=32, bert_intermediate=64, bert_vocab=60,
                bert_max_position=40)
SAM_KW = dict(embed_dim=32, depth=3, num_heads=2, global_blocks=(1,),
              window_size=4, grid=6, patch=8, neck=16, decoder_dim=32,
              decoder_mlp=64)
DEPTH_KW = dict(patch_size=8, encoder_size=32, vit_dim=32, vit_depth=2,
                scaled_dims=(16, 16, 8), hook_dims=(8, 8), fusion_dim=8)


def lift_cfg(scale_factors=(2.0, 1.0, 0.5), shared_fc=True, priors=False,
             bins=1) -> tcfg.ModelConfig:
    base = tcfg.ModelConfig()
    return dataclasses.replace(
        base, num_classes=5,
        backbone=dataclasses.replace(
            base.backbone, embed_dim=32, depth=2, num_heads=2,
            pretrain_grid=4, out_channels=16, square_pad=56,
            scale_factors=scale_factors),
        roi_box=dataclasses.replace(base.roi_box, fc_dim=16),
        cube=dataclasses.replace(base.cube, fc_dim=16, shared_fc=shared_fc,
                                 dims_priors_enabled=priors,
                                 cluster_bins=bins))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v
    return out


def assert_trees_equal(got, want):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for path, wv in w.items():
        gv = g[path]
        assert isinstance(gv, np.ndarray), path
        assert gv.shape == np.shape(wv) and gv.dtype == np.asarray(wv).dtype, \
            path
        np.testing.assert_array_equal(gv, wv, err_msg=path)


def _vit_state(rng, keys, dim=32, depth=2, patch=8, grid=4):
    """A ViT trunk in one of the foundation layouts: `keys` maps the block's
    parts to that layout's names."""
    s = {}

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    for k, shape in keys["embed"](dim, patch, grid).items():
        s[k] = w(*shape)
    for i in range(depth):
        for k, shape in keys["block"](i, dim).items():
            s[k] = w(*shape)
    return s


def clip_state(rng, prefix="visual."):
    p = prefix
    return _vit_state(rng, {
        "embed": lambda d, pt, g: {
            p + "class_embedding": (d,),
            p + "positional_embedding": (g * g + 1, d),
            p + "conv1.weight": (d, 3, pt, pt),
            p + "ln_pre.weight": (d,), p + "ln_pre.bias": (d,),
            p + "ln_post.weight": (d,), p + "proj": (d, 16)},
        "block": lambda i, d: {
            f"{p}transformer.resblocks.{i}.{k}": s for k, s in {
                "ln_1.weight": (d,), "ln_1.bias": (d,),
                "attn.in_proj_weight": (3 * d, d),
                "attn.in_proj_bias": (3 * d,),
                "attn.out_proj.weight": (d, d), "attn.out_proj.bias": (d,),
                "ln_2.weight": (d,), "ln_2.bias": (d,),
                "mlp.c_fc.weight": (4 * d, d), "mlp.c_fc.bias": (4 * d,),
                "mlp.c_proj.weight": (d, 4 * d),
                "mlp.c_proj.bias": (d,)}.items()}})


def mae_state(rng, prefix="vit."):
    p = prefix
    lin = {"query": "attention.attention.query",
           "key": "attention.attention.key",
           "value": "attention.attention.value",
           "out": "attention.output.dense", "fc1": "intermediate.dense",
           "fc2": "output.dense"}
    return _vit_state(rng, {
        "embed": lambda d, pt, g: {
            p + "embeddings.cls_token": (1, 1, d),
            p + "embeddings.position_embeddings": (1, g * g + 1, d),
            p + "embeddings.patch_embeddings.projection.weight":
                (d, 3, pt, pt),
            p + "embeddings.patch_embeddings.projection.bias": (d,)},
        "block": lambda i, d: {
            **{f"{p}encoder.layer.{i}.{n}.{wb}": (d,)
               for n in ("layernorm_before", "layernorm_after")
               for wb in ("weight", "bias")},
            **{f"{p}encoder.layer.{i}.{v}.weight":
               ((4 * d, d) if k == "fc1" else (d, 4 * d) if k == "fc2"
                else (d, d)) for k, v in lin.items()},
            **{f"{p}encoder.layer.{i}.{v}.bias":
               ((4 * d,) if k == "fc1" else (d,)) for k, v in lin.items()}}})


def hub_state(seed=0, prefix=""):
    s = rs.dinov2_hub_state(dim=32, depth=2, patch=8, grid=4, seed=seed)
    return {prefix + k: v for k, v in s.items()}


@pytest.fixture(scope="module")
def hf_states():
    """Tiny HF GroundingDINO and SAM state dicts (random init), numpy."""
    from transformers import (BertConfig, GroundingDinoConfig,
                              GroundingDinoForObjectDetection, SamConfig,
                              SamModel, SwinConfig)
    from transformers.models.sam.configuration_sam import (
        SamMaskDecoderConfig, SamPromptEncoderConfig, SamVisionConfig)

    torch.manual_seed(0)
    swin = SwinConfig(image_size=64, patch_size=4, embed_dim=8,
                      depths=[1, 2, 1, 1], num_heads=[1, 2, 4, 8],
                      window_size=2,
                      out_features=["stage2", "stage3", "stage4"])
    bert = BertConfig(vocab_size=60, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=40)
    gd = GroundingDinoForObjectDetection(GroundingDinoConfig(
        backbone_config=swin, text_config=bert, d_model=32,
        encoder_layers=2, decoder_layers=2, num_queries=16,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_feature_levels=4,
        encoder_n_points=2, decoder_n_points=2, max_text_len=32))
    sam = SamModel(SamConfig(
        vision_config=SamVisionConfig(hidden_size=16, output_channels=32,
                                      num_hidden_layers=1,
                                      num_attention_heads=2, image_size=64,
                                      patch_size=8, num_pos_feats=16),
        prompt_encoder_config=SamPromptEncoderConfig(
            hidden_size=32, image_embedding_size=8, image_size=64,
            mask_input_channels=8),
        mask_decoder_config=SamMaskDecoderConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            mlp_dim=64, iou_head_hidden_dim=32)))
    return ({k: v.numpy() for k, v in gd.state_dict().items()},
            {k: v.numpy() for k, v in sam.state_dict().items()})


# (name, state maker, JAX function, port function): each takes the state.
CASES = {
    "dinov2": (lambda: hub_state(),
               lambda m, s: m.convert_dinov2_vit(s, depth=2)),
    "dinov2_final_norm": (
        lambda: hub_state(1),
        lambda m, s: m.convert_dinov2_vit(s, depth=2, final_norm=True)),
    "hf_dinov2_to_hub": (
        lambda: rs.depth_pro_state(seed=2, **DEPTH_KW),
        lambda m, s: m.hf_dinov2_to_hub(
            s, "depth_pro.encoder.image_encoder.model.")),
    "clip": (lambda: clip_state(np.random.default_rng(3)),
             lambda m, s: m.convert_clip_vit(s)),
    "mae": (lambda: mae_state(np.random.default_rng(4)),
            lambda m, s: m.convert_mae_vit(s)),
    "midas": (lambda: hub_state(5, "pretrained.model."),
              lambda m, s: m.convert_midas_vit(s)),
    "depth_fusion": (
        lambda: rs.lift_state(lift_cfg(), seed=6),
        lambda m, s: m.convert_depth_fusion(s, "backbone.net.depth_fusion.")),
}
LIFT_CASES = {
    "sfp": ((4.0, 2.0, 1.0, 0.5), True,
            lambda m, s, c: m.convert_sfp(s, c.backbone.scale_factors, 14)),
    "rpn_head": ((2.0, 1.0, 0.5), True,
                 lambda m, s, c: m.convert_rpn_head(s)),
    "box_head": ((2.0, 1.0, 0.5), True,
                 lambda m, s, c: m.convert_box_head(s)),
    "cube_head_shared": ((2.0, 1.0, 0.5), True,
                         lambda m, s, c: m.convert_cube_head(s)),
    "cube_head_unshared": ((2.0, 1.0, 0.5), False,
                           lambda m, s, c: m.convert_cube_head(
                               s, shared_fc=False)),
    "extract_priors": ((2.0, 1.0, 0.5), True,
                       lambda m, s, c: m.extract_priors(s)),
    "ovmono3d_lift": ((2.0, 1.0, 0.5), True,
                      lambda m, s, c: m.convert_ovmono3d_lift(s, depth=2)),
    "ovmono3d_lift_up4": ((4.0, 2.0, 1.0, 0.5), False,
                          lambda m, s, c: m.convert_ovmono3d_lift(
                              s, depth=2, scale_factors=(4.0, 2.0, 1.0, 0.5),
                              shared_fc=False)),
}
GDINO_CASES = {
    "swin": lambda m, s: m.convert_swin(s, depths=(1, 2, 1, 1)),
    "bert": lambda m, s: m.convert_bert(s, layers=2),
    "transformer": lambda m, s: m.convert_transformer(s, 2, 2),
    "groundingdino": lambda m, s: m.convert_groundingdino(s),
}
SAM_CASES = {
    "sam_encoder": lambda m, s: m.convert_sam_encoder(s, depth=3),
    "sam_segmenter": lambda m, s: m.convert_sam_segmenter(s),
}


def _pair(name):
    """(the JAX converter module, the port's) holding `name`'s function."""
    for j, t in ((jcc, tcc), (jlc, tlc), (jgc, tgc), (jsc, tsc), (jdc, tdc)):
        if hasattr(j, name):
            return j, t
    raise KeyError(name)


def check_same(jfn, tfn, state):
    """Equal trees on the seeded state, and the same outcome with a key
    dropped, an extra key and one tensor misshapen."""
    assert_trees_equal(tfn(dict(state)), jfn(dict(state)))
    keys = sorted(state)
    rng = np.random.default_rng(len(keys))
    drop = keys[int(rng.integers(len(keys)))]
    bad = keys[int(rng.integers(len(keys)))]
    variants = [
        {k: v for k, v in state.items() if k != drop},
        {**state, "unexpected.extra.weight": np.ones(3, np.float32)},
        {**state, bad: np.zeros(np.asarray(state[bad]).shape + (2,),
                                np.float32)},
    ]
    for v in variants:
        outs = []
        for fn in (jfn, tfn):
            try:
                outs.append(fn(dict(v)))
            except Exception as exc:    # noqa: BLE001 -- compared below
                outs.append(type(exc))
        if isinstance(outs[0], type):
            assert outs[1] is outs[0]
        else:
            assert_trees_equal(outs[1], outs[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_trunk_converters_match_jax(case):
    make, call = CASES[case]
    state = make()
    fname = {"dinov2_final_norm": "convert_dinov2_vit",
             "dinov2": "convert_dinov2_vit", "clip": "convert_clip_vit",
             "mae": "convert_mae_vit", "midas": "convert_midas_vit",
             "hf_dinov2_to_hub": "hf_dinov2_to_hub",
             "depth_fusion": "convert_depth_fusion"}[case]
    j, t = _pair(fname)
    check_same(lambda s: call(j, s), lambda s: call(t, s), state)


# The port's one departure from the JAX LIFT converter (ROADMAP, the
# reference's features): the box and cube heads' fc1 input rows permuted from
# detectron2's (C, H, W) flattening to the pooled grid's (H, W, C). These are
# exactly the leaves where the two trees differ, by case.
_UNSHARED_FC1 = tuple(f"{n}_fc1/kernel"
                      for n in ("xy", "dims", "pose", "z", "conf"))
FC1_KEYS = {
    "box_head": ("fc1/kernel",),
    "cube_head_shared": ("shared_fc1/kernel",),
    "cube_head_unshared": _UNSHARED_FC1,
    "ovmono3d_lift": ("box_head/fc1/kernel", "cube_head/shared_fc1/kernel"),
    "ovmono3d_lift_up4": ("box_head/fc1/kernel",
                          *(f"cube_head/{k}" for k in _UNSHARED_FC1)),
}


def chw_to_hwc_rows(kernel, resolution=7):
    """A [C * R * R, out] kernel's rows from (C, H, W) to (H, W, C) order;
    a kernel of another rank raises, as the port's converter does."""
    k = np.asarray(kernel)
    if k.ndim != 2:
        raise ValueError(f"fc1 kernel of shape {k.shape}")
    c = k.shape[0] // resolution**2
    return np.ascontiguousarray(
        k.reshape(c, resolution, resolution, -1).transpose(1, 2, 0, 3)
        .reshape(k.shape))


def with_hwc_fc1(tree, keys):
    """`tree` with the leaves at `keys` (flat paths) through chw_to_hwc_rows."""
    out = {k: (with_hwc_fc1(v, [p.split("/", 1)[1] for p in keys
                                if p.split("/", 1)[0] == k])
               if isinstance(v, dict) else v) for k, v in tree.items()}
    for p in keys:
        if "/" not in p:
            out[p] = chw_to_hwc_rows(tree[p])
    return out


@pytest.mark.parametrize("case", sorted(LIFT_CASES))
def test_lift_converters_match_jax(case):
    scales, shared, call = LIFT_CASES[case]
    cfg = lift_cfg(scales, shared, priors=True, bins=3)
    state = rs.lift_state(cfg, seed=7)
    keys = FC1_KEYS.get(case, ())
    check_same(lambda s: with_hwc_fc1(call(jlc, s, cfg), keys),
               lambda s: call(tlc, s, cfg), state)


def test_extract_priors_without_priors_is_none():
    assert tlc.extract_priors({"other": np.zeros(1)}) is None
    assert jlc.extract_priors({"other": np.zeros(1)}) is None


@pytest.mark.parametrize("case", sorted(GDINO_CASES))
def test_gdino_converters_match_jax(case):
    call = GDINO_CASES[case]
    state = rs.gdino_state(seed=8, **GDINO_KW)
    check_same(lambda s: call(jgc, s), lambda s: call(tgc, s), state)


@pytest.mark.parametrize("case", sorted(SAM_CASES))
def test_sam_converters_match_jax(case):
    call = SAM_CASES[case]
    state = rs.sam_state(seed=9, **SAM_KW)
    check_same(lambda s: call(jsc, s), lambda s: call(tsc, s), state)


@pytest.mark.parametrize("fov", [True, False], ids=["fov", "no_fov"])
def test_depth_pro_converter_matches_jax(fov):
    state = rs.depth_pro_state(seed=10, use_fov=fov, **DEPTH_KW)
    check_same(jdc.convert_depth_pro, tdc.convert_depth_pro, state)


@pytest.mark.parametrize("name", ["dinov2", "clip", "mae", "midas", "sam"])
@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "wrapped"])
def test_vit_trunk_dispatch_matches_jax(name, wrapped):
    rng = np.random.default_rng(11)
    state = {
        "dinov2": lambda: hub_state(11),
        "clip": lambda: clip_state(rng, "visual." if wrapped else ""),
        "mae": lambda: mae_state(rng, "vit." if wrapped else ""),
        "midas": lambda: hub_state(12, "pretrained.model." if wrapped
                                   else ""),
        "sam": lambda: {
            (k if wrapped else k[len("image_encoder."):]): v
            for k, v in rs.sam_state(seed=13, **SAM_KW).items()
            if k.startswith("image_encoder.")},
    }[name]()
    check_same(lambda s: jcnn._convert_vit_trunk(s, name),
               lambda s: tcnn._convert_vit_trunk(s, name), state)


def test_hf_gdino_shim_matches_jax(hf_states):
    gd, _ = hf_states
    check_same(lambda s: jhf.hf_gdino_to_original_keys(s, (1, 2, 1, 1), 2, 2),
               lambda s: thf.hf_gdino_to_original_keys(s, (1, 2, 1, 1), 2, 2),
               gd)


def test_hf_sam_shim_matches_jax(hf_states):
    _, sam = hf_states
    check_same(jhf.hf_sam_to_original_keys, thf.hf_sam_to_original_keys, sam)


def test_deconv_layout_round_trips_asymmetric_kernels():
    """_deconv flips the IOHW kernel spatially; the bridge flips it back: a
    ConvTranspose2d loaded from the converted tree holds the checkpoint's
    weight unflipped (a symmetric kernel would hide a missing flip)."""
    from torch import nn

    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

    w = np.arange(3 * 5 * 2 * 3, dtype=np.float32).reshape(3, 5, 2, 3)
    conv = nn.ConvTranspose2d(3, 5, (2, 3))
    load_flax_params(conv, {"kernel": tcc._deconv(w),
                            "bias": np.zeros(5, np.float32)})
    np.testing.assert_array_equal(conv.weight.detach().numpy(), w)
    np.testing.assert_array_equal(tcc._deconv(w), jcc._deconv(w))


# -- detectron2's head semantics on released-layout weights -----------------

def _d2_linear(state, key, x):
    return torch.nn.functional.linear(
        x, torch.from_numpy(np.asarray(state[key + ".weight"])),
        torch.from_numpy(np.asarray(state[key + ".bias"])))


def _d2_head_input(state, pooled_nchw, prefix, num_conv):
    """detectron2's conv stack (3x3, padding 1, ReLU) on the pooled
    [N, C, R, R] features, then `torch.flatten(x, 1)`: (C, H, W) order."""
    x = pooled_nchw
    for i in range(num_conv):
        x = torch.relu(torch.nn.functional.conv2d(
            x, torch.from_numpy(state[f"{prefix}conv{i + 1}.weight"]),
            torch.from_numpy(state[f"{prefix}conv{i + 1}.bias"]),
            padding=1))
    return torch.flatten(x, 1)


def _pooled(n, c, r=7, seed=0):
    """Pooled features [N, C, R, R] (detectron2's layout) and the same
    values as the port's [N, R, R, C]."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, c, r, r)).astype(np.float32))
    return x, x.permute(0, 2, 3, 1).contiguous()


def test_box_head_computes_detectron2s_function():
    """FastRCNNConvFCHead (flatten, fc1, fc2, ReLUs) and its predictors on a
    released-layout state dict, against the port's FastRCNNHead on the
    converted tree with the same pooled features in NHWC."""
    from ovmono3d_tpu_torch.models.heads import FastRCNNHead
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

    cfg = lift_cfg()
    state = rs.lift_state(cfg, seed=12)
    c = cfg.backbone.out_channels
    nchw, nhwc = _pooled(5, c)
    x = _d2_head_input(state, nchw, "", 0)
    for j in (1, 2):
        x = torch.relu(_d2_linear(state, f"roi_heads.box_head.fc{j}", x))
    want = (_d2_linear(state, "roi_heads.box_predictor.cls_score", x),
            _d2_linear(state, "roi_heads.box_predictor.bbox_pred", x))
    head = FastRCNNHead(c * 49, cfg.num_classes, fc_dim=cfg.roi_box.fc_dim)
    load_flax_params(head, tlc.convert_box_head(state))
    with torch.no_grad():
        got = head(nhwc)
    for g, w in zip(got, want):
        # f32 on both sides; the products sum in the same order.
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # The JAX converter's tree (fc1 transposed only) gives another function.
    load_flax_params(head, jlc.convert_box_head(state))
    with torch.no_grad():
        assert not np.allclose(head(nhwc)[0].numpy(), want[0].numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("num_conv", [0, 2])
def test_cube_head_computes_detectron2s_function(num_conv):
    """The cube head (convs, flatten, shared fc stack, outputs) on a
    released-layout state dict, against the port's CubeHead on the converted
    tree: with num_conv > 0 fc1 reads the conv stack's [N, conv_dim, R, R]
    output, still flattened in (C, H, W) order."""
    from ovmono3d_tpu_torch.models.heads import CubeHead
    from ovmono3d_tpu_torch.ops.rotation import rotation_6d_to_matrix
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

    cfg = lift_cfg()
    c, conv_dim, fc_dim = cfg.backbone.out_channels, 8, cfg.cube.fc_dim
    p = "roi_heads.cube_head."
    state = dict(rs.lift_state(cfg, seed=13))
    rng = np.random.default_rng(14)
    cin = c
    for i in range(num_conv):
        state[f"{p}conv{i + 1}.weight"] = (rng.standard_normal(
            (conv_dim, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
        state[f"{p}conv{i + 1}.bias"] = (0.02 * rng.standard_normal(
            conv_dim)).astype(np.float32)
        cin = conv_dim
    if num_conv:
        state[f"{p}feature_generator.fc1.weight"] = (rng.standard_normal(
            (fc_dim, conv_dim * 49)) / np.sqrt(conv_dim * 49)).astype(
                np.float32)
    nchw, nhwc = _pooled(5, c, seed=1)
    x = _d2_head_input(state, nchw, p, num_conv)
    for j in (1, 2):
        x = torch.relu(_d2_linear(state, f"{p}feature_generator.fc{j}", x))
    want = {"deltas_2d": _d2_linear(state, p + "bbox_3D_center_deltas", x),
            "dims": _d2_linear(state, p + "bbox_3D_dims", x),
            "z": _d2_linear(state, p + "bbox_3D_center_depth", x)[:, 0],
            "uncert": _d2_linear(state, p + "bbox_3D_uncertainty",
                                 x)[:, 0].clamp(min=0.01),
            "pose": rotation_6d_to_matrix(
                _d2_linear(state, p + "bbox_3D_pose", x))}
    head = CubeHead(c, 7, cfg.num_classes, num_conv=num_conv,
                    conv_dim=conv_dim, fc_dim=fc_dim)
    tree = tlc.convert_cube_head(state)
    for i in range(num_conv):
        tree[f"conv{i + 1}"] = {
            "kernel": tcc._conv(state[f"{p}conv{i + 1}.weight"]),
            "bias": state[f"{p}conv{i + 1}.bias"]}
    load_flax_params(head, tree)
    with torch.no_grad():
        got = head(nhwc)
    for k, w in want.items():
        # f32 on both sides.
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
