"""The port's remaining detector trunks against the JAX package, on the same
bridged weights and numpy-seeded inputs (CPU): the CLIP, MAE, MiDaS and SAM
ViT presets through the Simple Feature Pyramid in f32 and bf16; the DLA,
ResNet, DenseNet, MNASNet and ShuffleNetV2 trunks and the FPN with their
BatchNorm statistics randomised; each CNN converter against the JAX one; an
oracle RCNN3D with a DLA backbone; and one SGD step with a tiny CNN trunk,
frozen and unfrozen, against the JAX train step."""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model import _gt, tiny_config
from test_torch_convert import check_same
from test_torch_rcnn3d import port_config, training_tree
from test_torch_train_ops import jax_draws
from test_torch_train_step import port_config_solver

from ovmono3d_tpu import config as jconfig
from ovmono3d_tpu.models import backbones as jbackbones
from ovmono3d_tpu.models import cnns as jcnns
from ovmono3d_tpu.models import dla as jdla
from ovmono3d_tpu.models import resnet as jresnet
from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu.models.vit import resize_pos_embed as jax_resize_pos_embed
from ovmono3d_tpu.parallel import train_step as jts
from ovmono3d_tpu.train import optim as joptim
from ovmono3d_tpu.utils import cnn_convert as jcnn
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.models import backbones as tbackbones
from ovmono3d_tpu_torch.models import cnns as tcnns
from ovmono3d_tpu_torch.models import dla as tdla
from ovmono3d_tpu_torch.models import resnet as tresnet
from ovmono3d_tpu_torch.models.layers import FrozenBatchNorm2d, init_seeded
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.models.vit import resize_pos_embed
from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
from ovmono3d_tpu_torch.train import optim as toptim
from ovmono3d_tpu_torch.utils import cnn_convert as tcnn
from ovmono3d_tpu_torch.utils import flax_bridge
from ovmono3d_tpu_torch.utils import release_states as rs

torch.set_num_threads(2)

# Tiny widths of the presets whose widths are fixed: MiDaS's ViT-L and
# DLA-34's channels (the converters and the factories read the presets).
TINY_MIDAS = dict(embed_dim=32, depth=2, num_heads=2)
TINY_DLA34 = dict(levels=(1, 1, 1, 1, 1, 1), channels=(4, 4, 8, 8, 8, 16))


@pytest.fixture
def tiny_presets(monkeypatch):
    """MiDaS and DLA-34 at tiny widths in both packages."""
    for presets in (jbackbones.VIT_PRESETS, tbackbones.VIT_PRESETS):
        monkeypatch.setitem(presets, "midas",
                            {**presets["midas"], **TINY_MIDAS})
    for presets in (jdla.DLA_PRESETS, tdla.DLA_PRESETS):
        monkeypatch.setitem(presets, "dla34",
                            {**presets["dla34"], **TINY_DLA34})


def seeded_variables(module, *args, seed=0):
    """`module`'s variables from numpy, traced but not compiled (jit of a
    flax init compiles every initializer): kernels ~N(0, 1/fan_in), tables
    ~N(0, 0.02^2), the rest as `perturbed` draws them."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        fan_in = int(np.prod(x.shape[:-1])) if path[-1].key == "kernel" \
            else 2500
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return perturbed(jax.tree_util.tree_map_with_path(draw, shapes), seed)


def both_configs(**kw):
    """The same backbone config in both packages."""
    return jconfig.BackboneConfig(**kw), tcfg.BackboneConfig(**kw)


def perturbed(variables, seed=0):
    """numpy variables moved off flax's init so every part shows in the
    outputs: scales 1 + N(0, 0.1^2), biases and rel-pos tables N(0, 0.1^2)
    (zero at init), BatchNorm means N(0, 0.1^2) and variances U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def fix(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name in ("bias", "rel_pos_h", "rel_pos_w", "mean"):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fix, variables)


def close(got, want, tol, name=""):
    """Within `tol` of the reference's own scale."""
    w = np.asarray(want, np.float32)
    g = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    assert np.isfinite(g).all(), name
    np.testing.assert_allclose(g, w, rtol=tol,
                               atol=tol * float(np.abs(w).max()),
                               err_msg=name)


# -- the ViT presets through the SFP -----------------------------------------

VIT_IMG = 96            # a 6x6 grid of 16-pixel patches
VIT_SCALES = (4.0, 2.0, 1.0, 0.5)


def _vit_pair(name, dtype, monkeypatch):
    jcfg, pcfg = both_configs(name=name, embed_dim=32, depth=3, num_heads=2,
                              out_channels=16, use_depth_fusion=False,
                              scale_factors=VIT_SCALES)
    if dtype == torch.float32:
        # The JAX backbone passes no dtype: its preset and pyramid carry it.
        monkeypatch.setitem(jbackbones.VIT_PRESETS, name, {
            **jbackbones.VIT_PRESETS[name], "dtype": jnp.float32})
        monkeypatch.setattr(jbackbones, "SimpleFeaturePyramid",
                            functools.partial(jbackbones.SimpleFeaturePyramid,
                                              dtype=jnp.float32))
    image = np.random.default_rng(1).standard_normal(
        (2, VIT_IMG, VIT_IMG, 3)).astype(np.float32)
    jmodel = jbackbones.build_backbone(jcfg)
    params = seeded_variables(jmodel, jnp.asarray(image))
    port = tbackbones.ViTSFPBackbone(pcfg, dtype=dtype, device="cpu")
    flax_bridge.load_flax_params(port, params)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(image))
    with torch.inference_mode():
        got = port(torch.from_numpy(image))
    return port, want, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["clip", "mae", "midas", "sam"])
def test_vit_preset_matches_jax(name, dtype, tiny_presets, monkeypatch):
    """CLIP (ln_pre, QuickGELU, the size-based resize 14 -> 6), MAE (the
    sin-cos table at the grid, eps 1e-12, block 1's output tapped), MiDaS
    (24 -> 6) and SAM (windowed and global rel-pos blocks, no cls token,
    the 256-channel neck, 64 -> 6) with the four pyramid stages."""
    port, want, got = _vit_pair(name, dtype, monkeypatch)
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5"]
    assert port.strides == [4, 8, 16, 32]
    if name == "mae":
        assert port.tap_layer == 1 and port.vit.pos_embed is None
    # f32 on both sides: products summed in another order. bf16: the two
    # frameworks round at different places in every block; the pyramid's
    # maps, like tests/test_torch_sam.py's bf16 encoder, within 3e-2 of
    # their scale.
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for key in want:
        close(got[key], want[key], tol, key)


@pytest.mark.parametrize("grid", [(6, 6), (9, 11), (20, 20), (14, 14)])
def test_size_based_resize_matches_jax(grid):
    """interpolate_offset 0: F.interpolate(size=...)'s bicubic weights, down
    and up, against the JAX module's torch-exact matrices."""
    pe = np.random.default_rng(2).normal(0, 0.02, (1, 1 + 14 * 14, 16)
                                         ).astype(np.float32)
    want = jax_resize_pos_embed(jnp.asarray(pe), grid, 0.0)
    got = resize_pos_embed(torch.from_numpy(pe), grid, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_presets_and_names_match_jax():
    assert tbackbones.VIT_PRESETS == jbackbones.VIT_PRESETS
    assert tdla.DLA_PRESETS == jdla.DLA_PRESETS
    assert set(tbackbones.CNN_NAMES) == set(jbackbones._CNN_NAMES)
    with pytest.raises(ValueError, match="unknown backbone"):
        tbackbones.build_backbone(tcfg.BackboneConfig(name="resnet99"))


# -- the CNN trunks and the FPN ----------------------------------------------

# (JAX module, port module, image side): tiny widths where the module takes
# them, the fixed torchvision layouts otherwise.
CNN_TRUNKS = {
    "dla_basic": (
        lambda: jdla.DLA(levels=(1, 1, 1, 2, 1, 1),
                         channels=(4, 8, 8, 16, 16, 32)),
        lambda: tdla.DLA(levels=(1, 1, 1, 2, 1, 1),
                         channels=(4, 8, 8, 16, 16, 32)), 64),
    "dla_bottleneck": (
        lambda: jdla.DLA(levels=(1, 1, 1, 3, 1, 1),
                         channels=(4, 8, 16, 16, 32, 32), block="bottleneck",
                         root_residual=True),
        lambda: tdla.DLA(levels=(1, 1, 1, 3, 1, 1),
                         channels=(4, 8, 16, 16, 32, 32), block="bottleneck",
                         root_residual=True), 64),
    "dla_bottleneckx": (
        lambda: jdla.DLA(levels=(1, 1, 2, 1, 1, 1),
                         channels=(8, 16, 32, 32, 64, 64),
                         block="bottleneckx", cardinality=8),
        lambda: tdla.DLA(levels=(1, 1, 2, 1, 1, 1),
                         channels=(8, 16, 32, 32, 64, 64),
                         block="bottleneckx", cardinality=8), 64),
    "resnet_bottleneck": (
        lambda: jresnet.ResNet(depths=(1, 1, 1, 1), width=8),
        lambda: tresnet.ResNet((1, 1, 1, 1), width=8), 96),
    "resnet_basic": (
        lambda: jresnet.ResNet(depths=(1, 1, 1, 1), width=8,
                               bottleneck=False),
        lambda: tresnet.ResNet((1, 1, 1, 1), width=8, bottleneck=False), 96),
    "densenet": (
        lambda: jcnns.DenseNet(block_layers=(1, 2, 2, 1), growth=8,
                               init_features=16),
        lambda: tcnns.DenseNet((1, 2, 2, 1), growth=8, init_features=16), 96),
    "mnasnet": (jcnns.MNASNet, tcnns.MNASNet, 96),
    "shufflenet": (jcnns.ShuffleNetV2, tcnns.ShuffleNetV2, 96),
}


@pytest.mark.parametrize("family", sorted(CNN_TRUNKS))
def test_cnn_trunk_matches_jax(family):
    """Every p2-p6 map, f32 on both sides (zero-padded stem pools, floor
    pooling of odd maps, grouped and depthwise convs, the channel shuffle)."""
    jmake, tmake, side = CNN_TRUNKS[family]
    image = np.random.default_rng(3).standard_normal(
        (2, side, side, 3)).astype(np.float32)
    jtrunk = jmake()
    variables = seeded_variables(jtrunk, jnp.asarray(image), seed=4)
    port = tmake()
    flax_bridge.load_flax_params(port, variables)
    want = jax.jit(jtrunk.apply)(variables, jnp.asarray(image))
    with torch.inference_mode():
        got = port(torch.from_numpy(image).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    assert {k: v.shape[1] for k, v in got.items()} == port.out_channels
    for key in want:
        # f32 convs in two libraries: 1e-4 of each map's scale.
        close(got[key].permute(0, 2, 3, 1), want[key], 1e-4, key)


def test_fpn_matches_jax_with_uneven_ratios():
    """The top-down upsample at 3 -> 5 and 2 -> 3 (not a ratio of 2):
    jax.image.resize "nearest" is F.interpolate's "nearest-exact"; plain
    "nearest" gives another map."""
    rng = np.random.default_rng(5)
    sizes = {"p2": 20, "p3": 10, "p4": 5, "p5": 3, "p6": 2}
    chans = {"p2": 4, "p3": 6, "p4": 8, "p5": 8, "p6": 8}
    feats = {n: rng.standard_normal((1, s, s, chans[n])).astype(np.float32)
             for n, s in sizes.items()}
    jfpn = jdla.FPN(out_channels=8)
    params = seeded_variables(jfpn, {k: jnp.asarray(v)
                                     for k, v in feats.items()})
    want = jax.jit(jfpn.apply)(params, {k: jnp.asarray(v)
                                        for k, v in feats.items()})
    port = tdla.FPN(chans, 8)
    flax_bridge.load_flax_params(port, params)
    nchw = {k: torch.from_numpy(v).permute(0, 3, 1, 2)
            for k, v in feats.items()}
    with torch.no_grad():
        got = port(nchw)
    for key in want:
        close(got[key].permute(0, 2, 3, 1), want[key], 1e-5, key)
    # The control: the same top-down path with plain "nearest".
    up = functools.partial(torch.nn.functional.interpolate, mode="nearest")
    with torch.no_grad():
        p5 = port.lateral_p5(nchw["p5"]) + up(port.lateral_p6(nchw["p6"]),
                                              size=(3, 3))
        p4 = port.lateral_p4(nchw["p4"]) + up(p5, size=(5, 5))
        plain = port.output_p4(p4).permute(0, 2, 3, 1)
    assert not np.allclose(plain.numpy(), np.asarray(want["p4"]), atol=1e-3)


def test_frozen_batchnorm_ignores_train_mode():
    """train() switches no BatchNorm to batch statistics and updates no
    buffer; the output is the running statistics' in both modes."""
    bn = FrozenBatchNorm2d(3)
    bn.init_weights()
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -1.0, 2.0]))
        bn.running_var.copy_(torch.tensor([4.0, 0.25, 1.0]))
    x = torch.randn(2, 3, 4, 4)
    before = [b.clone() for b in bn.buffers()]
    out_eval = bn.eval()(x)
    out_train = bn.train()(x)
    assert torch.equal(out_eval, out_train)
    assert all(torch.equal(a, b) for a, b in zip(before, bn.buffers()))
    want = (x - bn.running_mean[:, None, None]) / torch.sqrt(
        bn.running_var[:, None, None] + 1e-5)
    torch.testing.assert_close(out_train, want, rtol=1e-6, atol=1e-6)


# -- the CNN converters and --trunk-ckpt -------------------------------------

CONVERTER_CASES = {
    "dla_basic": (lambda: rs.dla_state((1, 1, 1, 2, 2, 1),
                                       (4, 8, 8, 16, 16, 32), seed=6),
                  lambda m, s: m.convert_dla(s, (1, 1, 1, 2, 2, 1), "basic")),
    "dla_bottleneckx": (
        lambda: rs.dla_state((1, 1, 2, 3, 1, 1), (8, 16, 32, 32, 64, 64),
                             "bottleneckx", 8, seed=7),
        lambda m, s: m.convert_dla(s, (1, 1, 2, 3, 1, 1), "bottleneckx")),
    "resnet_bottleneck": (
        lambda: rs.resnet_state((1, 2, 1, 1), width=8, seed=8),
        lambda m, s: m.convert_resnet(s, (1, 2, 1, 1))),
    "resnet_basic": (
        lambda: rs.resnet_state((2, 1, 1, 1), False, width=8, seed=9),
        lambda m, s: m.convert_resnet(s, (2, 1, 1, 1), bottleneck=False)),
    "densenet": (lambda: rs.densenet_state((1, 2, 2, 1), 8, 16, seed=10),
                 lambda m, s: m.convert_densenet(s, (1, 2, 2, 1))),
    "mnasnet": (lambda: rs.mnasnet_state(seed=11), lambda m, s:
                m.convert_mnasnet(s)),
    "shufflenet": (lambda: rs.shufflenet_state(seed=12), lambda m, s:
                   m.convert_shufflenet(s)),
}


@pytest.mark.parametrize("case", sorted(CONVERTER_CASES))
def test_cnn_converter_matches_jax(case):
    """Equal {params, batch_stats} trees on the seeded released layout, and
    the same outcome with a key dropped, an extra key and a misshapen
    tensor."""
    make, call = CONVERTER_CASES[case]
    check_same(lambda s: call(jcnn, s), lambda s: call(tcnn, s), make())


VIT_STATES = {
    "clip": lambda: rs.clip_visual_state(shape_only=True),
    "mae": lambda: rs.mae_state(shape_only=True),
    "midas": lambda: rs.midas_state(shape_only=True),
    "sam": lambda: rs.sam_state(**tbackbones.SAM_ARCHS["vit_b"],
                                shape_only=True),
    "dinov2": lambda: rs.dinov2_hub_state(shape_only=True),
}


def cnn_state(name, shape_only=True, seed=0):
    """A released-layout state of backbone `name` (aliases included)."""
    name = "dla34" if name == "dla" else name
    if name in tdla.DLA_PRESETS:
        return rs.dla_state(**tdla.DLA_PRESETS[name], shape_only=shape_only,
                            seed=seed)
    if name.startswith("resnet"):
        return rs.resnet_state(tcnn.RESNET_DEPTHS[name],
                               name not in ("resnet18", "resnet34"),
                               shape_only=shape_only, seed=seed)
    make = {"densenet": rs.densenet_state, "densenet121": rs.densenet_state,
            "mnasnet": rs.mnasnet_state, "mnasnet1_0": rs.mnasnet_state,
            "shufflenet": rs.shufflenet_state,
            "shufflenet_v2": rs.shufflenet_state}[name]
    return make(shape_only=shape_only, seed=seed)


# The keys of each released layout a trunk's converter leaves unread.
TRUNK_IGNORED = {**{n: rs.IGNORED[n] for n in ("clip", "mae", "midas",
                                               "dinov2")},
                 "sam": (r"^prompt_encoder\.", r"^mask_decoder\.")}


@pytest.mark.parametrize("name", [*tbackbones.CNN_NAMES,
                                  *tbackbones.VIT_PRESETS])
def test_every_trunk_name_loads_at_full_width(name):
    """Every backbone name the factory takes has its converter, and the
    released layout maps onto the full-width trunk strictly (every parameter
    and BatchNorm buffer filled, shapes checked) through load_cnn_trunk's
    own dispatch (on meta: shapes only); the state's elements, less the keys
    the converter leaves unread (`release_states.IGNORED`), equal the
    tree's, so no released tensor is dropped unnoticed."""
    cfg = tcfg.BackboneConfig(name=name, use_depth_fusion=name == "dinov2")
    model = build_model(dataclasses.replace(tcfg.ModelConfig(), backbone=cfg),
                        device="meta")
    loaded = []
    real = tcnn.load_flax_params

    def plan_only(module, tree, keep=()):
        loaded.append(len(flax_bridge.plan(module, tree, keep)))

    tcnn.load_flax_params = plan_only
    try:
        state = (VIT_STATES[name]() if name in VIT_STATES
                 else cnn_state(name))
        tcnn.load_cnn_trunk(model, state, name)
    finally:
        tcnn.load_flax_params = real
    trunk = model.backbone.trunk
    n = len(dict(trunk.named_parameters())) + len(dict(trunk.named_buffers()))
    keep = 2 if name == "dinov2" else 0        # the depth-fusion conv
    assert loaded == [n - keep]
    ignored = TRUNK_IGNORED.get(name, rs.IGNORED["cnn"])
    read = sum(int(np.prod(np.shape(v))) for k, v in state.items()
               if not any(re.search(p, k) for p in ignored))
    # CLIP's conv1 has no bias: the converter makes a zero one.
    made = ("patch_embed/bias",) if name == "clip" else ()
    tree = tcnn.convert_trunk(state, name)[1]
    assert read == sum(int(np.prod(np.shape(v))) for k, v in
                       flax_bridge._leaves(tree).items() if k not in made)


# -- --trunk-ckpt at tiny widths (tests/test_torch_load.py, test_torch_train
# _cli.py) ---------------------------------------------------------------------

def trunk_state(name, bb, seed=0):
    """A tiny seeded trunk of backbone `name` in its released layout, at
    the widths of the BackboneConfig `bb` (MiDaS and DLA-34 at the
    `tiny_presets` widths)."""
    dim, depth = bb.embed_dim, bb.depth
    if name == "clip":
        return rs.clip_visual_state(dim, depth, 16, 14, out_dim=8, seed=seed)
    if name == "mae":
        return rs.mae_state(dim, depth, 16, 14, seed=seed)
    if name == "midas":
        return rs.midas_state(TINY_MIDAS["embed_dim"], TINY_MIDAS["depth"],
                              16, 24, features=8, seed=seed)
    if name == "sam":
        return rs.sam_state(
            embed_dim=dim, depth=depth, num_heads=bb.num_heads,
            global_blocks=tuple(b for b in (2, 5, 8, 11) if b < depth),
            window_size=14, grid=64, patch=16, neck=256, decoder_dim=16,
            decoder_mlp=16, seed=seed)
    return cnn_state(name, shape_only=False, seed=seed)


def trunk_model_config(jcfg, name):
    """tiny_config's model with backbone `name`: a CNN over p2-p6
    (`cnn_model_config`), or a patch-16 ViT preset of two blocks (MAE taps
    block 0) whose pyramid gives the p2-p4 levels the tiny config reads, at
    a 128 square pad."""
    if name not in jbackbones.VIT_PRESETS:
        return cnn_model_config(jcfg, name)
    bb = dataclasses.replace(jcfg.backbone, name=name, depth=2,
                             square_pad=S_CNN, scale_factors=(4.0, 2.0, 1.0),
                             use_depth_fusion=False)
    return dataclasses.replace(jcfg, backbone=bb)


def jax_trunk_tree(variables, trunk):
    """The JAX variables' subtree of backbone/<trunk>, in both
    collections."""
    return {coll: tree["backbone"][trunk] for coll, tree in variables.items()
            if trunk in tree.get("backbone", {})}


def assert_trunk_equal(port, jvariables, keep=()):
    """Every parameter and buffer of the port's trunk equals its leaf of the
    JAX-loaded variables under the bridge's rule, bit for bit."""
    bb = port.backbone
    name = "vit" if hasattr(bb, "vit") else bb.trunk_name
    jtree = jax_trunk_tree(jax.tree.map(np.asarray, jvariables), name)
    if name == "vit":
        jtree = {"params": {k: v for k, v in jtree["params"].items()
                            if k != "depth_fusion"}}
    tensors = {**dict(bb.trunk.named_parameters()),
               **dict(bb.trunk.named_buffers())}
    want = flax_bridge.torch_arrays(bb.trunk, jtree, keep)
    assert len(want) == len(tensors) - len(tuple(keep))
    for key, arr in want.items():
        np.testing.assert_array_equal(tensors[key].detach().numpy(), arr,
                                      err_msg=key)


def jax_init_tree(jcfg):
    """The JAX model's variables as zeros at the 128 square pad (traced,
    not compiled; the trunk loaders replace the trunk's leaves)."""
    model = jax_build_model(jcfg)
    args = (jnp.zeros((1, S_CNN, S_CNN, 3)), jnp.eye(3)[None],
            jnp.full((1, 2), S_CNN, jnp.int32), jnp.ones((1,)))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               *args))
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)


# -- the detector with a CNN trunk -------------------------------------------

S_CNN = 128             # DLA needs a multiple of 64
# XLA:CPU without its expensive LLVM passes: the JAX detector's forward and
# train step compile in a fraction of the time, to the same arithmetic.
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def cnn_model_config(jcfg, name="dla34", freeze=True):
    """tiny_config's model with a CNN backbone over p2-p6 (5-level anchors,
    as tests/test_backbones.py runs it)."""
    bb = dataclasses.replace(jcfg.backbone, name=name, out_channels=32,
                             square_pad=S_CNN, freeze=freeze)
    levels = ("p2", "p3", "p4", "p5", "p6")
    return dataclasses.replace(
        jcfg, backbone=bb,
        anchors=dataclasses.replace(
            jcfg.anchors, sizes=((16.0,), (32.0,), (64.0,), (96.0,),
                                 (112.0,))),
        rpn=dataclasses.replace(jcfg.rpn, in_features=levels),
        roi_box=dataclasses.replace(jcfg.roi_box, in_features=levels))


def to_flax_variables(port, tree, seed=0):
    """The port's parameters and buffers in the flax layout of `tree`
    ({params, batch_stats}), then perturbed (BatchNorm statistics off their
    init)."""
    tensors = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    out: dict = {}
    for path, (full, perm, flip) in flax_bridge.plan(port, tree).items():
        arr = tensors[full].detach().numpy()
        if perm is not None:
            arr = np.transpose(arr, np.argsort(perm))
        if flip:
            arr = arr[::-1, ::-1]
        *mods, leaf = path.split("/")
        if mods[0] != "batch_stats":
            mods = ["params", *mods]
        d = out
        for m in mods:
            d = d.setdefault(m, {})
        d[leaf] = np.array(arr)
    return perturbed(out, seed)


def _cnn_inputs(b=2):
    rng = np.random.default_rng(0)
    image = (rng.random((b, S_CNN, S_CNN, 3)) * 255).astype(np.float32)
    K = np.tile(np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    im_hw = np.array([[128, 128], [112, 96]], np.int32)
    ratio = np.array([2.0, 1.5], np.float32)
    return image, K, im_hw, ratio


def test_rcnn3d_with_dla_backbone_matches_jax(tiny_presets):
    """Oracle inference with the DLA + FPN backbone over p2-p6 (the JAX
    package's tests/test_backbones.py:95 model) at matched weights and
    BatchNorm statistics."""
    jcfg = cnn_model_config(tiny_config().model)
    image, K, im_hw, ratio = _cnn_inputs()
    boxes = np.array([[[10, 10, 50, 50], [30, 20, 90, 80], [0, 0, 20, 20],
                       [60, 60, 120, 110]],
                      [[5, 5, 60, 60], [40, 40, 80, 90], [2, 3, 100, 90],
                       [0, 0, 0, 0]]], np.float32)
    oracle = dict(oracle_boxes=boxes,
                  oracle_classes=np.array([[0, 2, 4, 1], [1, 3, 0, 0]],
                                          np.int32),
                  oracle_scores=np.array([[0.9, 0.8, 0.7, 0.6],
                                          [0.95, 0.6, 0.5, 0.0]], np.float32),
                  oracle_valid=np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool))
    jmodel = jax_build_model(jcfg)
    port = build_model(port_config(jcfg), device="cpu")
    variables = to_flax_variables(port, training_tree(jmodel, image.shape,
                                                      3))
    pose = variables["params"]["cube_head"]["pose"]
    pose["bias"] = np.array([1, 0, 0, 0, 1, 0], np.float32)
    flax_bridge.load_flax_params(port, variables)
    args = tuple(map(jnp.asarray, (image, K, im_hw, ratio)))
    want = jax.jit(jmodel.apply, compiler_options=QUICK)(variables, *args,
                                 **{k: jnp.asarray(v)
                                    for k, v in oracle.items()})
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in (image, K, im_hw, ratio)),
                   **{k: torch.from_numpy(v) for k, v in oracle.items()})
    for field in ("boxes", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    # The trunk and FPN in f32 on both sides; the ROI pooling and the heads
    # read bf16 features (as in the ViT slice): 2e-2 of each field's scale.
    for field in ("scores", "center_cam", "dimensions", "pose", "corners3d"):
        close(getattr(got, field), getattr(want, field), 2e-2, field)


# -- one SGD step with a CNN trunk -------------------------------------------

def _train_batch():
    gt = jax.tree.map(np.array, _gt())
    image, K, im_hw, ratio = _cnn_inputs()
    return {"image": image, "K": K, "im_hw": im_hw, "im_scale_ratio": ratio,
            "gt_boxes": gt.boxes, "gt_classes": gt.classes,
            "gt_boxes3d": gt.boxes3d.astype(np.float32),
            "gt_poses": gt.poses.astype(np.float32), "gt_valid": gt.valid}


@pytest.fixture(params=[True, False], ids=["frozen", "unfrozen"])
def cnn_step(request, tiny_presets):
    """One JAX train step and one port train step of the tiny-DLA model
    from the same weights, BatchNorm statistics, batch and sampling draws
    (the choices of tests/test_torch_train_step.py's slice_pair: the
    objectness kernel zeroed, the head MLPs' biases at 3)."""
    freeze = request.param
    base = tiny_config()
    cfg = dataclasses.replace(
        base, model=cnn_model_config(base.model, freeze=freeze),
        solver=dataclasses.replace(base.solver, base_lr=0.01,
                                   warmup_iters=0, steps=()))
    batch = _train_batch()
    jmodel = jax_build_model(cfg.model)
    tree = training_tree(jmodel, batch["image"].shape,
                         batch["gt_boxes"].shape[1])
    port = build_model(port_config(cfg.model), device="cpu", seed=1)
    variables = to_flax_variables(port, tree, seed=2)
    variables["params"]["rpn_head"]["objectness"]["kernel"] *= 0.0
    for head, fcs in (("box_head", ("fc1", "fc2")),
                      ("cube_head", ("shared_fc1", "shared_fc2"))):
        for fc in fcs:
            variables["params"][head][fc]["bias"] += 3.0
    flax_bridge.load_flax_params(port, variables)

    params = jax.tree.map(jnp.asarray, variables)
    tx = joptim.build_optimizer(cfg.solver, params)
    mask = None
    if freeze:
        mask = joptim.freeze_backbone_mask(params)
        tx = joptim.apply_freeze(tx, mask)
    state = jts.create_train_state(params, tx, jax.random.PRNGKey(2))
    state1, jmetrics = jax.jit(jts.make_train_step(
        jmodel, tx, 0.01, trainable_mask=mask), compiler_options=QUICK)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})

    _, step_rng = jax.random.split(state.rng)
    rng_anchor, rng_prop = jax.random.split(step_rng)
    n_anchors = 3 * sum((S_CNN // s) ** 2 for s in (4, 8, 16, 32, 64))
    n_props = cfg.model.rpn.post_nms_topk_train + batch["gt_boxes"].shape[1]
    draws = {
        "anchor": np.stack([jax_draws(k, n_anchors)
                            for k in jax.random.split(rng_anchor, 2)]),
        "proposal": np.stack([jax_draws(k, n_props)
                              for k in jax.random.split(rng_prop, 2)])}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["draws"] = {k: torch.from_numpy(v) for k, v in draws.items()}
    tensors = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    before = {n: t.detach().clone() for n, t in tensors.items()}
    opt = toptim.Optimizer(port_config_solver(cfg.solver), port)
    _, tmetrics = make_train_step(port, opt, 0.01)(
        create_train_state(port, opt), tbatch)
    return (freeze, variables, jax.tree.map(np.asarray, state1.params),
            jmetrics, tmetrics, port, before)


def test_cnn_train_step_matches_jax(cnn_step):
    """Losses within 1e-2 and each layer's update within 2e-2 of the JAX
    step's (the CNN trunk and the FPN run in f32; the ROI pooling and the
    heads read bf16 features). Frozen, the trunk's parameters and BatchNorm
    statistics stay bit for bit on both sides. Unfrozen, the JAX step also
    moves the running statistics (its optimizer holds the whole variables
    tree, batch_stats included; ROADMAP queue 3) and the port's does the
    same: every trunk parameter and buffer moves, as the JAX one's does."""
    freeze, variables, new, jmetrics, tmetrics, port, before = cnn_step
    for name in ("rpn/cls", "rpn/loc", "box/cls", "box/reg", "cube/loss_z",
                 "cube/loss_dims", "total_loss"):
        want, got = float(jmetrics[name]), float(tmetrics[name])
        assert abs(got - want) <= 1e-2 * abs(want) + 1e-6, (name, got, want)
    assert float(tmetrics["skipped"]) == float(jmetrics["skipped"]) == 0.0
    tensors = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    old, now = (flax_bridge._leaves(variables), flax_bridge._leaves(new))
    groups: dict = {}
    n_moved = 0
    for path, (full, perm, flip) in flax_bridge.plan(port, variables).items():
        d_jax = now[path] - old[path]
        if flip:
            d_jax = d_jax[::-1, ::-1]
        if perm is not None:
            d_jax = np.transpose(d_jax, perm)
        d_port = (tensors[full] - before[full]).detach().numpy()
        if full.startswith("backbone.dla."):
            # (A levels > 1 Tree's `project` is unused: its statistics get
            # no gradient on either side.)
            moved = np.abs(d_port).max() > 0
            assert moved == (np.abs(d_jax).max() > 0), full
            assert not (moved and freeze), full
            n_moved += moved
        key = ".".join(full.split(".")[:3])
        err, ref = groups.get(key, (0.0, 0.0))
        groups[key] = (err + float(((d_port - d_jax) ** 2).sum()),
                       ref + float((d_jax ** 2).sum()))
    for key, (err, ref) in groups.items():
        assert np.sqrt(err) <= 2e-2 * np.sqrt(ref) + 1e-12, (key, err, ref)
    if not freeze:
        labels = toptim.param_group_labels(port)
        stats = [k for k in labels if k.endswith(("running_mean",
                                                  "running_var"))]
        assert stats and {labels[k] for k in stats} == {"norm"}
        assert n_moved > 0.9 * sum(k.startswith("backbone.dla.")
                                   for k in tensors)


def test_checkpoint_restores_batchnorm_buffers(tmp_path, tiny_presets):
    """A train-state checkpoint holds the trunk's BatchNorm statistics: a
    model with other statistics loads them back bit for bit."""
    from ovmono3d_tpu_torch.train.checkpoint import SingleCheckpointer

    cfg = port_config(cnn_model_config(tiny_config().model))
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand_like(buf) + 0.5)
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    opt = toptim.Optimizer(port_config_solver(tiny_config().solver), model)
    SingleCheckpointer(tmp_path).save(create_train_state(model, opt))
    fresh = build_model(cfg, device="cpu")
    opt2 = toptim.Optimizer(port_config_solver(tiny_config().solver), fresh)
    SingleCheckpointer(tmp_path).load(create_train_state(fresh, opt2))
    assert len(bufs) == 2 * sum(isinstance(m, FrozenBatchNorm2d)
                                for m in fresh.modules())
    for name, buf in fresh.named_buffers():
        assert torch.equal(buf, bufs[name]), name


def test_init_covers_buffers():
    """The seeded init fills the BatchNorms: scale 1, bias 0, mean 0, var
    1 (flax's), and a trunk left without its statistics raises."""
    bb = tbackbones.build_backbone(tcfg.BackboneConfig(name="shufflenet"),
                                   device="meta")
    bb = init_seeded(bb, 0)
    for m in bb.modules():
        if isinstance(m, FrozenBatchNorm2d):
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
            assert torch.equal(m.running_mean,
                               torch.zeros_like(m.running_mean))
    tree = tcnn.convert_shufflenet(rs.shufflenet_state(shape_only=True))
    with pytest.raises(KeyError, match="running_mean"):
        flax_bridge.plan(bb.shufflenet, {"params": tree["params"]})
