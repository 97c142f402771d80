"""The flax -> torch parameter bridge, the port's config defaults, and the
port's independence from JAX."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from ovmono3d_tpu import config as jcfg
from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.models.backbones import SAM_ARCHS, VIT_PRESETS
from ovmono3d_tpu_torch.models.depth import DepthPro
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.sfp import SimpleFeaturePyramid
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils import flax_bridge
from test_torch_depth import TINY
from test_torch_rcnn3d import training_tree

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def flagship_trees():
    """The flagship training param tree (init through compute_losses: trunk,
    pyramid, RPN, box and cube heads) as shapes only, and the port's
    flagship model on the meta device."""
    cfg = __graft_entry__._flagship_config(square_pad=896).model
    tree = training_tree(jax_build_model(cfg), (1, 896, 896, 3), 4)
    port = build_model(tcfg.flagship_config(896), device="meta")
    return tree, port


def test_flagship_every_leaf_maps_to_one_parameter(flagship_trees):
    tree, port = flagship_trees
    plan = flax_bridge.plan(port, tree)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    params = dict(port.named_parameters())
    assert len(plan) == n_leaves == len(params)
    assert len({full for full, _, _ in plan.values()}) == len(params)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))
    assert n_jax == sum(p.numel() for p in params.values())
    # Spot-check the layouts that change.
    assert plan["backbone/vit/block0/attn/qkv/kernel"][0] == \
        "backbone.vit.block0.attn.qkv.weight"
    assert params["backbone.vit.block0.attn.qkv.weight"].shape == (2304, 768)
    assert params["backbone.vit.patch_embed.weight"].shape == (768, 3, 14, 14)
    assert params["backbone.sfp.up2_0.weight"].shape == (768, 384, 2, 2)
    assert plan["backbone/sfp/up2_0/kernel"][2]           # flipped
    assert params["backbone.vit.depth_fusion.weight"].shape == (768, 769, 1, 1)
    assert params["rpn_head.conv.weight"].shape == (256, 256, 3, 3)
    assert params["box_head.fc1.weight"].shape == (1024, 7 * 7 * 256)


def _flax_like(module):
    """Nested dict with the flax names and layouts of a port module."""
    out = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        sub = module.get_submodule(".".join(mods)) if mods else module
        shape = tuple(p.shape)
        if leaf == "weight" and isinstance(sub, torch.nn.ConvTranspose2d):
            leaf, shape = "kernel", shape[2:] + shape[:2]
        elif leaf == "weight" and isinstance(sub, torch.nn.Conv2d):
            leaf, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
        elif leaf == "weight" and isinstance(sub, torch.nn.LayerNorm):
            leaf = "scale"
        d = out
        for m in mods:
            d = d.setdefault(m, {})
        d[leaf] = np.zeros(shape, np.float32)
    return out


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf", "bad_shape"])
def test_bridge_is_strict(fault):
    port = SimpleFeaturePyramid(16, 8, (2.0, 1.0), trunk_stride=16,
                                dtype=torch.float32)
    tree = _flax_like(port)
    flax_bridge.load_flax_params(port, tree)          # the exact tree loads
    if fault == "extra_leaf":
        tree["rpn_head"] = {"conv": {"kernel": np.zeros((3, 3, 8, 8))}}
    elif fault == "missing_leaf":
        del tree["stage_1"]["output_norm"]["scale"]
    else:
        tree["up2_0"]["kernel"] = np.zeros((2, 2, 16, 9), np.float32)
    with pytest.raises((KeyError, ValueError)):
        flax_bridge.load_flax_params(port, tree)


def test_bridge_flips_conv_transpose():
    port = SimpleFeaturePyramid(2, 2, (2.0,), trunk_stride=16,
                                dtype=torch.float32)
    tree = _flax_like(port)
    k = np.arange(2 * 2 * 2 * 1, dtype=np.float32).reshape(2, 2, 2, 1)
    tree["up2_0"]["kernel"] = k
    flax_bridge.load_flax_params(port, tree)
    w = port.up2_0.weight.detach().numpy()                # [in, out, kh, kw]
    np.testing.assert_array_equal(w[:, 0], k[::-1, ::-1, :, 0].transpose(2, 0, 1))


def _geo_tree(name):
    """A GEO model's full-size flax tree (shapes only) and the port's model
    on the meta device."""
    import jax.numpy as jnp

    from ovmono3d_tpu.models.backbones import VIT_PRESETS as JAX_PRESETS
    from ovmono3d_tpu.models.depth import DepthPro as JaxDepthPro
    from ovmono3d_tpu.models.sam import SamSegmenter as JaxSamSegmenter
    from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT

    def shapes(module, *args):
        return jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def img(size):
        return jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)

    if name == "sam_vit_h":
        arch = {**JAX_PRESETS["sam"], **SAM_ARCHS["vit_h"]}
        tree = shapes(JaxViT(use_depth_fusion=False, **arch), img(1024))
        port = VisionTransformer(
            device="meta", use_depth_fusion=False, pos_interp_offset=0.0,
            **{**VIT_PRESETS["sam"], **SAM_ARCHS["vit_h"]})
    elif name == "sam_segmenter":
        tree = shapes(JaxSamSegmenter(),
                      jax.ShapeDtypeStruct((1, 64, 64, 256), jnp.float32),
                      jax.ShapeDtypeStruct((1, 4), jnp.float32), 1024.0)
        port = SamSegmenter(device="meta")
    else:
        tree = shapes(JaxDepthPro(), img(1536))
        port = DepthPro(device="meta")
    return tree, port


@pytest.mark.parametrize("name", ["sam_vit_h", "sam_segmenter", "depth_pro"])
def test_geo_trees_map_every_leaf_to_one_parameter(name):
    tree, port = _geo_tree(name)
    plan = flax_bridge.plan(port, tree)
    leaves = jax.tree_util.tree_leaves(tree)
    params = dict(port.named_parameters())
    assert len(plan) == len(leaves) == len(params)
    assert sum(int(np.prod(x.shape)) for x in leaves) == sum(
        p.numel() for p in params.values())
    flips = {path for path, (_, _, flip) in plan.items() if flip}
    if name == "sam_vit_h":
        assert plan["block0/attn/rel_pos_h"][0] == \
            "block0.attn.rel_pos_h"
        assert params["block7.attn.rel_pos_h"].shape == (127, 80)
        assert plan["neck_norm1/scale"][0] == "neck_norm1.weight"
        assert "cls_token" not in params and not flips
    elif name == "sam_segmenter":
        assert plan["mask_decoder/iou_token"] == (
            "mask_decoder.iou_token", None, False)
        assert flips == {"mask_decoder/up1/kernel", "mask_decoder/up2/kernel"}
    else:
        assert len(flips) == 1 + 3 + (2 + 3) + 4 + 1   # every ConvTranspose
        assert {"up_image/kernel", "fusion0/deconv/kernel",
                "head_deconv/kernel", "up_hook1_deconv2/kernel"} <= flips


@pytest.mark.parametrize("name,path", [("depth_pro", "fusion0.deconv"),
                                       ("sam_segmenter", "mask_decoder.up1")])
def test_bridge_flips_geo_conv_transposes(name, path):
    port = (DepthPro(dtype=torch.float32, **TINY) if name == "depth_pro"
            else SamSegmenter(embed_dim=16, decoder_mlp_dim=32))
    tree = _flax_like(port)
    node = tree
    for key in path.split("."):
        node = node[key]
    shape = node["kernel"].shape                        # [kh, kw, in, out]
    k = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    node["kernel"] = k
    flax_bridge.load_flax_params(port, tree)
    w = port.get_submodule(path).weight.detach().numpy()  # [in, out, kh, kw]
    np.testing.assert_array_equal(w, k[::-1, ::-1].transpose(2, 3, 0, 1))


def test_gdino_swinb_tree_maps_every_leaf_to_one_parameter():
    """GroundingDINO at the reference's SwinB configuration (Swin-B,
    BERT-base, 6 + 6 layers, 900 queries), as shapes only: every leaf of
    the flax tree has one parameter of the port's model on the meta device,
    with the same total count."""
    import jax.numpy as jnp

    from ovmono3d_tpu.models.gdino.model import GroundingDINO as JaxGDINO
    from ovmono3d_tpu_torch.models.ovmono3d import build_gdino

    sds = jax.ShapeDtypeStruct
    tree = jax.eval_shape(
        JaxGDINO().init, jax.random.PRNGKey(0),
        sds((1, 256, 256, 3), jnp.float32), sds((1, 8), jnp.int32),
        sds((1, 8), jnp.bool_), sds((1, 8, 8), jnp.bool_),
        sds((1, 8), jnp.int32))
    port = build_gdino(device="meta")
    plan = flax_bridge.plan(port, tree)
    leaves = jax.tree_util.tree_leaves(tree)
    params = dict(port.named_parameters())
    assert len(plan) == len(leaves) == len(params)
    n = sum(int(np.prod(x.shape)) for x in leaves)
    assert n == sum(p.numel() for p in params.values()) > 2e8
    assert plan["bert/word_embeddings/embedding"][0] == \
        "bert.word_embeddings.weight"
    assert params["bert.word_embeddings.weight"].shape == (30522, 768)
    assert plan["backbone/stage2_block17/attn/rel_pos_bias"][0] == \
        "backbone.stage2_block17.attn.rel_pos_bias"
    assert params["backbone.stage3_block1.attn.rel_pos_bias"].shape == (
        23 * 23, 32)
    assert params["backbone.patch_embed.weight"].shape == (128, 3, 4, 4)
    assert params["extra_proj.weight"].shape == (256, 1024, 3, 3)
    assert plan["input_proj_norm2/scale"][0] == "input_proj_norm2.weight"
    assert params["tgt_embed"].shape == (900, 256)
    assert params["fusion5.gamma_l"].shape == (256,)
    assert not any(flip for _, _, flip in plan.values())


CONFIG_PAIRS = [
    (tcfg.BackboneConfig, jcfg.BackboneConfig),
    (tcfg.AnchorConfig, jcfg.AnchorConfig),
    (tcfg.RPNConfig, jcfg.RPNConfig),
    (tcfg.ROIBoxConfig, jcfg.ROIBoxConfig),
    (tcfg.CubeHeadConfig, jcfg.CubeHeadConfig),
    (tcfg.ModelConfig, jcfg.ModelConfig),
    (tcfg.SolverConfig, jcfg.SolverConfig),
    (tcfg.TestConfig, jcfg.TestConfig),
    (tcfg.InputConfig, jcfg.InputConfig),
    (tcfg.DatasetConfig, jcfg.DatasetConfig),
]


@pytest.mark.parametrize("port_cls,jax_cls", CONFIG_PAIRS,
                         ids=[p.__name__ for p, _ in CONFIG_PAIRS])
def test_config_defaults_match_jax(port_cls, jax_cls):
    port, ref = port_cls(), jax_cls()
    for f in dataclasses.fields(port_cls):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            for g in dataclasses.fields(mine):
                assert getattr(mine, g.name) == getattr(theirs, g.name), \
                    f"{f.name}.{g.name}"
        else:
            assert mine == theirs, f.name


def test_flagship_config_matches_graft_entry():
    mine = tcfg.flagship_config(896)
    ref = __graft_entry__._flagship_config(square_pad=896).model
    assert mine.num_classes == ref.num_classes == 50
    for section in ("backbone", "anchors", "rpn", "roi_box", "cube"):
        for f in dataclasses.fields(getattr(mine, section)):
            assert getattr(getattr(mine, section), f.name) == \
                getattr(getattr(ref, section), f.name), f"{section}.{f.name}"


# JAX and the JAX package, and what the GPU machine lacks: cv2, torchvision,
# transformers.
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|ovmono3d_tpu|cv2|torchvision"
    r"|transformers)(\.|\s|$)", re.M)


_CUDA_JAX_INCLUDE = re.compile(r"^\s*#\s*include\s*[<\"][^>\"]*(jax|xla|pallas)",
                               re.M | re.I)


def test_port_sources_import_no_jax():
    port = REPO / "ovmono3d_tpu_torch"
    files = sorted(port.rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert {"train", "parallel", "ops", "models", "utils", "geo",
            "gdino", "data", "evaluation", "vis", "eval", "probes"} <= {
        f.parent.name for f in files}
    assert {"train/cli.py", "train/metrics.py", "train/tb_writer.py",
            "parallel/mesh.py", "vis/draw.py", "utils/util.py",
            "utils/load.py", "utils/checkpoint_convert.py",
            "utils/lift_convert.py", "utils/gdino_convert.py",
            "utils/sam_convert.py", "utils/depth_convert.py",
            "utils/hf_shims.py", "utils/cnn_convert.py",
            "utils/release_states.py", "models/dla.py", "models/resnet.py",
            "models/cnns.py"} <= {
        str(f.relative_to(port)) for f in files[:-1]}
    for f in files:
        assert not _JAX_IMPORT.search(f.read_text()), f
    cuda = sorted(port.glob("csrc/*.cu")) + sorted(port.glob("csrc/*.cuh"))
    assert {f.name for f in cuda} >= {
        "flash_attn_fwd.cu", "flash_attn_bwd.cu", "relpos_flash_fwd.cu",
        "window_attn_fwd.cu", "int8_gemm.cu", "flash_common.cuh",
        "layernorm_fwd.cu", "attn_sweep_fwd.cu"}
    for f in cuda:
        assert not _CUDA_JAX_INCLUDE.search(f.read_text()), f


def test_port_runs_with_jax_unimportable():
    code = """
import dataclasses, importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "ovmono3d_tpu", "cv2",
             "torchvision", "transformers", "yaml", "PIL"):
    sys.modules[name] = None           # any import of them now fails
import torch
import ovmono3d_tpu_torch
for m in pkgutil.walk_packages(ovmono3d_tpu_torch.__path__, "ovmono3d_tpu_torch."):
    importlib.import_module(m.name)
from ovmono3d_tpu_torch.config import BackboneConfig, CubeHeadConfig, ModelConfig
from ovmono3d_tpu_torch.models.rcnn3d import build_model
cfg = ModelConfig(num_classes=5, backbone=BackboneConfig(
    embed_dim=32, depth=1, num_heads=2, pretrain_grid=8, out_channels=32,
    square_pad=112), cube=CubeHeadConfig(fc_dim=32))
for quant in ("none", "int8"):
    model = build_model(dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, quant=quant, gelu="tanh")), device="cpu")
    with torch.inference_mode():
        det = model(torch.rand(1, 112, 112, 3) * 255, torch.eye(3)[None] * 100,
                    torch.full((1, 2), 112), torch.ones(1),
                    oracle_boxes=torch.tensor([[[10.0, 10.0, 60.0, 70.0]]]),
                    oracle_classes=torch.zeros(1, 1),
                    oracle_scores=torch.ones(1, 1),
                    oracle_valid=torch.ones(1, 1, dtype=torch.bool))
    assert all(bool(torch.isfinite(v.float()).all()) for _, v in det.items())
# A released-layout checkpoint loads without transformers.
from ovmono3d_tpu_torch.utils import release_states
from ovmono3d_tpu_torch.utils.load import load_rcnn_params
load_rcnn_params(model, release_states.lift_state(cfg), cfg)
# The CNN trunks (models/dla.py, resnet.py, cnns.py) and their converters.
from ovmono3d_tpu_torch.utils.cnn_convert import load_cnn_trunk
cnn = build_model(dataclasses.replace(cfg, backbone=dataclasses.replace(
    cfg.backbone, name="shufflenet_v2", square_pad=128)), device="cpu")
load_cnn_trunk(cnn, release_states.shufflenet_state(), "shufflenet_v2")
with torch.inference_mode():
    feats = cnn.features(torch.rand(1, 128, 128, 3) * 255)
assert all(bool(torch.isfinite(f).all()) for f in feats.values())
from ovmono3d_tpu_torch.geo.cli import synthetic_check
assert synthetic_check("cpu")[0]
# The evaluation path without PyYAML, PIL or cv2: a config built in code.
from ovmono3d_tpu_torch.config import Config
from ovmono3d_tpu_torch.data.synthetic import synthetic_datasets
from ovmono3d_tpu_torch.eval.cli import evaluate_dataset
from ovmono3d_tpu_torch.evaluation.helper import Omni3DEvaluationHelper
ecfg = dataclasses.replace(Config(), model=cfg, input=dataclasses.replace(
    Config().input, min_size_test=96, max_size_test=112))
helper = Omni3DEvaluationHelper(5, list("abcde"), device="cpu")
data, _ = synthetic_datasets(5, list("abcde"), num=2)
evaluate_dataset(ecfg, model, data["synthetic_a"], None, 2, helper, "a")
assert helper.summarize_all()["datasets"]["a"]["AP2D"] == 100.0
# The train CLI with its hooks (metrics, TensorBoard, the panels' PNGs);
# its overrides are parsed with PyYAML, which the card's machine has.
del sys.modules["yaml"]
import tempfile
from pathlib import Path
from ovmono3d_tpu_torch.train import cli as train_cli
with tempfile.TemporaryDirectory() as out:
    res = train_cli.main([
        "--synthetic", "--device", "cpu", "--max-iter", "1",
        "--batch-size", "2", "model.num_classes=5",
        "model.backbone.embed_dim=32", "model.backbone.depth=1",
        "model.backbone.num_heads=2", "model.backbone.pretrain_grid=8",
        "model.backbone.out_channels=32", "model.backbone.square_pad=112",
        "model.cube.fc_dim=32", "model.roi_box.fc_dim=32",
        "input.min_size_train=(96,)", "input.max_size_train=112",
        "vis_period=1", f"output_dir={out}"])
    assert res["step"] == 1
    assert list(Path(out, "vis").glob("train_*.png"))
    assert list(Path(out, "tb").glob("events.out.tfevents.*"))
assert not any(k.split(".")[0] in ("jax", "flax") and v is not None
               for k, v in sys.modules.items())
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
