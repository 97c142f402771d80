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
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.models.sfp import SimpleFeaturePyramid
from ovmono3d_tpu_torch.utils import flax_bridge
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


CONFIG_PAIRS = [
    (tcfg.BackboneConfig, jcfg.BackboneConfig),
    (tcfg.AnchorConfig, jcfg.AnchorConfig),
    (tcfg.RPNConfig, jcfg.RPNConfig),
    (tcfg.ROIBoxConfig, jcfg.ROIBoxConfig),
    (tcfg.CubeHeadConfig, jcfg.CubeHeadConfig),
    (tcfg.ModelConfig, jcfg.ModelConfig),
    (tcfg.SolverConfig, jcfg.SolverConfig),
    (tcfg.TestConfig, jcfg.TestConfig),
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


_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|ovmono3d_tpu)(\.|\s|$)", re.M)


_CUDA_JAX_INCLUDE = re.compile(r"^\s*#\s*include\s*[<\"][^>\"]*(jax|xla|pallas)",
                               re.M | re.I)


def test_port_sources_import_no_jax():
    port = REPO / "ovmono3d_tpu_torch"
    files = sorted(port.rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert {"train", "parallel", "ops", "models", "utils"} <= {
        f.parent.name for f in files}
    for f in files:
        assert not _JAX_IMPORT.search(f.read_text()), f
    cuda = sorted(port.glob("csrc/*.cu")) + sorted(port.glob("csrc/*.cuh"))
    assert {f.name for f in cuda} >= {"flash_attn_fwd.cu", "flash_attn_bwd.cu",
                                      "flash_common.cuh"}
    for f in cuda:
        assert not _CUDA_JAX_INCLUDE.search(f.read_text()), f


def test_port_runs_with_jax_unimportable():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "ovmono3d_tpu"):
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
model = build_model(cfg, device="cpu")
with torch.inference_mode():
    det = model(torch.rand(1, 112, 112, 3) * 255, torch.eye(3)[None] * 100,
                torch.full((1, 2), 112), torch.ones(1),
                oracle_boxes=torch.tensor([[[10.0, 10.0, 60.0, 70.0]]]),
                oracle_classes=torch.zeros(1, 1), oracle_scores=torch.ones(1, 1),
                oracle_valid=torch.ones(1, 1, dtype=torch.bool))
assert all(bool(torch.isfinite(v.float()).all()) for _, v in det.items())
assert not any(k.split(".")[0] in ("jax", "flax") and v is not None
               for k, v in sys.modules.items())
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
