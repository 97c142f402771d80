"""The port's DINOv2 trunk, Simple Feature Pyramid and ROIAlignV2 against the
JAX modules, on the same numpy-seeded inputs and bridged weights (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.models.sfp import SimpleFeaturePyramid as JaxSFP
from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
from ovmono3d_tpu.models.vit import resize_pos_embed as jax_resize_pos_embed
from ovmono3d_tpu.ops import roi_align as jra
from ovmono3d_tpu_torch.models.sfp import SimpleFeaturePyramid
from ovmono3d_tpu_torch.models.vit import (DINOV2_POS_OFFSET,
                                           VisionTransformer, resize_pos_embed)
from ovmono3d_tpu_torch.ops import roi_align as tra
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)

# 126 = 9 patches of 14 against a pretrain grid of 8: the +0.1 bicubic
# position resize runs.
VIT_KW = dict(patch_size=14, embed_dim=32, depth=2, num_heads=2,
              pretrain_grid=8, layerscale=True, use_depth_fusion=True)
# The port's trunk is DINOv2's, whose offset is fixed; the JAX side takes it
# as its "dinov2" preset does.
JAX_VIT_KW = dict(VIT_KW, pos_interp_offset=DINOV2_POS_OFFSET)
IMG = 126


def _np_params(params, gamma=0.5):
    """numpy leaves; LayerScale raised from 1e-5 so the blocks matter."""
    def fix(path, x):
        x = np.asarray(x)
        return np.full_like(x, gamma) if path[-1].key == "gamma" else x
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def vit_pair():
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 5, size=(2, 40, 36, 1)).astype(np.float32)
    jvit = JaxViT(dtype=jnp.float32, **JAX_VIT_KW)
    params = _np_params(jax.jit(jvit.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(image)))
    port = VisionTransformer(dtype=torch.float32, **VIT_KW)
    load_flax_params(port, params)
    return jvit, params, port, image, depth


@pytest.mark.parametrize("with_depth", [False, True])
def test_vit_f32_matches_jax(vit_pair, with_depth):
    jvit, params, port, image, depth = vit_pair
    d = depth if with_depth else None
    want = jax.jit(jvit.apply)(params, jnp.asarray(image),
                               None if d is None else jnp.asarray(d))
    with torch.inference_mode():
        got = port(torch.from_numpy(image),
                   None if d is None else torch.from_numpy(d))
    for key in ("last_feat", "cls"):
        assert got[key].shape == want[key].shape
        # f32 on both sides; sums run in another order.
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_vit_unported_options_raise():
    """Every option builds now (the CLIP / MAE ones are held to JAX in
    tests/test_torch_trunks.py); unknown remat policies and quant modes are
    refused."""
    for kw in ({"pos_sincos": True}, {"pre_ln": True, "quick_gelu": True}):
        vit = VisionTransformer(device="meta", **VIT_KW, **kw)
        assert (vit.pos_embed is None) == ("pos_sincos" in kw)
        assert (vit.ln_pre is not None) == ("pre_ln" in kw)
    # remat is ported (tests/test_torch_remat.py); unknown policies refused.
    assert VisionTransformer(device="meta", remat=True, **VIT_KW)
    with pytest.raises(ValueError, match="remat_policy='some'"):
        VisionTransformer(device="meta", remat=True, remat_policy="some",
                          **VIT_KW)
    # W8A8 is ported (tests/test_torch_quant.py); other modes are refused.
    assert VisionTransformer(device="meta", quant="int8", **VIT_KW)
    with pytest.raises(ValueError, match="quant='int4'"):
        VisionTransformer(device="meta", quant="int4", **VIT_KW)
    # The size-based position resize of the non-DINOv2 trunks: a table at
    # its pretraining grid passes unchanged, another grid is resized
    # (against JAX in tests/test_torch_trunks.py).
    pe = torch.randn(1, 1 + 64, 16)
    assert torch.equal(resize_pos_embed(pe, (8, 8), 0.0), pe)
    assert resize_pos_embed(pe, (9, 9), 0.0).shape == (1, 1 + 81, 16)


@pytest.mark.parametrize("grid", [(9, 9), (9, 11), (5, 12), (8, 8)])
def test_resize_pos_embed_matches_jax(grid):
    rng = np.random.default_rng(1)
    pe = rng.normal(0, 0.02, (1, 1 + 64, 16)).astype(np.float32)
    want = jax_resize_pos_embed(jnp.asarray(pe), grid, DINOV2_POS_OFFSET)
    got = resize_pos_embed(torch.from_numpy(pe), grid)
    # The JAX side builds torch's bicubic (a = -0.75) as f32 HIGHEST matmuls.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_separable_resize_equals_torch_bicubic(h, w):
    """The two-product resize against DINOv2's F.interpolate on the whole
    table, from the flagship's 37^2 pretrain grid to its 64^2 grid and to a
    non-square one."""
    rng = np.random.default_rng(6)
    pe = torch.from_numpy(rng.normal(0, 0.02, (1, 1 + 37 * 37, 8))
                          .astype(np.float32))
    got = resize_pos_embed(pe, (h, w))
    grid = pe[:, 1:].reshape(1, 37, 37, 8).permute(0, 3, 1, 2)
    want = torch.nn.functional.interpolate(
        grid, mode="bicubic", align_corners=False,
        scale_factor=((h + 0.1) / 37, (w + 0.1) / 37))
    want = want.permute(0, 2, 3, 1).reshape(1, h * w, 8)
    torch.testing.assert_close(got[:, 1:], want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got[:, :1], pe[:, :1], rtol=0, atol=0)


def test_sfp_f32_matches_jax():
    # Stride 16 gives one level per scale: 4 -> p2 ... 0.5 -> p5; an odd
    # 9x9 map exercises the max-pool edge and both ConvTranspose stages
    # (whose flax kernel the bridge flips).
    kw = dict(out_channels=16, scale_factors=(4.0, 2.0, 1.0, 0.5),
              trunk_stride=16)
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 9, 9, 32)).astype(np.float32)
    jsfp = JaxSFP(dtype=jnp.float32, **kw)
    params = _np_params(jax.jit(jsfp.init)(jax.random.PRNGKey(1),
                                            jnp.asarray(feat)))
    want = jax.jit(jsfp.apply)(params, jnp.asarray(feat))
    port = SimpleFeaturePyramid(32, dtype=torch.float32, **kw)
    load_flax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(feat))
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _boxes(rng, n, size):
    x1y1 = rng.uniform(-10, size * 0.8, (n, 2))
    wh = rng.uniform(4, size * 0.9, (n, 2))
    return np.concatenate([x1y1, x1y1 + wh], 1).astype(np.float32)


# bf16: both sides round the interpolation weights, the map and the first
# contraction's output to bf16 and accumulate in f32; they may still differ
# by an ulp (0.4%) in the sum order.
TOL = {np.float32: (1e-5, 1e-5), "bf16": (1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_roi_align_matches_jax(dtype):
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(20, 24, 8)).astype(np.float32)
    boxes = _boxes(rng, 11, 96)
    jfeat, tfeat = jnp.asarray(feat), torch.from_numpy(feat)
    if dtype == "bf16":
        jfeat, tfeat = jfeat.astype(jnp.bfloat16), tfeat.to(torch.bfloat16)
    want = jra.roi_align(jfeat, jnp.asarray(boxes), 4, 7, 2)
    got = tra.roi_align(tfeat, torch.from_numpy(boxes), 4, 7, 2)
    assert got.dtype == tfeat.dtype
    rtol, atol = TOL[dtype]
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=rtol,
                               atol=atol * np.abs(w).max())


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_multilevel_roi_align_matches_jax(dtype):
    rng = np.random.default_rng(4)
    strides = [4, 8, 16]
    feats = [rng.normal(size=(128 // s, 128 // s, 8)).astype(np.float32)
             for s in strides]
    boxes = np.concatenate([_boxes(rng, 9, 128),
                            np.array([[0, 0, 300, 300], [4, 6, 124, 126],
                                      [5, 5, 20, 20], [0, 0, 0, 0]],
                                     np.float32)])
    jf = [jnp.asarray(f) for f in feats]
    tf = [torch.from_numpy(f) for f in feats]
    if dtype == "bf16":
        jf = [f.astype(jnp.bfloat16) for f in jf]
        tf = [f.to(torch.bfloat16) for f in tf]
    levels_j = jra.assign_fpn_levels(jnp.asarray(boxes), 2, 4)
    levels_t = tra.assign_fpn_levels(torch.from_numpy(boxes), 2, 4)
    np.testing.assert_array_equal(levels_t.numpy(), np.asarray(levels_j))
    assert len(set(levels_t.tolist())) == 3   # every level is used
    want = jra.multilevel_roi_align(jf, strides, jnp.asarray(boxes))
    got = tra.multilevel_roi_align(tf, strides, torch.from_numpy(boxes))
    rtol, atol = TOL[dtype]
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=rtol,
                               atol=atol * np.abs(w).max())


def test_multilevel_roi_align_batched_equals_per_image():
    """The port batches leading dims; the JAX package vmaps per image."""
    rng = np.random.default_rng(5)
    strides = [4, 8, 16]
    feats = [torch.from_numpy(rng.normal(size=(2, 64 // s, 64 // s, 4))
                              .astype(np.float32)) for s in strides]
    boxes = torch.from_numpy(np.stack([_boxes(rng, 5, 64),
                                       _boxes(rng, 5, 64)]))
    batched = tra.multilevel_roi_align(feats, strides, boxes)
    for i in range(2):
        one = tra.multilevel_roi_align([f[i] for f in feats], strides,
                                       boxes[i])
        torch.testing.assert_close(batched[i], one, rtol=1e-6, atol=1e-6)
