"""The port's Depth-Pro against the JAX module: the patch split / merge and
resize helpers, a tiny Depth-Pro in f32 on bridged weights, and the metric
decode (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.models import depth as jdepth
from ovmono3d_tpu_torch.models import depth as tdepth
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)

# tests/test_sam_depth.py's tiny Depth-Pro: 8-pixel patches on 32^2 crops
# of a 128^2 pyramid (1 + 9 + 25 crops), two-block trunks.
TINY = dict(patch_size=8, encoder_size=32, vit_dim=32, vit_depth=2,
            vit_heads=4, scaled_dims=(16, 16, 8), hook_ids=(1,),
            hook_dims=(8,), fusion_dim=8, merge_padding=1)


@pytest.mark.parametrize("size,patch,overlap", [(8, 4, 0.5), (12, 4, 0.25),
                                                (16, 8, 0.0), (8, 8, 0.5)])
def test_split_to_patches_matches_jax(size, patch, overlap):
    x = np.random.default_rng(0).normal(size=(2, size, size, 3)).astype(
        np.float32)
    want = jdepth.split_to_patches(jnp.asarray(x), patch, overlap)
    got = tdepth.split_to_patches(torch.from_numpy(x), patch, overlap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,padding", [(1, 2), (9, 1), (25, 3), (35, 3),
                                       (4, 5)])
def test_merge_patches_matches_jax(n, padding):
    x = np.random.default_rng(1).normal(size=(n * 2, 8, 8, 3)).astype(
        np.float32)
    want = jdepth.merge_patches(jnp.asarray(x), 2, padding)
    got = tdepth.merge_patches(torch.from_numpy(x), 2, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw", [(24, 24), (7, 11), (40, 18), (16, 16)])
def test_resize_matches_jax(hw):
    """Bilinear without antialias, up, down and to a non-square size."""
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 5)).astype(
        np.float32)
    want = jdepth._resize(jnp.asarray(x), hw)
    got = tdepth._resize(torch.from_numpy(x), hw)
    assert got.shape == (2, *hw, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def depth_params(params, layerscale=0.5, head_bias=0.5):
    """numpy leaves; LayerScales raised from 1e-5 so the trunks matter and
    the depth head's bias raised so its ReLU passes most pixels."""
    def fix(path, x):
        x = np.asarray(x)
        keys = [p.key for p in path]
        if keys[-1] == "gamma":
            return np.full_like(x, layerscale)
        if keys[-2:] == ["head_out", "bias"]:
            return np.full_like(x, head_bias)
        return x
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def tiny_depth():
    img = np.random.default_rng(3).normal(size=(1, 128, 128, 3)).astype(
        np.float32)
    jmodel = jdepth.DepthPro(dtype=jnp.float32, **TINY)
    params = depth_params(jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                               jnp.asarray(img)))
    want = jax.jit(jmodel.apply)(params, jnp.asarray(img))
    port = tdepth.DepthPro(dtype=torch.float32, **TINY)
    load_flax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    return got, want


@pytest.mark.parametrize("key", ["canonical_inverse_depth", "fov_deg"])
def test_depth_pro_f32_matches_jax(tiny_depth, key):
    got, want = tiny_depth
    w = np.asarray(want[key])
    assert got[key].shape == w.shape
    if key == "canonical_inverse_depth":
        assert w.shape == (1, 128, 128) and (w > 0).mean() > 0.5
    # f32 on both sides through three trunks, the neck and the decoder;
    # sums in another order.
    np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())


def test_depth_pro_launch_plan_matches_released_geometry():
    """The released geometry's pyramid: 35 crops of 384^2 for a 1536^2
    input, high resolution first; one patch-encoder batch."""
    port = tdepth.DepthPro(device="meta")
    patches, counts = port.pyramid_patches(
        torch.zeros(1, 1536, 1536, 3, device="meta"))
    assert counts == [1, 9, 25] and patches.shape == (35, 384, 384, 3)
    assert len(port.trunks()) == 3 and all(
        len(v.blocks()) == 24 for v in port.trunks())
    assert port.patch_encoder.out_layers == (11, 5)
    assert port.image_encoder.out_layers == ()


def test_metric_depth_and_focal_match_jax():
    rng = np.random.default_rng(4)
    inv = rng.uniform(0.0, 2.0, size=(2, 6, 7)).astype(np.float32)
    inv[0, 0, 0] = 0.0                                  # clamps at max depth
    f_px = np.array([256.0, 900.0], np.float32)
    want = jdepth.metric_depth(jnp.asarray(inv), jnp.asarray(f_px), 256)
    got = tdepth.metric_depth(torch.from_numpy(inv), torch.from_numpy(f_px),
                              256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert abs(got[0, 0, 0].item() - 250.0) < 1e-3
    fov = np.array([90.0, 40.0], np.float32)
    np.testing.assert_allclose(
        tdepth.fov_to_focal(torch.from_numpy(fov), 256).numpy(),
        np.asarray(jdepth.fov_to_focal(jnp.asarray(fov), 256)), rtol=1e-6)
