"""The port's SAM image encoder (windowed, rel-pos, no cls token, conv neck)
and SAM's prompt encoder and mask decoder against the JAX modules, on the
same numpy-seeded inputs and bridged weights (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.models.backbones import VIT_PRESETS as JAX_VIT_PRESETS
from ovmono3d_tpu.models.sam import SamSegmenter as JaxSamSegmenter
from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
from ovmono3d_tpu.models.vit import _resize_rel_pos as jax_resize_rel_pos
from ovmono3d_tpu_torch.models.backbones import SAM_ARCHS, VIT_PRESETS
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer, _resize_rel_pos
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)

# A 6x6 patch grid (its pretraining grid: the position table needs no
# resize), windows of 4 that pad the grid to 8, one global block, rel-pos
# tables and a 16-channel neck.
SAM_KW = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2,
              pretrain_grid=6, layerscale=False, use_depth_fusion=False,
              use_cls_token=False, window_size=4, global_blocks=(1,),
              neck_channels=16, use_rel_pos=True)
IMG = 48


def rel_pos_filled(params, seed=0, std=0.3):
    """numpy leaves, the rel-pos tables (zeros at flax's init) drawn from a
    normal so the bias path matters."""
    rng = np.random.default_rng(seed)

    def fix(path, x):
        x = np.asarray(x)
        if path[-1].key in ("rel_pos_h", "rel_pos_w"):
            return (rng.standard_normal(x.shape) * std).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def sam_encoders():
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    out = {}
    for name, jd, td in (("f32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        jvit = JaxViT(dtype=jd, **SAM_KW)
        params = rel_pos_filled(jax.jit(jvit.init)(jax.random.PRNGKey(0),
                                                   jnp.asarray(image)))
        port = VisionTransformer(dtype=td, pos_interp_offset=0.0, **SAM_KW)
        load_flax_params(port, params)
        want = jax.jit(jvit.apply)(params, jnp.asarray(image))
        with torch.inference_mode():
            got = port(torch.from_numpy(image))
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("key", ["last_feat", "cls"])
def test_sam_encoder_matches_jax(sam_encoders, dtype, key):
    got, want = sam_encoders[dtype]
    assert got[key].shape == want[key].shape
    assert got["last_feat"].shape == (2, 6, 6, 16)
    w = np.asarray(want[key])
    # f32: the same math summed in another order. bf16: the two frameworks
    # round activations and products to bf16 at different points through
    # three blocks and the neck; the neck's LayerNorm makes last_feat ~N(0,
    # 1), where 3e-2 is a few bf16 ulps.
    tol = 1e-4 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(got[key].numpy(), w, rtol=tol,
                               atol=tol * np.abs(w).max())


@pytest.mark.parametrize("src,size", [(13, 4), (7, 10), (11, 6)])
def test_resize_rel_pos_matches_jax(src, size):
    """The linear table resize without antialias, down and up."""
    table = np.random.default_rng(1).normal(size=(src, 16)).astype(np.float32)
    want = jax_resize_rel_pos(jnp.asarray(table), size)
    got = _resize_rel_pos(torch.from_numpy(table), size)
    assert got.shape == (2 * size - 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_presets_match_jax():
    assert VIT_PRESETS["sam"] == JAX_VIT_PRESETS["sam"]
    # tools/ovmono3d_geo.py's arch table, as that tool builds it.
    assert SAM_ARCHS["vit_h"] == dict(embed_dim=1280, depth=32, num_heads=16,
                                      global_blocks=(7, 15, 23, 31))
    assert SAM_ARCHS["vit_b"]["global_blocks"] == \
        JAX_VIT_PRESETS["sam"]["global_blocks"]


def test_windowed_blocks_take_window_tables():
    port = VisionTransformer(device="meta", pos_interp_offset=0.0,
                             use_depth_fusion=False,
                             **{**VIT_PRESETS["sam"], **SAM_ARCHS["vit_h"]})
    assert port.cls_token is None and port.pos_embed.shape == (1, 4096, 1280)
    for i, blk in enumerate(port.blocks()):
        glob = i in (7, 15, 23, 31)
        assert blk.window == (0 if glob else 14)
        assert blk.attn.rel_pos_h.shape == ((127 if glob else 27), 80)


SEG_KW = dict(embed_dim=32, decoder_mlp_dim=64)


@pytest.fixture(scope="module")
def segmenters():
    rng = np.random.default_rng(2)
    embed = rng.normal(size=(1, 8, 8, 32)).astype(np.float32)
    boxes = np.array([[10.0, 12, 50, 60], [0, 0, 30, 30], [40, 8, 127, 90]],
                     np.float32)
    jseg = JaxSamSegmenter(**SEG_KW)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jseg.init)(
        jax.random.PRNGKey(1), jnp.asarray(embed), jnp.asarray(boxes[:1]),
        128.0))
    port = SamSegmenter(**SEG_KW)
    load_flax_params(port, params)
    apply = jax.jit(lambda e, b: jseg.apply(params, e, b, 128.0))
    want = [apply(jnp.asarray(embed), jnp.asarray(b[None])) for b in boxes]
    return port, embed, boxes, want


def test_segmenter_batched_matches_jax_per_box(segmenters):
    port, embed, boxes, want = segmenters
    with torch.inference_mode():
        masks, iou = port(torch.from_numpy(embed), torch.from_numpy(boxes),
                          128.0)
    assert masks.shape == (3, 3, 32, 32) and iou.shape == (3, 3)
    for i, (wm, wi) in enumerate(want):
        wm, wi = np.asarray(wm)[0], np.asarray(wi)[0]
        # f32 on both sides through ~20 layers; sums in another order.
        np.testing.assert_allclose(masks[i].numpy(), wm, rtol=1e-4,
                                   atol=1e-4 * np.abs(wm).max())
        np.testing.assert_allclose(iou[i].numpy(), wi, rtol=1e-4, atol=1e-5)


def test_segmenter_per_box_equals_batched(segmenters):
    port, embed, boxes, _ = segmenters
    e = torch.from_numpy(embed)
    with torch.inference_mode():
        batched, _ = port(e, torch.from_numpy(boxes), 128.0)
        for i in range(len(boxes)):
            one, _ = port(e, torch.from_numpy(boxes[i:i + 1]), 128.0)
            torch.testing.assert_close(one[0], batched[i], rtol=1e-5,
                                       atol=1e-5)
        # One embedding per box gives the same as one for all.
        per_box, _ = port(e.expand(3, -1, -1, -1), torch.from_numpy(boxes),
                          128.0)
    torch.testing.assert_close(per_box, batched, rtol=0, atol=0)


def test_segmenter_mask_depends_on_box(segmenters):
    port, embed, boxes, _ = segmenters
    with torch.inference_mode():
        masks, _ = port(torch.from_numpy(embed), torch.from_numpy(boxes),
                        128.0)
    assert not torch.allclose(masks[0], masks[1])
