"""The port's Swin trunk against the JAX package's at matched weights: a tiny
Swin (depths 2, 2, 2, 2, window 4) at an input whose maps need padding, so
shifted blocks, the padding and the small-map rule (a map no larger than
the window is one unshifted window) all run; the hoisted bias, its cache
and its identity with the bias expanded in the forward; and the pieces
(relative-position index, shift region ids, patch merging)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.models.gdino import swin as jswin
from ovmono3d_tpu_torch.models.gdino import swin as tswin
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)

TINY = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
            window=4)
# 88 / 4 = 22 tokens a side: stage maps 22 (padded to 24), 11 (to 12),
# 6 (to 8) and 3 (no larger than the window: one 3 x 3 window, no shift).
S = 88


def _params(dtype, seed=0):
    """The JAX Swin's init, rel-pos tables redrawn at std 1 so the bias
    shows in the outputs."""
    model = jswin.SwinTransformer(**TINY, dtype=dtype)
    img = np.random.default_rng(seed).standard_normal(
        (2, S, S, 3)).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(img))
    rng = np.random.default_rng(seed + 1)

    def redraw(path, x):
        if getattr(path[-1], "key", "") == "rel_pos_bias":
            return rng.standard_normal(x.shape).astype(np.float32)
        return np.asarray(x)

    return model, jax.tree_util.tree_map_with_path(redraw, params), img


@pytest.fixture(scope="module", params=["f32", "bf16"])
def swin_pair(request):
    jd, td = ((jnp.float32, torch.float32) if request.param == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    model, params, img = _params(jd)
    want = jax.jit(model.apply)(params, jnp.asarray(img))
    f32 = jax.jit(_params(jnp.float32)[0].apply)(params, jnp.asarray(img))
    port = tswin.SwinTransformer(**TINY, dtype=td)
    load_flax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(img), port.rel_biases())
    return request.param, want, got, f32


@pytest.mark.parametrize("level", ["s1", "s2", "s3"])
def test_swin_matches_jax(swin_pair, level):
    dtype, want, got, f32 = swin_pair
    w = np.asarray(want[level])
    g = got[level].numpy()
    assert g.shape == w.shape and got[level].dtype == torch.float32
    if dtype == "f32":
        # The same f32 math in another order.
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        # bf16 products, window partition and (from stage 1) residual
        # stream on both sides, rounded at different points (fused
        # epilogues, gelu). The yardstick is how far bf16 moves the JAX
        # trunk from its own f32 run (0.04-0.05 max, 0.007-0.011 mean of
        # these unit-scale outputs): the two bf16 runs stay within 1.5x it.
        err = np.abs(g - w)
        own = np.abs(w - np.asarray(f32[level]))
        assert err.max() <= 1.5 * own.max(), (err.max(), own.max())
        assert err.mean() <= 1.5 * own.mean(), (err.mean(), own.mean())


def test_hoisted_bias_is_the_forward_expansion():
    """Serving with the cached biases is bit-identical to expanding every
    block's bias in the forward, and the cache is the JAX package's
    expand_rel_pos_biases."""
    _, params, img = _params(jnp.float32)
    port = tswin.SwinTransformer(**TINY, dtype=torch.float32)
    load_flax_params(port, params)
    biases = port.rel_biases()
    want = jswin.expand_rel_pos_biases(params["params"], window=4)
    assert sorted(biases) == sorted(want)
    for name, b in biases.items():
        np.testing.assert_array_equal(b.numpy(), want[name])
    with torch.inference_mode():
        hoisted = port(torch.from_numpy(img), biases)
        inline = port(torch.from_numpy(img), None)
    for level in hoisted:
        assert torch.equal(hoisted[level], inline[level])


def test_bias_cache_follows_the_weights():
    _, params, _ = _params(jnp.float32)
    port = tswin.SwinTransformer(**TINY, dtype=torch.float32)
    load_flax_params(port, params)
    first = port.rel_biases()
    assert port.rel_biases() is first                 # cached
    _, params2, _ = _params(jnp.float32, seed=3)
    load_flax_params(port, params2)                   # a new checkpoint
    second = port.rel_biases()
    want = jswin.expand_rel_pos_biases(params2["params"], window=4)
    for name, b in second.items():
        np.testing.assert_array_equal(b.numpy(), want[name])
        assert not torch.equal(b, first[name])


@pytest.mark.parametrize("table,window", [(12, None), (4, 3), (7, 2)])
def test_rel_pos_index_matches_jax(table, window):
    np.testing.assert_array_equal(
        tswin._rel_pos_index(table, window).numpy(),
        np.asarray(jswin._rel_pos_index(table, window)))


@pytest.mark.parametrize("hp,wp,window,shift", [(24, 24, 4, 2),
                                                 (12, 16, 4, 2),
                                                 (228, 228, 12, 6)])
def test_shift_region_ids_match_jax(hp, wp, window, shift):
    np.testing.assert_array_equal(
        tswin._shift_region_ids(hp, wp, window, shift),
        jswin._shift_region_ids(hp, wp, window, shift))


def test_patch_merging_matches_jax():
    """Concatenation order (0::2, 0::2), (1::2, 0::2), (0::2, 1::2),
    (1::2, 1::2) and the padding of odd maps."""
    x = np.random.default_rng(4).standard_normal((2, 7 * 5, 6)).astype(
        np.float32)
    model = jswin.PatchMerging(6, jnp.float32)
    params = jax.jit(model.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x), (7, 5))
    params = jax.tree.map(
        lambda a: np.random.default_rng(5).standard_normal(a.shape).astype(
            np.float32), params)
    want, want_hw = model.apply(params, jnp.asarray(x), (7, 5))
    port = tswin.PatchMerging(6, torch.float32)
    load_flax_params(port, params)
    got, hw = port(torch.from_numpy(x), (7, 5))
    assert hw == tuple(want_hw) == (4, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_swin_refuses_unpadded_input():
    port = tswin.SwinTransformer(**TINY, dtype=torch.float32)
    with pytest.raises(ValueError, match="multiples of 4"):
        port(torch.zeros(1, 30, 32, 3))
