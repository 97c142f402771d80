"""The port's learned-2D inference against the JAX package: the per-image
detection selection (`fast_rcnn_inference` vs `fast_rcnn_inference_single`),
the RPN -> box head -> selection chain on the same features (`_detect_2d`),
and `RCNN3D.forward` without oracle boxes at the tiny config, with the
weights bridged through utils/flax_bridge.py.

Under the seeded init the box head's softmax over C + 1 classes is nearly
flat and the RPN's objectness nearly zero, so scores almost tie and the
selection would hang on rounding. The tests spread the weights that decide
the selection (`_spread_heads`: objectness and class-score kernels x100,
box deltas x10) on both sides alike; the inputs stay the slice tests' own.
Limits: the selection's integer outputs are equal; boxes and scores from the
same features within 1e-4 relative (f32 heads, ROI pooling in bf16 on both
sides); the whole forward's fields within 2e-2 of their scale, as the
oracle slice's (the trunk runs in bf16 and the frameworks round it at
different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model import tiny_config
from test_torch_rcnn3d import (_inputs, _spread, port_config, to_flax,
                               training_tree)

from ovmono3d_tpu.models.rcnn3d import RCNN3D as JaxRCNN3D
from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu.models.rcnn3d import fast_rcnn_inference_single
from ovmono3d_tpu_torch.models.rcnn3d import build_model, fast_rcnn_inference
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)


def _spread_heads(params):
    def fix(path, x):
        names = [getattr(p, "key", "") for p in path]
        x = np.asarray(x)
        if names[-1] == "kernel" and names[-2] in ("cls_score", "objectness"):
            return x * 100.0
        if names[-1] == "kernel" and names[-2] in ("bbox_pred", "deltas"):
            return x * 10.0
        return x
    return jax.tree_util.tree_map_with_path(fix, params)


def _selection_inputs(b=2, n=40, c=6, seed=0):
    """Per-class boxes around random proposals, probabilities on a coarse
    grid (exact ties), one invalid proposal and one non-finite box."""
    rng = np.random.default_rng(seed)
    xy = rng.random((b, n, 1, 2)) * 80
    wh = rng.random((b, n, 1, 2)) * 40 + 4
    jitter = rng.standard_normal((b, n, c, 4)) * 3
    boxes = (np.concatenate([xy, xy + wh], -1) + jitter).astype(np.float32)
    boxes[0, 3, 2] = np.nan
    scores = (np.round(rng.random((b, n, c)) * 20) / 100).astype(np.float32)
    prop_valid = np.ones((b, n), bool)
    prop_valid[1, 5] = False
    im_hw = np.array([[96, 100], [70, 112]], np.float32)
    return boxes, scores, prop_valid, im_hw


@pytest.mark.parametrize("topk,thresh", [(8, 0.01), (30, 0.05), (100, 0.0)])
def test_fast_rcnn_inference_matches_jax(topk, thresh):
    boxes, scores, prop_valid, im_hw = _selection_inputs(seed=topk)
    want = jax.vmap(lambda bx, sc, pv, hw: fast_rcnn_inference_single(
        bx, sc, pv, hw, thresh, 0.5, topk))(
        *(jnp.asarray(a) for a in (boxes, scores, prop_valid, im_hw)))
    got = fast_rcnn_inference(
        *(torch.from_numpy(a) for a in (boxes, scores, prop_valid, im_hw)),
        thresh, 0.5, topk)
    names = ("boxes", "scores", "classes", "valid", "prop_idx")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if name in ("boxes", "scores"):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[3].any()


@pytest.fixture(scope="module")
def learned_pair():
    jcfg = tiny_config().model
    image, K, im_hw, ratio, *_ = _inputs()
    model = jax_build_model(jcfg)
    port = build_model(port_config(jcfg), device="cpu")
    params = _spread_heads(_spread(to_flax(port, training_tree(
        model, image.shape, 3))))
    load_flax_params(port, params)
    return model, params, port, (image, K, im_hw, ratio)


def test_detect_2d_matches_jax_on_the_same_features(learned_pair):
    model, params, port, (image, K, im_hw, ratio) = learned_pair
    feats = jax.jit(lambda p, x: model.apply(p, x, None,
                                             method=JaxRCNN3D.features))(
        params, jnp.asarray(image))
    want = jax.jit(lambda p, f, hw: model.apply(
        p, f, hw, method=JaxRCNN3D._detect_2d))(params, feats,
                                                 jnp.asarray(im_hw))
    tfeats = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
              .to(torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
              for k, v in feats.items()}
    with torch.inference_mode():
        got = port._detect_2d(tfeats, torch.from_numpy(im_hw))
    for name, g, w in zip(("boxes", "scores", "classes", "valid"), got,
                          want):
        w = np.asarray(w)
        if name in ("boxes", "scores"):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[3].sum() >= 4


@pytest.fixture(scope="module")
def forward_pair(learned_pair):
    model, params, port, arrays = learned_pair
    want = jax.jit(model.apply)(params, *(jnp.asarray(a) for a in arrays))
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in arrays))
    return want, got


@pytest.mark.parametrize("field", ["classes", "valid"])
def test_forward_learned_exact_fields(forward_pair, field):
    want, got = forward_pair
    np.testing.assert_array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(want, field)))


@pytest.mark.parametrize(
    "field", ["boxes", "scores", "center_cam", "center_2d", "dimensions",
              "pose", "corners3d"])
def test_forward_learned_fields(forward_pair, field):
    want, got = forward_pair
    w = np.asarray(getattr(want, field))
    g = getattr(got, field).numpy()
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=2e-2,
                               atol=2e-2 * float(np.abs(w).max()))
