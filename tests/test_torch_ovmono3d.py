"""The port's open-vocabulary OVMono3D-LIFT pipeline against the JAX
package's, end to end on the CPU: `predict` (prompts -> GroundingDINO ->
postprocess -> cube lift) at the tiny sizes of tests/test_ovmono3d_lift.py
with GroundingDINO in f32, on the shared canvas (the configuration `build`
makes) and on a detector canvas of its own; empty prompts; the canvas
geometry and preparation; the prompt's token buckets; and the port's resize
against cv2 (present here, not on the machine with the card).

Weights: GroundingDINO's JAX init redrawn from a numpy seed; the cube
model's from the port's seeded init as in tests/test_torch_rcnn3d.py; both
loaded into the other framework through utils/flax_bridge.py.
"""
import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model import tiny_config
from test_torch_gdino import GDINO_KWARGS, VOCAB, redraw
from test_torch_rcnn3d import _spread, port_config, to_flax, training_tree

from ovmono3d_tpu.data.mapper import resize_shortest_edge as jax_resize_se
from ovmono3d_tpu.models import ovmono3d as jov
from ovmono3d_tpu.models.gdino.tokenizer import BertTokenizer as JaxTokenizer
from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.models import ovmono3d as tov
from ovmono3d_tpu_torch.models.gdino.tokenizer import BertTokenizer
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from ovmono3d_tpu_torch.utils.image import (resize_bilinear,
                                            resize_shortest_edge)

torch.set_num_threads(2)

CATS = ["chair", "cup", "traffic cone"]


def _pipelines(gdino_size=None, side=112):
    """(JAX pipeline, port pipeline) at the tiny config with content rule
    ResizeShortestEdge(side, side), holding the same weights."""
    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, input=dataclasses.replace(
        jcfg.input, min_size_test=side, max_size_test=side))
    gk = {**GDINO_KWARGS, "compute_dtype": jnp.float32}
    jp = jov.OVMono3DLift.build(jcfg, JaxTokenizer(VOCAB), gdino_kwargs=gk,
                                gdino_size=gdino_size)
    rcnn = build_model(port_config(jcfg.model), device="cpu").eval()
    rcnn_params = _spread(to_flax(rcnn, training_tree(
        jax_build_model(jcfg.model), (1, 112, 112, 3), 3)))
    load_flax_params(rcnn, rcnn_params)
    gdino_params = redraw(jp.gdino_params, 3)
    gdino = tov.build_gdino({**GDINO_KWARGS, "compute_dtype": torch.float32},
                            device="cpu")
    load_flax_params(gdino, gdino_params)
    jp = dataclasses.replace(jp, rcnn_params=rcnn_params,
                             gdino_params=gdino_params)
    cfg = tcfg.Config(model=port_config(jcfg.model), input=tcfg.InputConfig(
        min_size_test=side, max_size_test=side))
    tp = tov.OVMono3DLift(cfg, rcnn, gdino, BertTokenizer(VOCAB),
                          gdino_size=jp.gdino_size, gdino_min_size=side,
                          gdino_max_size=side)
    return jp, tp


@pytest.fixture(scope="module")
def shared():
    """The `build` configuration: the detector reads the cube model's
    canvas."""
    jp, tp = _pipelines()
    assert jp._fusable() and tp._fusable()
    return jp, tp


def _image(h, w, seed=0):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)


def _check_detections(got, want):
    """2D fields from GroundingDINO in f32: the same slots, classes and
    boxes to 1e-4. 3D fields and the fused scores read the cube model, whose
    trunk runs in bf16 in both frameworks: 2e-2 of each field's scale, as
    tests/test_torch_rcnn3d.py holds that slice."""
    for field in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert got.valid.any()
    w = np.asarray(want.boxes)
    np.testing.assert_allclose(got.boxes.numpy(), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())
    for field in ("scores", "center_cam", "center_2d", "dimensions", "pose",
                  "corners3d"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), field
        np.testing.assert_allclose(g, w, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(w).max()),
                                   err_msg=field)


@pytest.mark.parametrize("hw", [(112, 112), (96, 112), (100, 140)])
def test_predict_matches_jax(shared, hw):
    """(112, 112) and (96, 112) resize by exactly 1; (100, 140) by 0.8,
    where the two resizes differ by float rounding only."""
    jp, tp = shared
    image = _image(*hw, seed=hw[0])
    K = jov.default_focal_K(*hw)
    want = jp.predict(image, K, CATS)
    got = tp.predict(image, K, CATS)
    assert got.boxes.shape == (16, 4) and got.corners3d.shape == (16, 8, 3)
    _check_detections(got, want)


def test_predict_two_stage_matches_jax():
    """A detector canvas of its own (64^2, not the cube model's 112^2): the
    boxes come back through both canvases' scales."""
    jp, tp = _pipelines(gdino_size=64)
    assert not jp._fusable() and not tp._fusable()
    image = _image(96, 112, seed=5)
    K = jov.default_focal_K(96, 112)
    _check_detections(tp.predict(image, K, CATS), jp.predict(image, K, CATS))


def test_detect_2d_matches_jax(shared):
    jp, tp = shared
    image = _image(96, 112, seed=6)
    want, got = jp.detect_2d(image, CATS), tp.detect_2d(image, CATS)
    for key in ("valid", "classes"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4)


def test_lift_3d_matches_jax(shared):
    """The cube branch alone on the same given 2D detections."""
    jp, tp = shared
    image = _image(100, 140, seed=11)
    K = jov.default_focal_K(100, 140)
    det2d = jp.detect_2d(image, CATS)
    _check_detections(tp.lift_3d(image, K, det2d), jp.lift_3d(image, K, det2d))


def test_empty_prompts(shared):
    jp, tp = shared
    image = _image(96, 112, seed=7)
    K = jov.default_focal_K(96, 112)
    got, want = tp.predict(image, K, []), jp.predict(image, K, [])
    assert not got.valid.any() and float(got.scores.max()) == 0.0
    assert got.boxes.shape == (tp.detect_topk, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not tp.detect_2d(image, [])["valid"].any()


def test_trace_marks_every_stage(shared):
    _, tp = shared
    trace: dict = {}
    tp.predict(_image(96, 112), jov.default_focal_K(96, 112), CATS,
               trace=trace)
    assert list(trace["ms"]) == ["canvas", "text", "gdino", "postprocess",
                                 "lift"]
    assert trace["pred_logits"].shape == (16, 32)


@pytest.mark.parametrize("min_size,max_size,size,hw", [
    (532, 896, 896, (480, 640)), (30, 56, 64, (48, 64)),
    (30, 56, 64, (20, 80)), (None, None, 64, (48, 64)),
    (532, 896, 896, (749, 1000))])
def test_canvas_geometry_matches_jax(shared, min_size, max_size, size, hw):
    jp, tp = shared
    jp = dataclasses.replace(jp, gdino_min_size=min_size,
                             gdino_max_size=max_size, gdino_size=size)
    tp = dataclasses.replace(tp, gdino_min_size=min_size,
                             gdino_max_size=max_size, gdino_size=size)
    assert tp._gdino_content_geometry(*hw) == \
        jp._gdino_content_geometry(*hw)


def test_flagship_canvas_is_532_by_709():
    """A 640x480 frame on the 896 canvas: 532x709 content (round half up),
    not the longest side's 672x896."""
    tp = tov.OVMono3DLift(None, None, None, None, gdino_size=896,
                          gdino_min_size=532, gdino_max_size=896)
    nh, nw, scale = tp._gdino_content_geometry(480, 640)
    assert (nh, nw) == (532, 709) and scale == pytest.approx(532 / 480)


@pytest.mark.parametrize("hw", [(96, 112), (60, 100)])
def test_gdino_image_prep_matches_jax(shared, hw):
    """The detector's own canvas: content normalized, padding exactly 0.
    (96, 112) at scale 1 is exact; (60, 100) resizes, where cv2 and
    F.interpolate differ by float rounding (1e-4 of normalized values)."""
    jp, tp = shared
    jp = dataclasses.replace(jp, gdino_min_size=None, gdino_max_size=None)
    tp = dataclasses.replace(tp, gdino_min_size=None, gdino_max_size=None)
    image = _image(*hw, seed=8)
    want, wscale = jp._prep_gdino_image(image)
    got, scale = tp._prep_gdino_image(image)
    assert scale == wscale
    tol = 1e-6 if max(hw) == 112 else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_gdino_normalize_matches_jax(shared):
    jp, tp = shared
    canvas = np.random.default_rng(9).random((2, 112, 112, 3)).astype(
        np.float32) * 255
    hw = np.array([[112, 90], [70, 112]], np.int32)
    want = jp._gdino_normalize(jnp.asarray(canvas), jnp.asarray(hw))
    got = tp._gdino_normalize(torch.from_numpy(canvas), torch.from_numpy(hw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got[1, 70:] == 0).all() and (got[0, :, 90:] == 0).all()


@pytest.mark.parametrize("n_cats", [0, 3, 12, 40])
def test_text_buckets_match_jax(shared, n_cats):
    """Power-of-two text buckets from 32, up to max_text_len (32 in the
    tiny model); the span matrix stays full length."""
    jp, tp = shared
    jp = dataclasses.replace(jp, gdino=dataclasses.replace(
        jp.gdino, max_text_len=128))
    tp.gdino.max_text_len = 128
    try:
        cats = (["chair", "cup", "traffic cone"] * 14)[:n_cats]
        want = jp._text_device_inputs(cats)
        got = tp._text_device_inputs(cats)
    finally:
        tp.gdino.max_text_len = 32
    keys = ("input_ids", "text_mask", "text_self_mask", "position_ids",
            "span_matrix", "span_valid")
    for key, w in zip(keys, want):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))


@pytest.mark.parametrize("hw,new_hw", [((96, 128), (84, 112)),
                                       ((480, 640), (532, 709)),
                                       ((60, 100), (38, 64)),
                                       ((50, 70), (101, 141))])
def test_resize_matches_cv2(hw, new_hw):
    """cv2.resize(INTER_LINEAR) on float pixels: the same filter. cv2 rounds
    its interpolation weights, so values 0..255 differ by up to ~0.012
    (measured); hold them to 0.02 max and 2e-3 mean."""
    image = _image(*hw, seed=10).astype(np.float32)
    want = cv2.resize(image, (new_hw[1], new_hw[0]))
    got = resize_bilinear(torch.from_numpy(image), new_hw).numpy()
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.max() <= 0.02 and err.mean() <= 2e-3, (err.max(), err.mean())


@pytest.mark.parametrize("hw,short,max_size", [((480, 640), 532, 896),
                                               ((749, 1000), 500, 1333),
                                               ((100, 900), 532, 896),
                                               ((96, 128), 112, 112)])
def test_resize_shortest_edge_matches_jax(hw, short, max_size):
    assert resize_shortest_edge(hw, short, max_size) == \
        jax_resize_se(hw, short, max_size)


def test_default_focal_K_matches_jax():
    np.testing.assert_array_equal(tov.default_focal_K(480, 640),
                                  jov.default_focal_K(480, 640))


def test_build_seeds_both_models():
    jcfg = tiny_config()
    cfg = tcfg.Config(model=port_config(jcfg.model))
    a = tov.OVMono3DLift.build(cfg, BertTokenizer(VOCAB),
                               gdino_kwargs=GDINO_KWARGS, device="cpu")
    b = tov.OVMono3DLift.build(cfg, BertTokenizer(VOCAB),
                               gdino_kwargs=GDINO_KWARGS, device="cpu")
    assert a._fusable() and a.gdino_size == 112
    assert (a.gdino_min_size, a.gdino_max_size) == (532, 896)
    for pa, pb in zip(a.gdino.parameters(), b.gdino.parameters()):
        assert torch.equal(pa, pb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tov.build_gdino(GDINO_KWARGS)        # the card unless asked
