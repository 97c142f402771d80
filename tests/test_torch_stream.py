"""The port's streaming and batch open-vocabulary serving against the JAX
package's on the CPU: `predict_stream` and `detect_2d_stream` (the chunked
loop, the padded last chunk, both fallbacks), the stream over a list of
devices, and `parallel/serve.py`'s batch detection (tests/test_ovmono3d_lift.py
:134-240 and tests/test_serve.py).

Weights and pipelines as tests/test_torch_ovmono3d.py makes them
(GroundingDINO in f32, the tiny cube model's trunk in bf16 in both
packages); images from numpy seeds.

Tolerances. At resize scale 1 the stream's uint8 canvas holds the image's
own pixels, so the stream is held to the port's per-image path to 1e-5, as
the JAX tests hold theirs. Across the two packages the limits are
tests/test_torch_ovmono3d.py's: the 2D fields to 1e-4, the cube model's
fields and the fused scores to 2e-2 of their scale. At a resize scale other
than 1 the stream rounds the resized canvas to uint8 and per-image serving
does not (ADVICE.md item 2): the stream is held to per-image serving of the
rounded canvas to 1e-5, and the rounding to at most 0.5 a pixel level.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gdino import GDINO_KWARGS, VOCAB, redraw
from test_torch_ovmono3d import CATS, _check_detections, _pipelines

from ovmono3d_tpu.models import ovmono3d as jov
from ovmono3d_tpu.models.gdino.model import GroundingDINO as JaxGDINO
from ovmono3d_tpu.models.gdino.tokenizer import BertTokenizer as JaxTokenizer
from ovmono3d_tpu.parallel.mesh import make_mesh
from ovmono3d_tpu.parallel import serve as jserve
from ovmono3d_tpu_torch.models import ovmono3d as tov
from ovmono3d_tpu_torch.models.gdino.inference import (build_text_inputs,
                                                       postprocess_grounding)
from ovmono3d_tpu_torch.models.gdino.tokenizer import BertTokenizer
from ovmono3d_tpu_torch.parallel import serve as tserve
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)

SCALE_1 = [(112, 112), (96, 112), (112, 80)]     # shortest edge -> 112: x1


@pytest.fixture(scope="module")
def shared():
    jp, tp = _pipelines()
    assert jp._fusable() and tp._fusable()
    return jp, tp


@pytest.fixture(scope="module")
def own_canvas():
    """The detector on a 64^2 canvas of its own: not fusable."""
    jp, tp = _pipelines(gdino_size=64)
    assert not jp._fusable() and not tp._fusable()
    return jp, tp


def _items(shapes, seed):
    rng = np.random.RandomState(seed)
    return [((rng.rand(h, w, 3) * 255).astype(np.uint8),
             jov.default_focal_K(h, w)) for h, w in shapes]


def _same(got, want, tol=1e-5):
    """Two Detections of the port, field by field to `tol`."""
    np.testing.assert_array_equal(got.valid.numpy(), want.valid.numpy())
    for (k, g), (_, w) in zip(got.items(), want.items()):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


def test_predict_stream_matches_per_image(shared):
    """Scale 1, 3 images in chunks of 2 (the last one partial): the stream
    equals per-image `predict` to 1e-5 and the JAX stream within the
    cross-package limits; its results lie in host memory."""
    jp, tp = shared
    items = _items(SCALE_1, 7)
    got = list(tp.predict_stream(iter(items), CATS, chunk=2))
    want = [tp.predict(img, K, CATS) for img, K in items]
    jax_stream = list(jp.predict_stream(iter(items), CATS, chunk=2))
    assert len(got) == len(want) == len(jax_stream) == 3
    for g, w, j in zip(got, want, jax_stream):
        assert all(v.device.type == "cpu" for _, v in g.items())
        _same(g, w)
        _check_detections(g, j)


def test_predict_stream_at_scale_08_is_the_rounded_canvas(shared):
    """(100, 140) and (90, 120) resize by 0.8 and 0.93 onto the 112 canvas.
    The stream is per-image serving of the resized canvas rounded to uint8:
    `run` on `prepare`'s canvas rounded half to even equals it to 1e-5, and
    that canvas lies within 0.5 of the unrounded one. (Against `predict` on
    the unrounded canvas the tiny random detector's phrase scores tie to
    ~1e-3, all near 0.11, so the half-level rounding reorders its top-16
    query selection and NMS, and slots move wholesale: 5 of 13 kept a twin
    within 1 px in one image when this was written. The card's run prints
    the full-width detector's deviation at 640x480.)"""
    _, tp = shared
    items = _items([(100, 140), (90, 120)], 3)
    got = list(tp.predict_stream(iter(items), CATS, chunk=2))
    assert len(got) == 2
    for g, (img, K) in zip(got, items):
        req = tp.prepare(img, K, CATS)
        rounded = req["canvas"].round().clamp(0, 255)
        assert 0 < (rounded - req["canvas"]).abs().max() <= 0.5
        assert g.valid.any()
        _same(g, tp.run({**req, "canvas": rounded}))


def test_detect_stream_matches_detect_2d(own_canvas):
    """A detector-only pipeline (no cube model, the longest-side rule on a
    64^2 canvas; `build_2d_only`'s form): 3 images at scale 1 in chunks of 2
    equal per-image `detect_2d` to 1e-5, and the JAX detect stream to 1e-4;
    no categories gives `detect_2d`'s empty slots."""
    jp, tp = own_canvas
    jp2 = jov.OVMono3DLift(None, None, None, jp.gdino, jp.gdino_params,
                           JaxTokenizer(VOCAB), gdino_size=64)
    tp2 = tov.OVMono3DLift(None, None, tp.gdino, BertTokenizer(VOCAB),
                           gdino_size=64)
    rng = np.random.RandomState(21)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8)
              for h, w in [(64, 48), (48, 64), (64, 64)]]
    got = list(tp2.detect_2d_stream(iter(images), CATS, chunk=2))
    want = [tp2.detect_2d(img, CATS) for img in images]
    jax_stream = list(jp2.detect_2d_stream(iter(images), CATS, chunk=2))
    assert len(got) == len(want) == len(jax_stream) == 3
    for g, w, j in zip(got, want, jax_stream):
        assert sorted(g) == sorted(w) == sorted(j)
        assert g["valid"].any()
        for key in ("valid", "classes"):
            np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(g[key], j[key])
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g[key], j[key], rtol=1e-4, atol=1e-4)
    empty = list(tp2.detect_2d_stream(iter(images[:2]), [], chunk=2))
    assert len(empty) == 2 and not any(e["valid"].any() for e in empty)


def test_predict_stream_fallback_paths(shared, own_canvas):
    """A detector canvas of its own (not fusable) and an empty prompt are
    per-image `predict`, yielded in host memory."""
    _, tp = own_canvas
    items = _items([(96, 128), (96, 128)], 5)
    outs = list(tp.predict_stream(iter(items), CATS, chunk=4))
    assert len(outs) == 2
    for g, (img, K) in zip(outs, items):
        assert g.boxes.device.type == "cpu"
        _same(g, tp.predict(img, K, CATS), tol=0)
    for pipe in (tp, shared[1]):
        empty = list(pipe.predict_stream(iter(items), [], chunk=4))
        assert len(empty) == 2 and not any(d.valid.any() for d in empty)


def test_predict_stream_devices_matches_per_image(shared):
    """The stream split over a list of 4 devices (all `cpu` here: the split,
    the shares and a partial last chunk of 2, which leaves two devices
    idle): 6 images at scale 1 in chunks of 4 equal per-image `predict` to
    1e-5. The device copies are made once and kept until a weight changes."""
    _, tp = shared
    items = _items([(112, 112), (96, 112), (112, 80), (112, 112), (80, 112),
                    (112, 96)], 11)
    devices = ["cpu"] * 4
    got = list(tp.predict_stream(iter(items), CATS, chunk=4,
                                 devices=devices))
    assert len(got) == 6
    for g, (img, K) in zip(got, items):
        _same(g, tp.predict(img, K, CATS))
    reps = tp.replicas(devices)
    assert all(r is tp for r in reps) and tp.replicas(devices) is reps
    with pytest.raises(ValueError, match="multiple"):
        next(tp.predict_stream(iter(items), CATS, chunk=3, devices=devices))


def test_replicas_follow_the_weights(shared):
    """A copy on another device is kept until a weight changes in place.
    (The CPU's devices all compare equal, so the copy is forced by asking
    for the meta device.)"""
    _, tp = shared
    pipe = dataclasses.replace(tp)
    first = pipe.replicas(["meta"])
    assert first[0] is not pipe and first[0].device.type == "meta"
    assert pipe.replicas(["meta"]) is first
    with torch.no_grad():
        pipe.gdino.level_embed.add_(0.0)
    assert pipe.replicas(["meta"]) is not first


# -- batch detection over devices (tests/test_serve.py) -------------------

@pytest.fixture(scope="module")
def gdino_pair():
    """The tiny GroundingDINO in f32 in both packages, the same weights."""
    tok = BertTokenizer(VOCAB)
    text = build_text_inputs(tok, CATS, max_len=32)
    jmodel = JaxGDINO(**GDINO_KWARGS, compute_dtype=jnp.float32)
    images = np.random.RandomState(0).rand(5, 64, 64, 3).astype(np.float32)
    params = redraw(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.asarray(images[:1]),
        *(jnp.asarray(text[k]) for k in ("input_ids", "text_mask",
                                         "text_self_mask", "position_ids"))),
        4)
    port = tov.build_gdino({**GDINO_KWARGS, "compute_dtype": torch.float32},
                           device="cpu")
    load_flax_params(port, params)
    return jmodel, params, port, tok, images


def _one(model, image, text, topk):
    """One image through the model and the postprocess, the same text."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in text.items()}
    with torch.inference_mode():
        out = model(torch.from_numpy(image)[None], t["input_ids"],
                    t["text_mask"], t["text_self_mask"], t["position_ids"])
        return [x.numpy() for x in postprocess_grounding(
            out["pred_logits"][0], out["pred_boxes"][0], t["span_matrix"],
            t["span_valid"], image.shape[:2], topk=topk)]


def test_gdino_dp_serving_matches_per_image(gdino_pair):
    """5 images over 8 devices (3 zero images of padding, unpadded): each
    equals the image alone through the model to 1e-5, and the JAX package's
    8-device mesh to 1e-4."""
    jmodel, params, port, tok, images = gdino_pair
    got = tserve.detect_open_vocabulary_batch(port, images, tok, CATS,
                                              ["cpu"] * 8, topk=10)
    want = jserve.detect_open_vocabulary_batch(
        jmodel, params, images, JaxTokenizer(VOCAB), CATS,
        make_mesh(n_data=8, n_model=1), topk=10)
    assert got["boxes"].shape == (5, 10, 4)
    text = build_text_inputs(tok, CATS, max_len=32)
    for i in range(5):
        one = dict(zip(("boxes", "scores", "classes", "valid"),
                       _one(port, images[i], text, 10)))
        assert got["valid"][i].any()
        for key in ("valid", "classes"):
            np.testing.assert_array_equal(got[key][i], one[key])
            np.testing.assert_array_equal(got[key][i], want[key][i])
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(got[key][i], one[key], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got[key][i], want[key][i], rtol=1e-4,
                                       atol=1e-4)


def test_gdino_serving_fn_reuse_and_biases(gdino_pair):
    """Batches of 2 on each of 2 devices equal each image alone to 1e-4 (f32
    products over another batch); a serving function kept across calls,
    with the Swin biases passed in (one dict per device), gives the same
    detections as a fresh call."""
    _, _, port, tok, images = gdino_pair
    devices = ["cpu"] * 2
    run = tserve.make_gdino_serving_fn(port, devices, topk=10)
    biases = [port.backbone.rel_biases()] * 2
    fresh = tserve.detect_open_vocabulary_batch(port, images[:4], tok, CATS,
                                                devices, topk=10)
    text = build_text_inputs(tok, CATS, max_len=32)
    for i in range(4):
        one = _one(port, images[i], text, 10)
        for key, want in zip(("boxes", "scores", "classes", "valid"), one):
            np.testing.assert_allclose(fresh[key][i], want, rtol=1e-4,
                                       atol=1e-4)
    for _ in range(2):
        kept = tserve.detect_open_vocabulary_batch(
            port, images[:4], tok, CATS, devices, topk=10, run=run,
            rel_biases=biases)
        for key in fresh:
            np.testing.assert_array_equal(kept[key], fresh[key])
