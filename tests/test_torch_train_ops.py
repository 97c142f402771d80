"""The port's training ops against the JAX package on the same inputs.

Integer and mask outputs (anchors, matching, sampling, NMS keep masks, the
proposals' selection) must agree bit for bit: the port keeps the JAX
package's order of f32 operations and is fed the very uniforms
`jax.random.uniform` draws from the JAX keys. Box coordinates that pass
through exp, log or a multiply-add agree to 1e-6 relative, a few f32 ulp:
XLA's CPU backend has its own exp/log approximations and fuses a * b + c
into one FMA, where PyTorch rounds the product and the sum separately.
Float losses and geometry agree to 1e-5 in f32 (sums run in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.models import heads as jheads
from ovmono3d_tpu.models import rcnn3d as jrc
from ovmono3d_tpu.ops import boxes as jboxes
from ovmono3d_tpu.ops import iou2d as jiou
from ovmono3d_tpu.ops import nms as jnms
from ovmono3d_tpu.ops import rotation as jrot
from ovmono3d_tpu.structures import GroundTruth as JGroundTruth
from ovmono3d_tpu.utils import geometry as jgeom
from ovmono3d_tpu_torch.models import heads as theads
from ovmono3d_tpu_torch.models import rcnn3d as trc
from ovmono3d_tpu_torch.ops import boxes as tboxes
from ovmono3d_tpu_torch.ops import iou2d as tiou
from ovmono3d_tpu_torch.ops import nms as tnms
from ovmono3d_tpu_torch.ops import rotation as trot
from ovmono3d_tpu_torch.structures import GroundTruth
from ovmono3d_tpu_torch.utils import geometry as tgeom
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from test_model import tiny_config
from test_torch_rcnn3d import port_config

torch.set_num_threads(2)

T = torch.from_numpy
LEVELS = ((16, 16), (8, 8), (4, 4))      # tiny config p2 / p3 / p4 at 112^2
STRIDES = (7, 14, 28)


def jax_draws(key, n: int) -> np.ndarray:
    """The two uniform draws subsample_labels makes from `key`: [2, n]."""
    return np.stack([np.asarray(jax.random.uniform(
        k, (n,), minval=1e-10, maxval=1.0)) for k in jax.random.split(key)])


def eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _anchors():
    a = tiny_config().model.anchors
    return [(hw, s, sz) for hw, s, sz in zip(LEVELS, STRIDES, a.sizes)]


def _random_boxes(rng, n, lo=0.0, hi=112.0, min_wh=2.0, max_wh=60.0):
    xy = rng.uniform(lo, hi - max_wh, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _gt(rng, b=2, m=5):
    boxes = np.stack([_random_boxes(rng, m) for _ in range(b)])
    classes = rng.integers(-1, 4, (b, m)).astype(np.int32)
    valid = rng.random((b, m)) < 0.8
    valid[:, 0] = True
    classes[:, 0] = 1
    boxes3d = np.concatenate([
        rng.uniform(10, 100, (b, m, 2)), rng.uniform(2, 20, (b, m, 1)),
        rng.uniform(0.3, 3, (b, m, 3)), rng.normal(0, 1, (b, m, 3))],
        -1).astype(np.float32)
    poses = np.asarray(jrot.rotation_6d_to_matrix(
        jnp.asarray(rng.normal(size=(b, m, 6)).astype(np.float32))))
    arrays = dict(boxes=boxes, classes=classes, boxes3d=boxes3d, poses=poses,
                  valid=valid)
    return (JGroundTruth(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            GroundTruth(**{k: T(np.array(v)) for k, v in arrays.items()}))


@pytest.mark.parametrize("level", range(3))
def test_generate_anchors_bit_exact(level):
    hw, stride, sizes = _anchors()[level]
    ratios = tiny_config().model.anchors.aspect_ratios
    want = jboxes.generate_anchors(hw, stride, sizes, ratios, 0.0)
    got = tboxes.generate_anchors(hw, stride, sizes, ratios, 0.0)
    eq(got, want)


@pytest.mark.parametrize("fn", ["box_area", "pairwise_iou", "pairwise_ioa",
                                "matched_iou"])
def test_iou2d_bit_exact(fn):
    rng = np.random.default_rng(10)
    a, b = _random_boxes(rng, 40), _random_boxes(rng, 40)
    a[:3] = [[5, 5, 5, 9], [7, 7, 3, 3], [0, 0, 0, 0]]     # degenerate boxes
    args = (a,) if fn == "box_area" else (a, b)
    eq(getattr(tiou, fn)(*(T(x) for x in args)),
       getattr(jiou, fn)(*(jnp.asarray(x) for x in args)))


def _all_anchors():
    ratios = tiny_config().model.anchors.aspect_ratios
    return np.concatenate([np.asarray(jboxes.generate_anchors(
        hw, s, sz, ratios)) for hw, s, sz in _anchors()])


def test_match_anchors_bit_exact():
    rng = np.random.default_rng(0)
    anchors = _all_anchors()
    jgt, tgt = _gt(rng)
    fg = tgt.valid & (tgt.classes >= 0)
    got = tboxes.match_anchors(T(anchors), tgt.boxes, fg, (0.3, 0.7))
    for i in range(2):
        want = jboxes.match_anchors(jnp.asarray(anchors), jgt.boxes[i],
                                    jnp.asarray(fg[i].numpy()), (0.3, 0.7))
        for g, w in zip(got, want):
            eq(g[i], w)


def ulp_close(got: torch.Tensor, want) -> None:
    """A few f32 ulp of the coordinates' scale (see the module docstring):
    1e-6 relative, and 1e-6 of the largest |value| absolute, since x1 =
    ctr - w / 2 cancels to values far below the scale of its terms."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_box_deltas_match_jax():
    rng = np.random.default_rng(1)
    src = _random_boxes(rng, 50)
    tgt = _random_boxes(rng, 50)
    deltas = rng.normal(0, 0.5, (50, 4)).astype(np.float32)
    w = (10.0, 10.0, 5.0, 5.0)
    ulp_close(tboxes.get_deltas(T(src), T(tgt), w),
              jboxes.get_deltas(jnp.asarray(src), jnp.asarray(tgt), w))
    ulp_close(tboxes.apply_deltas(T(deltas), T(src), w),
              jboxes.apply_deltas(jnp.asarray(deltas), jnp.asarray(src), w))


@pytest.mark.parametrize("with_ious", [True, False])
def test_subsample_labels_with_jax_draws(with_ious):
    rng = np.random.default_rng(2)
    n = 300
    labels = rng.integers(-1, 2, (2, n)).astype(np.int64)
    ious = rng.random((2, n)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    draws = np.stack([jax_draws(k, n) for k in keys])
    got = tboxes.subsample_labels(
        T(labels), 64, 0.25, T(ious) if with_ious else None, draws=T(draws))
    for i in range(2):
        want = jboxes.subsample_labels(
            keys[i], jnp.asarray(labels[i]), 64, 0.25,
            jnp.asarray(ious[i]) if with_ious else None)
        eq(got[0][i], want[0])
        eq(got[1][i], want[1])
    assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0


def test_subsample_labels_generator_draws_are_a_valid_sample():
    labels = torch.tensor([1] * 30 + [0] * 70 + [-1] * 10)
    g = torch.Generator().manual_seed(0)
    pos, neg = tboxes.subsample_labels(labels, 40, 0.5, generator=g)
    assert int(pos.sum()) == 20 and int(neg.sum()) == 20
    assert bool((labels[pos] == 1).all()) and bool((labels[neg] == 0).all())


def _nms_case(seed, n=64):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 90, (6, 2))
    pick = centers[rng.integers(0, 6, n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(15, 30, (n, 2))
    boxes = np.concatenate([pick - wh / 2, pick + wh / 2], -1)
    scores = rng.random(n).round(2)             # ties on purpose
    valid = rng.random(n) < 0.9
    return (boxes.astype(np.float32), scores.astype(np.float32), valid,
            rng.integers(0, 3, n).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_masks_bit_exact(seed):
    boxes, scores, valid, classes = _nms_case(seed)
    jb, js, jv, jc = (jnp.asarray(x) for x in (boxes, scores, valid, classes))
    tb, ts, tv, tc = (T(x) for x in (boxes, scores, valid, classes))
    keep = tnms.nms_mask(tb, ts, 0.5, tv)
    eq(keep, jnms.nms_mask(jb, js, 0.5, jv))
    eq(tnms.nms_mask_parallel(tb, ts, 0.5, tv),
       jnms.nms_mask_parallel(jb, js, 0.5, jv))
    eq(tnms.batched_nms_mask(tb, ts, tc, 0.5, tv),
       jnms.batched_nms_mask(jb, js, jc, 0.5, jv))
    # The port's one (parallel) batched NMS against JAX's serial one too.
    eq(tnms.batched_nms_mask(tb, ts, tc, 0.5, tv),
       jnms.batched_nms_mask(jb, js, jc, 0.5, jv, parallel=False))
    idx, ok = tnms.topk_after_nms(ts, keep, 20)
    jidx, jok = jnms.topk_after_nms(jb, js, jnp.asarray(keep.numpy()), 20)
    eq(idx, jidx)
    eq(ok, jok)
    assert 0 < int(keep.sum()) < int(tv.sum())


def test_nms_parallel_batched_over_leading_dims():
    cases = [_nms_case(s) for s in range(4)]
    boxes = np.stack([c[0] for c in cases]).reshape(2, 2, 64, 4)
    scores = np.stack([c[1] for c in cases]).reshape(2, 2, 64)
    valid = np.stack([c[2] for c in cases]).reshape(2, 2, 64)
    got = tnms.nms_mask_parallel(T(boxes), T(scores), 0.5, T(valid))
    for i in range(2):
        for j in range(2):
            eq(got[i, j], jnms.nms_mask_parallel(
                jnp.asarray(boxes[i, j]), jnp.asarray(scores[i, j]), 0.5,
                jnp.asarray(valid[i, j])))


def test_nms_parallel_chain_deeper_than_32_rounds():
    """A suppression chain of 80 boxes, each overlapping the next above the
    threshold: the fixpoint needs ~80 rounds, both sides stop after 32 with
    the same (not yet greedy) mask."""
    n = 80
    x = np.arange(n, dtype=np.float32)
    boxes = np.stack([x, np.zeros(n), x + 20, np.full(n, 20.0)], -1)
    boxes = boxes.astype(np.float32)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    got = tnms.nms_mask_parallel(T(boxes), T(scores), 0.85)
    eq(got, jnms.nms_mask_parallel(jnp.asarray(boxes), jnp.asarray(scores),
                                   0.85))
    serial = tnms.nms_mask(T(boxes), T(scores), 0.85)
    eq(serial, jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.85))
    assert not torch.equal(got, serial)


def _rpn_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    anchors = _all_anchors()
    r = anchors.shape[0]
    logits = rng.normal(0, 2, (b, r)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (b, r, 4)).astype(np.float32)
    im_hw = np.array([[112, 112], [98, 84]], np.float32)[:b]
    sizes = tuple(h * w * 3 for h, w in LEVELS)
    return anchors, logits, deltas, im_hw, sizes


@pytest.mark.parametrize("pre,post", [(64, 64), (2000, 100)])
def test_rpn_proposals_match_jax(pre, post):
    """The selection is bit-exact: which anchors survive top-k, NMS and the
    final top-k (their scores are the selected logits themselves) and the
    valid flags. The decoded boxes agree to a few ulp (module docstring)."""
    anchors, logits, deltas, im_hw, sizes = _rpn_inputs(3)
    boxes, scores, valid = trc.rpn_proposals(
        T(logits), T(deltas), T(anchors), sizes, T(im_hw), pre, post, 0.7,
        0.0)
    for i in range(2):
        jb, js, jv = jrc.rpn_proposals_single(
            jnp.asarray(logits[i]), jnp.asarray(deltas[i]),
            jnp.asarray(anchors), sizes, jnp.asarray(im_hw[i]), pre, post,
            0.7, 0.0)
        eq(scores[i], js)
        eq(valid[i], jv)
        ulp_close(boxes[i], jb)
    assert bool(valid.any())


def test_label_anchors_with_jax_draws():
    rng = np.random.default_rng(4)
    anchors = _all_anchors()
    jgt, tgt = _gt(rng)
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    draws = np.stack([jax_draws(k, anchors.shape[0]) for k in keys])
    got = trc.label_anchors(T(anchors), tgt, (0.05, 0.05), 32, 1.0, 0.5,
                            draws=T(draws))
    for i in range(2):
        gi = jax.tree.map(lambda x: x[i], jgt)
        want = jrc.label_anchors_single(keys[i], jnp.asarray(anchors), gi,
                                        (0.05, 0.05), 32, 1.0, 0.5)
        for g, w in zip(got, want):
            eq(g[i], w)


def test_sample_proposals_with_jax_draws():
    rng = np.random.default_rng(5)
    jgt, tgt = _gt(rng)
    props = np.stack([_random_boxes(rng, 60) for _ in range(2)])
    # Proposals near the GT boxes, so some pass the 0.5 IoU threshold.
    props[:, :5] = np.asarray(jgt.boxes) + rng.normal(0, 2, (2, 5, 4))
    props = np.concatenate([props, np.asarray(jgt.boxes)], 1)
    props = props.astype(np.float32)
    pvalid = rng.random((2, props.shape[1])) < 0.9
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    draws = np.stack([jax_draws(k, props.shape[1]) for k in keys])
    got = trc.sample_proposals(T(props), T(pvalid), tgt, 16, 0.25, 0.5, 0.5,
                               5, draws=T(draws))
    for i in range(2):
        gi = jax.tree.map(lambda x: x[i], jgt)
        want = jrc.sample_proposals_single(
            keys[i], jnp.asarray(props[i]), jnp.asarray(pvalid[i]), gi, 16,
            0.25, 0.5, 0.5, 5)
        assert sorted(got) == sorted(want)
        for k in want:
            eq(got[k][i], want[k])
    assert int(got["fg"].sum()) > 0


def close(got: torch.Tensor, want, tol=1e-5, err_msg=""):
    # f32 on both sides; the sums run in another order.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=err_msg)


@pytest.mark.parametrize("agnostic", [False, True])
def test_box_head_losses_match_jax(agnostic):
    rng = np.random.default_rng(6)
    n, c = 32, 5
    box_cfg = dataclasses.replace(tiny_config().model.roi_box,
                                  cls_agnostic_bbox_reg=agnostic)
    tcfg = port_config(dataclasses.replace(tiny_config().model,
                                           roi_box=box_cfg)).roi_box
    logits = rng.normal(size=(n, c + 1)).astype(np.float32)
    deltas = rng.normal(0, 0.1, (n, 4 if agnostic else c * 4)).astype(
        np.float32)
    classes = rng.integers(0, c + 1, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    fg = valid & (classes < c)
    boxes = _random_boxes(rng, n)
    gt = boxes + rng.normal(0, 3, (n, 4)).astype(np.float32)
    args = (logits, deltas, classes, valid, fg, boxes, gt)
    want = jrc.box_head_losses(box_cfg, c, *(jnp.asarray(a) for a in args))
    got = trc.box_head_losses(tcfg, c, *(T(a) for a in args))
    for g, w in zip(got, want):
        close(g, w)


def _dec(rng, n, priors=False):
    pose = jrot.rotation_6d_to_matrix(jnp.asarray(
        rng.normal(size=(n, 6)).astype(np.float32)))
    allo = jrot.rotation_6d_to_matrix(jnp.asarray(
        rng.normal(size=(n, 6)).astype(np.float32)))
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "x": rng.uniform(10, 100, n).astype(np.float32),
        "y": rng.uniform(10, 100, n).astype(np.float32),
        "z": rng.uniform(2, 20, n).astype(np.float32),
        "z_norm": f(n), "dims": rng.uniform(0.3, 3, (n, 3)).astype(np.float32),
        "dims_norm": f(n, 3), "pose": np.asarray(pose),
        "pose_allocentric": np.asarray(allo),
        "uncert": rng.uniform(0.01, 2, n).astype(np.float32),
        "virtual_to_real": rng.uniform(0.5, 2, n).astype(np.float32),
        "deltas_2d": f(n, 2) * 0.1,
        "z_mean": rng.uniform(2, 20, n).astype(np.float32),
        "z_std": rng.uniform(0.5, 2, n).astype(np.float32),
        "dims_prior_mean": (rng.uniform(0.5, 2, (n, 3)).astype(np.float32)
                            if priors else None),
    }


@pytest.mark.parametrize("kw", [
    dict(),
    dict(chamfer_pose=False),
    dict(disentangled_loss=False, chamfer_pose=False),
    dict(disentangled_loss=False, z_type="sigmoid", allocentric_pose=False),
    dict(disentangled_loss=False, z_type="log", inverse_z_weight=True),
    dict(disentangled_loss=False, z_type="clusters",
         dims_priors_enabled=True),
    dict(use_confidence=0.0, loss_w_joint=0.0, loss_w_3d=2.0),
], ids=["chamfer", "corner_l1", "entangled", "entangled_sigmoid_ego",
        "entangled_log_invz", "entangled_clusters_priors", "no_conf"])
def test_cube_losses_match_jax(kw):
    rng = np.random.default_rng(7)
    n = 24
    jcube = dataclasses.replace(tiny_config().model.cube, **kw)
    tcube = port_config(dataclasses.replace(tiny_config().model,
                                            cube=jcube)).cube
    dec = _dec(rng, n, priors=jcube.dims_priors_enabled)
    if jcube.use_confidence == 0:
        dec["uncert"] = None
    gt3d = np.concatenate([
        rng.uniform(10, 100, (n, 2)), rng.uniform(2, 20, (n, 1)),
        rng.uniform(0.3, 3, (n, 3)), rng.normal(size=(n, 3))], -1).astype(
        np.float32)
    poses = np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(
        rng.normal(size=(n, 6)).astype(np.float32))))
    K = np.tile(np.array([[300, 0, 56], [0, 310, 50], [0, 0, 1]], np.float32),
                (n, 1, 1))
    fg = (rng.random(n) < 0.7).astype(np.float32)
    src = _random_boxes(rng, n)
    want = jrc.cube_losses(
        jcube, {k: (None if v is None else jnp.asarray(v))
                for k, v in dec.items()},
        jnp.asarray(gt3d), jnp.asarray(poses), jnp.asarray(K),
        jnp.asarray(fg), src_boxes=jnp.asarray(src))
    got = trc.cube_losses(
        tcube, {k: (None if v is None else T(v)) for k, v in dec.items()},
        T(gt3d), T(poses), T(K), T(fg), src_boxes=T(src))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        close(got[k], w, err_msg=k)


def test_geometry_and_rotation_match_jax():
    rng = np.random.default_rng(8)
    n = 16
    K = np.tile(np.array([[300, 0, 56], [0, 310, 50], [0, 0, 1]], np.float32),
                (n, 1, 1))
    pts = np.concatenate([rng.normal(size=(n, 8, 2)),
                          rng.uniform(1, 10, (n, 8, 1))], -1).astype(
        np.float32)
    r1, r2 = (np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(
        rng.normal(size=(n, 6)).astype(np.float32)))) for _ in range(2))
    u, v = (rng.uniform(0, 112, n).astype(np.float32) for _ in range(2))
    c1, c2 = (rng.normal(size=(n, 8, 3)).astype(np.float32)
              for _ in range(2))
    close(tgeom.project_points(T(K), T(pts)),
          jgeom.project_points(jnp.asarray(K), jnp.asarray(pts)))
    close(tgeom.R_to_allocentric(T(K), T(r1), T(u), T(v)),
          jgeom.R_to_allocentric(jnp.asarray(K), jnp.asarray(r1),
                                 jnp.asarray(u), jnp.asarray(v)))
    close(tgeom.chamfer_corner_distance(T(c1), T(c2)),
          jgeom.chamfer_corner_distance(jnp.asarray(c1), jnp.asarray(c2)))
    for kw in (dict(cos_angle=True), dict(eps=1e-4), dict(eps=0.1)):
        # acos near +-1 is ill-conditioned: 1e-4 absolute on the angle.
        close(trot.so3_relative_angle(T(r1), T(r2), **kw),
              jrot.so3_relative_angle(jnp.asarray(r1), jnp.asarray(r2), **kw),
              tol=1e-4)


def test_rpn_and_box_heads_match_jax():
    rng = np.random.default_rng(9)
    feats = [rng.normal(size=(2, h, w, 8)).astype(np.float32)
             for h, w in LEVELS]
    rpn = jheads.RPNHead(num_anchors=3, conv_dim=8)
    params = jax.jit(rpn.init)(jax.random.PRNGKey(0),
                               [jnp.asarray(f) for f in feats])
    params = jax.tree.map(lambda x: x * 50.0, params)   # off the 0.01 init
    want = rpn.apply(params, [jnp.asarray(f) for f in feats])
    head = theads.RPNHead(3, 8)
    load_flax_params(head, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = head([T(f) for f in feats])
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            close(g, w, tol=1e-4)

    pooled = rng.normal(size=(6, 7, 7, 8)).astype(np.float32)
    box = jheads.FastRCNNHead(num_classes=5, fc_dim=16)
    params = jax.jit(box.init)(jax.random.PRNGKey(1), jnp.asarray(pooled))
    want = box.apply(params, jnp.asarray(pooled))
    head = theads.FastRCNNHead(7 * 7 * 8, 5, fc_dim=16)
    load_flax_params(head, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = head(T(pooled))
    for g, w in zip(got, want):
        close(g, w)
