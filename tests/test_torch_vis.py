"""The port's visualisation and the helpers ported with it, against the JAX
package on seeded inputs:

- vis/rasterize.py: silhouettes and nearest-instance indices exact, depth
  within 1e-9, visibility and truncation within 1e-6, the shaded render
  exact; scenes include a cuboid straddling the near plane and one fully
  behind the camera;
- utils/geometry.py `cuboid_to_2d_box` within 1e-5 (f32);
- vis/draw.py's BEV, pred-vs-GT panels, scene view and demo panel within a
  pixel of the JAX package's cv2 drawings (painted pixels, more than 32
  levels off the background, each within the 3 x 3 neighbourhood of one of
  the other; the labels' bands are left out, the port's bitmap font is not
  cv2's Hershey font);
- ops/rotation.py's matrix_to_rotation_6d / quaternion / euler angles
  within 1e-6 and random_rotations orthonormal; structures.py's Boxes2D,
  concatenate and take exact; utils/util.py's files, image reading and
  list order; the ViT-B/14 and ViT-L/14 presets' parameter trees;
  GroundingDINO's `detect_open_vocabulary` on the tiny detector of
  tests/test_torch_gdino.py within its postprocess test's limits.
"""
from __future__ import annotations

import json
import pickle
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.ops import rotation as jrot
from ovmono3d_tpu import structures as jstruct
from ovmono3d_tpu.utils import geometry as jgeom
from ovmono3d_tpu.utils import util as jutil
from ovmono3d_tpu.vis import draw as jdraw
from ovmono3d_tpu.vis import rasterize as jras
from ovmono3d_tpu_torch import structures as tstruct
from ovmono3d_tpu_torch.data.build import write_png
from ovmono3d_tpu_torch.ops import rotation as trot
from ovmono3d_tpu_torch.utils import geometry as tgeom
from ovmono3d_tpu_torch.utils import util as tutil
from ovmono3d_tpu_torch.vis import draw as tdraw
from ovmono3d_tpu_torch.vis import rasterize as tras

torch.set_num_threads(2)

K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
H, W = 96, 128


def _box3d(rng, n, z=(3.0, 9.0)):
    return np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                           rng.uniform(*z, (n, 1)),
                           rng.uniform(0.5, 2.0, (n, 3))], -1)


def _rot(rng, n):
    return np.asarray(jrot.random_rotations(
        jax.random.PRNGKey(int(rng.integers(1 << 30))), n), np.float64)


def _scene(seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(box3d [N, 6], R [N, 3, 3], corners [N, 8, 3]): random boxes in
    front of the camera, one straddling the near plane, one behind it."""
    rng = np.random.default_rng(seed)
    box = _box3d(rng, 5)
    box[3] = [0.2, 0.1, 0.3, 1.0, 1.0, 1.6]         # straddles z = 0
    box[4] = [0.0, 0.0, -3.0, 1.0, 1.0, 1.0]        # fully behind
    R = _rot(rng, 5)
    corners = np.asarray(jgeom.cuboid_corners(jnp.asarray(box, jnp.float32),
                                              jnp.asarray(R, jnp.float32)),
                         np.float64)
    return box, R, corners


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterizer_matches_jax(seed):
    box, R, corners = _scene(seed)
    z = corners[3, :, 2]
    assert (z < 0).any() and (z > 0).any()          # straddles
    assert (corners[4, :, 2] < 0).all()             # behind
    sil_t, depth_t, inds_t = tras.render_depth_map(K, corners, H, W)
    sil_j, depth_j, inds_j = jras.render_depth_map(K, corners, H, W)
    np.testing.assert_array_equal(sil_t, sil_j)
    np.testing.assert_array_equal(inds_t, inds_j)
    fin = np.isfinite(depth_j)
    np.testing.assert_array_equal(np.isfinite(depth_t), fin)
    np.testing.assert_allclose(depth_t[fin], depth_j[fin], rtol=0, atol=1e-9)
    assert sil_t[3].any() and not sil_t[4].any()
    np.testing.assert_allclose(tras.estimate_visibility(K, corners, H, W),
                               jras.estimate_visibility(K, corners, H, W),
                               rtol=0, atol=1e-6)
    for b, r in zip(box, R):
        np.testing.assert_allclose(
            tras.estimate_truncation(K, b, r, W, H),
            jras.estimate_truncation(K, b, r, W, H), rtol=0, atol=1e-6)
    assert tras.estimate_truncation(K, box[4], R[4], W, H) == 1.0
    image = np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)
    np.testing.assert_array_equal(
        tras.render_mesh_view(image, K, corners),
        jras.render_mesh_view(image, K, corners))


@pytest.mark.parametrize("batched", [False, True])
def test_cuboid_to_2d_box_matches_jax(batched):
    box, R, _ = _scene(3)
    Ks = np.tile(K, (len(box), 1, 1)) if batched else K
    for xywh in (True, False):
        got = tgeom.cuboid_to_2d_box(
            torch.tensor(Ks, dtype=torch.float32),
            torch.tensor(box, dtype=torch.float32),
            torch.tensor(R, dtype=torch.float32), clip_w=W, clip_h=H,
            xywh=xywh)
        want = jgeom.cuboid_to_2d_box(
            jnp.asarray(Ks, jnp.float32), jnp.asarray(box, jnp.float32),
            jnp.asarray(R, jnp.float32), clip_w=W, clip_h=H, xywh=xywh)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[1][3]) and not bool(got[2][3]) and bool(got[2][4])


# -- panels -------------------------------------------------------------------


def _painted(img: np.ndarray, background: int) -> np.ndarray:
    """Pixels more than 32 levels off the background in some channel (an
    antialiased fringe fainter than that is not counted)."""
    return (np.abs(img.astype(int) - background) > 32).any(axis=-1)


def _near(a: np.ndarray, b: np.ndarray) -> bool:
    """Every painted pixel of `a` has a painted pixel of `b` in its 3 x 3
    neighbourhood."""
    grown = cv2.dilate(b.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0
    return bool(np.all(grown[a]))


def _same_drawing(got, want, background=0, keep=None) -> None:
    pg, pw = _painted(got, background), _painted(want, background)
    if keep is not None:
        pg, pw = pg & keep, pw & keep
    assert pg.sum() > 50 and pw.sum() > 50
    assert _near(pg, pw) and _near(pw, pg)


def _without_labels(shape, boxes, x_offsets=(0,), y_offsets=(0,)):
    """A mask of `shape` without the label band above each box (the
    text's 14 rows, 160 columns from the box's left edge) and without each
    H x W tile's outermost pixels (cv2 caps a line it clips at the image's
    border there)."""
    keep = np.ones(shape, bool)
    for dx in x_offsets:
        for dy in y_offsets:
            keep[dy:dy + H, [dx, dx + W - 1]] = False
            keep[[dy, dy + H - 1], dx:dx + W] = False
    for dx in x_offsets:
        for dy in y_offsets:
            for x1, y1, _, _ in np.asarray(boxes):
                top = max(int(round(y1)) - 4, 10)
                x = int(round(x1)) + dx
                keep[max(dy + top - 13, 0):dy + top + 3,
                     max(x, 0):x + 160] = False
    return keep


def _dets(seed: int, n: int = 4):
    box, R, corners = _scene(seed)
    corners = corners[:3]
    b2d = np.stack([[*c[:, :2].min(0), *c[:, :2].max(0)] for c in
                    (corners @ K.T)[..., :3] / (corners @ K.T)[..., 2:]])
    b2d = np.clip(b2d, 0, [W - 1, H - 1, W - 1, H - 1])
    return {"classes": np.array([0, 2, 1]), "boxes2d": b2d,
            "corners3d": corners, "scores": np.array([0.9, 0.2, 0.8])}


def test_bev_within_a_pixel_of_cv2():
    _, _, corners = _scene(5)
    got, want = tdraw.draw_bev(list(corners[:3])), jdraw.draw_bev(
        list(corners[:3]))
    assert got.shape == want.shape == (400, 400, 3)
    _same_drawing(got, want, background=255)


def test_pred_vs_gt_panels_within_a_pixel_of_cv2():
    gt, pred = _dets(6), _dets(7)
    image = np.zeros((H, W, 3), np.uint8)
    names = ["chair", "table", "lamp"]
    got = tdraw.pred_vs_gt_panels(image, K, gt, pred, names,
                                  prompted_ids={0, 1})
    want = jdraw.pred_vs_gt_panels(image, K, gt, pred, names,
                                   prompted_ids={0, 1})
    assert got.shape == want.shape == (2 * H, 3 * W, 3)
    keep = _without_labels(got.shape[:2], np.concatenate(
        [gt["boxes2d"], pred["boxes2d"]]), x_offsets=(0, W, 2 * W),
        y_offsets=(0, H))
    _same_drawing(got, want, keep=keep)
    # The evaluated column leaves class 2 out; the predictions' wireframes
    # only pass the score threshold (sqrt(1 / 3) * 1.2 = 0.69).
    assert not np.array_equal(got[:, :W], got[:, W:2 * W])


def test_scene_view_within_a_pixel_of_cv2():
    _, _, corners = _scene(8)
    image = np.full((H, W, 3), 40, np.uint8)
    got = tdraw.draw_scene_view(image, K, corners[:3])
    want = jdraw.draw_scene_view(image, K, corners[:3])
    assert got.shape == want.shape == (H, 2 * W, 3)
    np.testing.assert_array_equal(got[:, :W], want[:, :W])   # shaded, exact
    # The novel view: the same shading, the wireframes within a pixel.
    c = np.asarray(corners[:3])
    center = c.reshape(-1, 3).mean(0)
    a = np.deg2rad(45.0)
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    colors = np.array([tutil.get_color(i) for i in range(3)], np.float64)
    shaded = tras.render_mesh_view(np.full_like(image, 255), K,
                                   (c - center) @ Rx.T + center, colors)
    pg = (got[:, W:] != shaded).any(-1)
    pw = (want[:, W:] != shaded).any(-1)
    assert pg.sum() > 50 and _near(pg, pw) and _near(pw, pg)


def test_scene_panel_within_a_pixel_of_cv2():
    d = _dets(9)
    det = jstruct.Detections(
        boxes=d["boxes2d"], scores=d["scores"], classes=d["classes"],
        valid=np.array([True, False, True]), corners3d=d["corners3d"])
    image = np.zeros((H, W, 3), np.uint8)
    got = tdraw.scene_panel(image, det, K, ["a", "b", "c"])
    want = jdraw.scene_panel(image, det, K, ["a", "b", "c"])
    assert got.shape == want.shape == (H, W + H, 3)
    keep = _without_labels((H, W), d["boxes2d"][[0, 2]])
    _same_drawing(got[:, :W], want[:, :W], keep=keep)
    _same_drawing(got[:, W:], want[:, W:], background=255)
    # Torch tensors are read as well.
    tdet = tstruct.Detections(**{k: torch.as_tensor(np.asarray(v)) for k, v
                                 in det.__dict__.items() if v is not None})
    np.testing.assert_array_equal(tdraw.scene_panel(image, tdet, K,
                                                    ["a", "b", "c"]), got)


# -- helpers ------------------------------------------------------------------


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(10)
    R = _rot(rng, 64).astype(np.float32)
    # Rotations near the quaternion's branch points too: 180 degrees about
    # each axis and the identity.
    R[:4] = [np.diag(v) for v in ([1, 1, 1], [1, -1, -1], [-1, 1, -1],
                                  [-1, -1, 1])]
    tR, jR = torch.from_numpy(R), jnp.asarray(R)
    for tf, jf in ((trot.matrix_to_rotation_6d, jrot.matrix_to_rotation_6d),
                   (trot.matrix_to_quaternion, jrot.matrix_to_quaternion),
                   (trot.matrix_to_euler_angles,
                    jrot.matrix_to_euler_angles)):
        np.testing.assert_allclose(tf(tR).numpy(), np.asarray(jf(jR)),
                                   rtol=0, atol=1e-6, err_msg=tf.__name__)
    q = trot.matrix_to_quaternion(tR)
    np.testing.assert_allclose(trot.quaternion_to_matrix(q).numpy(), R,
                               atol=1e-5)
    np.testing.assert_allclose(
        trot.euler_angles_to_matrix(trot.matrix_to_euler_angles(tR)).numpy(),
        R, atol=1e-5)
    with pytest.raises(NotImplementedError):
        trot.matrix_to_euler_angles(tR, "ZYX")
    g = torch.Generator().manual_seed(0)
    rr = trot.random_rotations(g, 16)
    eye = torch.eye(3).expand(16, 3, 3)
    torch.testing.assert_close(rr @ rr.transpose(-1, -2), eye, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(torch.linalg.det(rr), torch.ones(16),
                               atol=1e-5, rtol=0)
    assert torch.equal(rr, trot.random_rotations(
        torch.Generator().manual_seed(0), 16))


def test_structures_match_jax():
    rng = np.random.default_rng(11)
    xyxy = np.sort(rng.uniform(-20, 120, (2, 5, 4)).reshape(2, 5, 2, 2),
                   axis=-2).transpose(0, 1, 3, 2).reshape(2, 5, 4).astype(
                       np.float32)
    valid = rng.random((2, 5)) > 0.3
    tb = tstruct.Boxes2D(torch.tensor(xyxy), torch.tensor(valid))
    jb = jstruct.Boxes2D(jnp.asarray(xyxy), jnp.asarray(valid))
    for attr in ("centers", "widths", "heights"):
        np.testing.assert_array_equal(getattr(tb, attr).numpy(),
                                      np.asarray(getattr(jb, attr)))
    np.testing.assert_array_equal(tb.clip(80, 100).xyxy.numpy(),
                                  np.asarray(jb.clip(80, 100).xyxy))
    np.testing.assert_array_equal(tb.nonempty(5.0).numpy(),
                                  np.asarray(jb.nonempty(5.0)))

    def dets(seed):
        r = np.random.default_rng(seed)
        f = {"boxes": r.random((2, 3, 4), np.float32),
             "scores": r.random((2, 3), np.float32),
             "classes": r.integers(0, 5, (2, 3)).astype(np.int32),
             "valid": r.random((2, 3)) > 0.5,
             "corners3d": r.random((2, 3, 8, 3), np.float32)}
        return (tstruct.Detections(**{k: torch.tensor(v) for k, v in
                                      f.items()}),
                jstruct.Detections(**{k: jnp.asarray(v) for k, v in
                                      f.items()}))

    (t1, j1), (t2, j2) = dets(1), dets(2)
    tc, jc = tstruct.concatenate([t1, t2]), jstruct.concatenate([j1, j2])
    assert tc.pose is None and jc.pose is None
    for name, x in tc.items():
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(jc,
                                                                    name)))
    idx, keep = np.array([1, 0, 1]), np.array([[True, False, True]] * 3)
    tt = tstruct.take(t1, torch.tensor(idx), torch.tensor(keep))
    jt = jstruct.take(j1, jnp.asarray(idx), jnp.asarray(keep))
    for name, x in tt.items():
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(jt,
                                                                    name)))


def test_util_files_and_images_match_jax(tmp_path):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None}}
    tutil.save_json(tmp_path / "t" / "o.json", obj)
    jutil.save_json(tmp_path / "j" / "o.json", obj)
    assert ((tmp_path / "t" / "o.json").read_text()
            == (tmp_path / "j" / "o.json").read_text())
    assert tutil.load_json(tmp_path / "j" / "o.json") == obj
    tutil.save_pickle(tmp_path / "t" / "o.pkl", obj)
    assert jutil.load_pickle(tmp_path / "t" / "o.pkl") == obj
    assert tutil.load_pickle(tmp_path / "t" / "o.pkl") == obj
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    folder = tmp_path / "imgs"
    folder.mkdir()
    write_png(folder / "b.png", rgb)
    cv2.imwrite(str(folder / "a.JPG"), rgb[..., ::-1])
    cv2.imwrite(str(folder / "c.bmp"), rgb[..., ::-1])
    (folder / "notes.txt").write_text("x")
    assert tutil.list_images(folder) == jutil.list_images(folder)
    assert [p.name for p in tutil.list_images(folder)] == ["a.JPG", "b.png",
                                                          "c.bmp"]
    for p in tutil.list_images(folder):
        got, want = tutil.imread_rgb(p), jutil.imread_rgb(p)
        assert got.shape == want.shape and got.dtype == np.uint8
        if p.suffix == ".JPG":     # two JPEG decoders: within a level or two
            assert np.abs(got.astype(int) - want).max() <= 3
        else:
            np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tutil.imread_rgb(tmp_path / "missing.png")
    eta = tutil.ETA(4)
    assert eta.step(2).startswith("2/4 (")


def test_vit_presets_match_jax():
    from ovmono3d_tpu.models import vit as jvit
    from ovmono3d_tpu_torch.models import vit as tvit
    from ovmono3d_tpu_torch.utils.flax_bridge import plan

    for name in ("vit_base_14", "vit_large_14"):
        jm = getattr(jvit, name)(use_depth_fusion=False)
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 56, 56, 3)))
        tm = getattr(tvit, name)(use_depth_fusion=False, device="meta")
        assert len(plan(tm, params)) == len(list(tm.parameters()))
        assert (tm.pos_interp_offset, tm.embed_dim) == (
            jm.pos_interp_offset, jm.embed_dim)


def test_detect_open_vocabulary_matches_jax():
    from test_torch_gdino import GDINO_KWARGS, VOCAB, redraw

    from ovmono3d_tpu.models.gdino import inference as jinf
    from ovmono3d_tpu.models.gdino.model import GroundingDINO
    from ovmono3d_tpu.models.gdino.tokenizer import BertTokenizer as JTok
    from ovmono3d_tpu_torch.models.gdino import inference as tinf
    from ovmono3d_tpu_torch.models.gdino.tokenizer import BertTokenizer
    from ovmono3d_tpu_torch.models.ovmono3d import build_gdino
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

    cats = ["chair", "traffic cone", "shoes"]
    image = np.random.default_rng(13).standard_normal((96, 64, 3)).astype(
        np.float32)
    model = GroundingDINO(**GDINO_KWARGS, compute_dtype=jnp.float32)
    text = jinf.build_text_inputs(JTok(VOCAB), cats, 32)
    params = redraw(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(image[None]),
        *(jnp.asarray(text[k]) for k in ("input_ids", "text_mask",
                                         "text_self_mask", "position_ids"))),
        12)
    # The JAX glue builds its prompt at 256 tokens; this detector reads 32.
    orig = jinf.build_text_inputs
    jinf.build_text_inputs = lambda tok, c: orig(tok, c, 32)
    try:
        # Only the module's apply is read: jitted, it compiles once.
        want = jinf.detect_open_vocabulary(
            SimpleNamespace(apply=jax.jit(model.apply)), params,
            jnp.asarray(image), JTok(VOCAB), cats, topk=10)
    finally:
        jinf.build_text_inputs = orig
    port = build_gdino({**GDINO_KWARGS, "compute_dtype": torch.float32},
                       device="cpu")
    load_flax_params(port, params)
    got = tinf.detect_open_vocabulary(port, torch.from_numpy(image),
                                      BertTokenizer(VOCAB), cats, topk=10)
    assert got["valid"].any()
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-3)


def test_json_and_pickle_are_the_standard_formats(tmp_path):
    tutil.save_json(tmp_path / "a.json", [1, 2])
    assert json.loads((tmp_path / "a.json").read_text()) == [1, 2]
    tutil.save_pickle(tmp_path / "a.pkl", (3,))
    assert pickle.loads((tmp_path / "a.pkl").read_bytes()) == (3,)
