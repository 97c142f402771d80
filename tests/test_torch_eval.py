"""The port's Omni3D evaluation path against the JAX package: exact 3D IoU
(`pairwise_iou3d` / `matched_iou3d`), the evaluator and the multi-dataset
helper (same AP dicts), the AP tables (same strings), the eval CLI's GT
records, its `evaluate_dataset` on bridged weights (oracle and learned 2D),
and the CLI end to end on generated data and on the on-disk fixture
tests/fixtures/tiny_omni3d.py, all on the CPU.

Limits: IoU volumes and ratios within 1e-5 (f32 on both sides, sums in
another order); AP dicts within 1e-6 (no IoU here sits on a threshold);
the model's outputs within 2e-2 of each field's scale (its trunk runs in
bf16 and the frameworks round it at different places), its integer outputs
equal. AP is compared as a number only where the geometry is exact: GT as
the prediction, or the GT-oracle protocol's 2D boxes, give 100.
"""
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fixtures.tiny_omni3d import build_dataset
from test_torch_config_data import TINY, _configs, _load
from test_torch_detect2d import _spread_heads
from test_torch_rcnn3d import _spread, to_flax, training_tree

from ovmono3d_tpu.data import datasets as jdatasets
from ovmono3d_tpu.evaluation import helper as jhelper
from ovmono3d_tpu.evaluation import omni3d_eval as jeval
from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu.ops import iou3d as jiou3d
from ovmono3d_tpu.ops import rotation as jrot
from ovmono3d_tpu.utils.geometry import cuboid_corners
from ovmono3d_tpu.vis import logperf as jlogperf
from ovmono3d_tpu_torch.data import build as tbuild
from ovmono3d_tpu_torch.data.synthetic import synthetic_datasets
from ovmono3d_tpu_torch.eval import cli as tcli
from ovmono3d_tpu_torch.evaluation import helper as thelper
from ovmono3d_tpu_torch.evaluation import omni3d_eval as teval
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.ops import iou3d as tiou3d
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from ovmono3d_tpu_torch.vis import logperf as tlogperf

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def eval_net():
    """tools/eval_net.py as a module (its main is guarded)."""
    spec = importlib.util.spec_from_file_location(
        "eval_net", REPO / "tools" / "eval_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tinyds(tmp_path_factory):
    return build_dataset(tmp_path_factory.mktemp("tiny_omni3d"))


def _box(x, y, z, w, h, l, rot=None):
    return np.array(cuboid_corners(
        jnp.array([x, y, z, w, h, l], jnp.float32),
        None if rot is None else jnp.asarray(rot, jnp.float32)))


def _rot_y(angle):
    return np.asarray(jrot.euler_angles_to_matrix(
        jnp.array([0.0, angle, 0.0]), "XYZ"))


BOX_CASES = {
    "identical": (_box(0, 0, 5, 1, 2, 3), _box(0, 0, 5, 1, 2, 3)),
    "disjoint": (_box(0, 0, 5, 1, 1, 1), _box(10, 0, 5, 1, 1, 1)),
    "nested": (_box(0, 0, 5, 2, 2, 2), _box(0.2, 0.1, 5, 1, 1, 1)),
    "partial": (_box(0, 0, 5, 1, 1, 1), _box(0.5, 0, 5, 1, 1, 1)),
    "rotated_45": (_box(0, 0, 5, 1, 1, 1),
                   _box(0, 0, 5, 1, 1, 1, _rot_y(math.pi / 4))),
    "touching": (_box(0, 0, 5, 1, 1, 1), _box(1.0, 0, 5, 1, 1, 1)),
    "rotated_offset": (_box(0.3, -0.2, 6, 1.2, 0.8, 2.0, _rot_y(0.7)),
                       _box(0, 0, 6.4, 1.0, 1.0, 1.5, _rot_y(-0.3))),
}


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_iou3d_matches_jax(case):
    a, b = (c[None] for c in BOX_CASES[case])
    want_vol, want_iou = jiou3d.pairwise_iou3d(jnp.asarray(a),
                                               jnp.asarray(b))
    got_vol, got_iou = tiou3d.pairwise_iou3d(torch.from_numpy(a),
                                             torch.from_numpy(b))
    np.testing.assert_allclose(got_vol.numpy(), np.asarray(want_vol),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou),
                               atol=1e-5)
    np.testing.assert_allclose(
        tiou3d.matched_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jiou3d.matched_iou3d(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)
    np.testing.assert_allclose(tiou3d.box_volume(torch.from_numpy(a)).numpy(),
                               np.asarray(jiou3d.box_volume(jnp.asarray(a))),
                               rtol=1e-6)


def _random_boxes(rng, n):
    out = []
    for _ in range(n):
        x, y = rng.uniform(-1, 1, 2)
        z = rng.uniform(4, 6)
        w, h, l = rng.uniform(0.3, 1.5, 3)
        out.append(_box(x, y, z, w, h, l, _rot_y(rng.uniform(-3, 3))))
    return np.stack(out) if out else np.zeros((0, 8, 3), np.float32)


def test_iou3d_pairwise_random_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 9), _random_boxes(rng, 7)
    want = jiou3d.pairwise_iou3d(jnp.asarray(a), jnp.asarray(b))
    got = tiou3d.pairwise_iou3d(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert (got[1] > 0).sum() >= 5 and (got[1] == 0).sum() >= 5
    empty = tiou3d.pairwise_iou3d(torch.from_numpy(a[:0]),
                                  torch.from_numpy(b))[1]
    assert tuple(empty.shape) == (0, 7)


def _images(seed, n_img, n_cls):
    """GT and noisy predictions of `n_img` images, with ignores and
    class-agnostic ignore regions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_img):
        g = int(rng.integers(1, 5))
        boxes = _random_boxes(rng, g)
        cls = rng.integers(0, n_cls, g)
        cls[rng.random(g) < 0.15] = -1
        ign = rng.random(g) < 0.15
        b2 = np.stack([boxes[:, :, 0].min(1), boxes[:, :, 1].min(1),
                       boxes[:, :, 0].max(1), boxes[:, :, 1].max(1)], 1) * 60
        b2 += 200
        gt = {"classes": cls.astype(np.int64), "ignore": ign,
              "boxes2d": b2, "corners3d": boxes,
              "depths": boxes[:, :, 2].mean(1),
              "center": boxes.mean(1), "dims": np.ones((g, 3)),
              "pose": np.tile(np.eye(3), (g, 1, 1))}
        keep = rng.random(g) < 0.8
        extra = int(rng.integers(0, 3))
        pb = np.concatenate([boxes[keep] + rng.normal(0, 0.08, (keep.sum(),
                                                                1, 3)),
                             _random_boxes(rng, extra)])
        d = len(pb)
        pred = {"classes": np.concatenate([np.abs(cls[keep]),
                                           rng.integers(0, n_cls, extra)]),
                "scores": rng.random(d),
                "boxes2d": np.concatenate([b2[keep] + rng.normal(0, 4, (
                    keep.sum(), 4)), rng.random((extra, 4)) * 50 + 200]),
                "corners3d": pb.astype(np.float32),
                "center": pb.mean(1), "dims": np.ones((d, 3)) * 1.1,
                "pose": np.tile(np.eye(3), (d, 1, 1))}
        out.append((gt, pred))
    return out


def _same(got, want, path="res"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), atol=1e-6,
                                   equal_nan=True, err_msg=path)


@pytest.mark.parametrize("mode", ["2D", "3D"])
@pytest.mark.parametrize("prox", [False, True], ids=["all", "prox"])
def test_evaluator_matches_jax(mode, prox):
    port = teval.Omni3DEvaluator(3, mode, eval_prox=prox, device="cpu")
    ref = jeval.Omni3DEvaluator(3, mode, eval_prox=prox)
    for gt, pred in _images(1, 12, 3):
        port.add_image(gt, pred)
        ref.add_image(gt, pred)
    res = port.summarize()
    _same(res, ref.summarize())
    _same(port.per_category_ap(), ref.per_category_ap())
    assert res[f"AP{mode}"] > 0


def test_helper_matches_jax_and_tables_are_equal():
    names = ["chair", "board", "tram"]
    port = thelper.Omni3DEvaluationHelper(3, names, novel_categories={
        "board", "tram"}, device="cpu")
    ref = jhelper.Omni3DEvaluationHelper(3, names,
                                         novel_categories={"board", "tram"})
    for ds, seed in (("Objectron_test", 2), ("KITTI_test", 3)):
        for gt, pred in _images(seed, 6, 3):
            for h in (port, ref):
                h.add_image(ds, gt, pred, eval_prox=ds.startswith("Obj"))
    got, want = port.summarize_all(), ref.summarize_all()
    _same(got, want)
    for fn in ("print_ap_summary", "print_ap_per_category"):
        for arg in (got["overall"], got["per_category_AP3D"]):
            assert getattr(tlogperf, fn)(arg, title="t") == \
                getattr(jlogperf, fn)(arg, title="t")
    assert tlogperf.print_ap_analysis(got["datasets"]) == \
        jlogperf.print_ap_analysis(got["datasets"])


def test_record_gt_matches_jax(eval_net, tinyds):
    tc, jc = _configs()
    for rec in _load(jdatasets, jc, tinyds) + synthetic_datasets(
            4, list("abcd"))[0]["synthetic_a"]:
        got, want = tcli._record_gt(rec), eval_net._record_gt(rec)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_gt_as_prediction_gives_ap_100(tinyds):
    tc, jc = _configs()
    helper = thelper.Omni3DEvaluationHelper(2, ["chair", "cup"],
                                            device="cpu")
    for rec in _load(jdatasets, jc, tinyds):
        gt = tcli._record_gt(rec)
        keep = gt["classes"] >= 0
        pred = {k: v[keep] for k, v in gt.items()}
        pred["scores"] = np.ones(int(keep.sum()))
        helper.add_image("TinyDS_test", gt, pred)
    res = helper.summarize_all()["datasets"]["TinyDS_test"]
    assert res["AP2D"] == pytest.approx(100.0)
    assert res["AP3D"] == pytest.approx(100.0)


class _Recorder:
    """A helper stand-in that keeps what evaluate_dataset hands it."""

    def __init__(self):
        self.images, self.class_names = [], []

    def add_image(self, dataset, gt, pred, eval_prox=False):
        self.images.append((dataset, gt, pred, eval_prox))


@pytest.fixture(scope="module")
def bridged(tinyds):
    """The tiny model in both packages on the same (spread) weights."""
    tc, jc = _configs()
    jmodel = jax_build_model(jc.model)
    port = build_model(tc.model, device="cpu")
    s = tc.model.backbone.square_pad
    params = _spread_heads(_spread(to_flax(port, training_tree(
        jmodel, (2, s, s, 3), 3))))
    load_flax_params(port, params)
    return tc, jc, port, jmodel, params


@pytest.mark.parametrize("which", ["synthetic_oracle", "fixture_learned"])
def test_evaluate_dataset_matches_jax(eval_net, bridged, tinyds, which):
    tc, jc, port, jmodel, params = bridged
    if which == "synthetic_oracle":
        records = synthetic_datasets(2, ["chair", "cup"], num=5)[0][
            "synthetic_a"]
        loader = None
    else:
        records = [{k: v for k, v in r.items() if k != "oracle2d"}
                   for r in _load(jdatasets, jc, tinyds)]
        loader = tbuild.default_image_loader(str(tinyds["root"]))
    got, want = _Recorder(), _Recorder()
    stats = tcli.evaluate_dataset(tc, port, records, loader, 3, got, "ds")
    eval_net.evaluate_dataset(jc, jmodel, params, records, loader, 3, want,
                              "ds")
    assert stats["images"] == len(records) == len(got.images)
    assert len(stats["batch_ms"]) == 2
    assert len(got.images) == len(want.images)
    n_det = n_matched = 0
    for (_, g_gt, g_pred, _), (_, w_gt, w_pred, _) in zip(got.images,
                                                          want.images):
        for k in w_gt:
            np.testing.assert_allclose(g_gt[k], w_gt[k], rtol=1e-6,
                                       atol=1e-6)
        pairs = _match(g_pred, w_pred)
        for k in ("scores", "boxes2d", "center", "dims", "pose", "corners3d",
                  "center_2d"):
            w = np.asarray(w_pred[k], np.float64)[[j for _, j in pairs]]
            g = np.asarray(g_pred[k])[[i for i, _ in pairs]]
            if w.size:
                np.testing.assert_allclose(g, w, rtol=2e-2,
                                           atol=2e-2 * np.abs(w).max(),
                                           err_msg=k)
        n_det += len(w_pred["classes"])
        n_matched += len(pairs)
        if which == "synthetic_oracle":
            assert len(pairs) == len(w_pred["classes"]) == \
                len(g_pred["classes"])
    assert n_det > 0
    # Learned 2D on the fixture's noise images: the RPN's and the NMS's
    # near-tied decisions flip under the trunk's bf16 rounding, so some
    # detections leave the kept set and others enter it (282 of 303 kept in
    # both when written; tests/test_torch_detect2d.py holds the same chain
    # exactly on shared features). Nine in ten must be the same (class, 2D
    # box), and those agree in every field.
    assert n_matched >= 0.9 * n_det, (n_matched, n_det)


def _match(got: dict, want: dict) -> list[tuple[int, int]]:
    """(port, JAX) index pairs of detections with one class and 2D boxes
    within 2% of their scale, in the JAX detections' order."""
    pairs, used = [], set()
    gb, wb = np.asarray(got["boxes2d"]), np.asarray(want["boxes2d"])
    scale = max(float(np.abs(wb).max()) if wb.size else 1.0, 1.0)
    for j in range(len(wb)):
        for i in range(len(gb)):
            if (i not in used and got["classes"][i] == want["classes"][j]
                    and np.abs(gb[i] - wb[j]).max() <= 2e-2 * scale):
                pairs.append((i, j))
                used.add(i)
                break
    return pairs


def test_cli_synthetic_oracle_and_learned(capsys):
    summary = tcli.main(["--synthetic", "--device", "cpu",
                         "--batch-size", "8", *TINY])
    out = capsys.readouterr().out
    for name in ("synthetic_a", "synthetic_b"):
        assert summary["datasets"][name]["AP2D"] == pytest.approx(100.0)
        assert math.isfinite(summary["datasets"][name]["AP3D"])
    assert re.search(r"synthetic_b \| 100\.00", out), out
    summary = tcli.main(["--synthetic", "--device", "cpu", *TINY,
                         "test.oracle2d=false"])
    assert set(summary["datasets"]) == {"synthetic_a", "synthetic_b"}


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "learned"])
def test_cli_on_the_fixture(tinyds, tmp_path, capsys, oracle):
    dump = tmp_path / "preds"
    summary = tcli.main([
        "--config-file", str(REPO / "configs" / "OVMono3D_dinov2_SFP.yaml"),
        "--device", "cpu", "--batch-size", "4",
        "--dump-predictions", str(dump), *TINY,
        f"datasets.data_root={tinyds['root']}",
        f"datasets.depth_dir={tinyds['root'] / 'depth'}",
        "datasets.test_base=TinyDS_test", "test.cat_mode=base",
        f"test.oracle2d={str(oracle).lower()}",
        "datasets.oracle2d_files.target_aware.base.TinyDS_test="
        f"{tinyds['oracle']}"])
    res = summary["datasets"]["TinyDS_test"]
    if oracle:
        assert res["AP2D"] == pytest.approx(100.0)
    assert all(math.isfinite(res[k]) for k in ("AP2D", "AP3D"))
    preds = (tmp_path / "preds_TinyDS_test.json").read_text()
    assert '"image_id": 100' in preds
    capsys.readouterr()


@pytest.mark.parametrize("flag", [["--vis-dir", "v"]])
def test_cli_refuses_what_is_not_ported(flag):
    """Nothing is refused any more: --vis-dir, the last flag that was, now
    parses with tools/eval_net.py's --vis-period default (its panels are
    tests/test_torch_demo.py's)."""
    args = tcli.parse_args(["--synthetic", *flag])
    assert (args.vis_dir, args.vis_period) == ("v", 50)


@pytest.mark.parametrize("priors", ["from_file", "priors_flag"])
def test_cli_loads_rcnn_ckpt(tmp_path, monkeypatch, capsys, priors):
    """--rcnn-ckpt: a released-layout file (utils/release_states.py) loads
    into the evaluated model -- every parameter equal to the converted tree
    under the bridge's rule -- and its priors reach the model unless
    --priors names others; the oracle protocol gives AP2D 100."""
    from ovmono3d_tpu_torch.config import load_config
    from ovmono3d_tpu_torch.utils import flax_bridge, release_states
    from ovmono3d_tpu_torch.utils.lift_convert import convert_ovmono3d_lift

    mcfg = load_config(None, overrides=TINY).model
    state = release_states.lift_state(mcfg, seed=1)
    path = tmp_path / "ovmono3d_lift.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               path)
    argv = ["--synthetic", "--device", "cpu", "--rcnn-ckpt", str(path),
            *TINY]
    want_priors = {"dims": state["roi_heads.priors_dims_per_cat"][0],
                   "z_scales": state["roi_heads.priors_z_scales"],
                   "z_stats": state["roi_heads.priors_z_stats"]}
    if priors == "priors_flag":
        want_priors = {k: v + 1.0 for k, v in want_priors.items()}
        np.savez(tmp_path / "p.npz", **want_priors)
        argv += ["--priors", str(tmp_path / "p.npz")]
    built = []
    monkeypatch.setattr(tcli, "build_model", lambda *a, **k: built.append(
        build_model(*a, **k)) or built[-1])
    summary = tcli.main(argv)
    capsys.readouterr()
    (model,) = built
    assert sorted(model.priors) == sorted(want_priors)
    for k, v in want_priors.items():
        np.testing.assert_array_equal(model.priors[k].numpy(), v)
    tree = convert_ovmono3d_lift(state, depth=mcfg.backbone.depth)
    params = dict(model.named_parameters())
    for name, arr in flax_bridge.torch_arrays(model, tree).items():
        np.testing.assert_array_equal(params[name].detach().numpy(), arr)
    for name in ("synthetic_a", "synthetic_b"):
        assert summary["datasets"][name]["AP2D"] == pytest.approx(100.0)
        assert math.isfinite(summary["datasets"][name]["AP3D"])
