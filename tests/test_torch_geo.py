"""The port's GEO pipeline against the JAX package: the box fit and its
density filter, the synthetic scene and self-check, one image through
`predict_image` at tiny models against the same composition of JAX modules,
and the CLI over the tiny Omni3D fixture (`--config-file --eval`,
`--eval-only`, `geo.eval_cli`, `--max-instances`) against the JAX tool's
evaluation and box selection (CPU)."""
import contextlib
import copy
import dataclasses
import io
import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu import config as jcfg
from ovmono3d_tpu.data import datasets as jdatasets
from ovmono3d_tpu.geo import pipeline as jgeo
from ovmono3d_tpu.models.depth import DepthPro as JaxDepthPro
from ovmono3d_tpu.models.depth import metric_depth as jax_metric_depth
from ovmono3d_tpu.models.sam import SamSegmenter as JaxSamSegmenter
from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
from ovmono3d_tpu_torch.geo import cli, eval_cli
from ovmono3d_tpu_torch.geo import pipeline as tgeo
from ovmono3d_tpu_torch.models.depth import DepthPro
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from fixtures.tiny_omni3d import build_dataset
from test_geo import _render_box_depth
from test_torch_depth import TINY, depth_params
from test_torch_eval import _same
from test_torch_sam import SAM_KW, rel_pos_filled
from tools import ovmono3d_geo as jax_cli

torch.set_num_threads(2)


def _outlier_case():
    """tests/test_geo.py's outlier case: a dense face with 8 pixels pushed
    to 9 m."""
    mask, depth, K = _render_box_depth((0.0, 0.0, 3.0), (0.5, 0.6, 0.6),
                                       H=224, W=224, f=350.0)
    ys, xs = np.where(mask > 0)
    for i in range(8):
        depth[ys[i * 97 % len(ys)], xs[i * 131 % len(xs)]] = 9.0
    return mask, depth, K


CASES = {
    "front_face": lambda: _render_box_depth((0.2, -0.1, 3.0), (0.8, 0.6, 1.0)),
    "outliers": _outlier_case,
}


def _fit_both(mask, depth, K):
    want = jgeo.fit_box_from_mask_depth(jnp.asarray(mask), jnp.asarray(depth),
                                        jnp.asarray(K))
    got = tgeo.fit_box_from_mask_depth(torch.from_numpy(mask),
                                       torch.from_numpy(depth),
                                       torch.from_numpy(K))
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(case):
    got, want = _fit_both(*CASES[case]())
    assert bool(got["valid"]) and bool(want["valid"])
    # The same points kept.
    assert int(got["num_points"]) == int(want["num_points"])
    # f32 sums over ~10^4 points in another order; the outlier case is a
    # near-planar cloud whose yaw is ill-conditioned (1.3e-5 rad apart),
    # which moves the corners by ~1e-5 m. The pose is compared as R: the
    # SVD's U and V^T signs are free.
    for key, tol in (("center", 1e-5), ("dims", 1e-4), ("corners", 1e-4),
                     ("pose", 1e-4), ("yaw", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=tol,
                                   rtol=0, err_msg=key)


def test_density_filter_keeps_the_same_points():
    """robust_extent_mask on the same mean-centred points, with far
    outliers: keep masks equal at every eps of the schedule."""
    mask, depth, K = _outlier_case()
    pts = np.asarray(jgeo.unproject_depth(jnp.asarray(depth), jnp.asarray(K)))
    pts = pts.reshape(-1, 3)
    m = (mask > 0.5).reshape(-1) & (depth.reshape(-1) > 0)
    pts = pts - pts[m].mean(0)
    tpts, tm = torch.from_numpy(pts)[None], torch.from_numpy(m)[None]
    for eps in (0.01, 0.02, 0.04, 0.08):
        want = jgeo._voxel_density_keep(jnp.asarray(pts), jnp.asarray(m),
                                        jnp.asarray(eps), 100)
        got = tgeo._voxel_density_keep(tpts, tm, eps, 100)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jgeo.robust_extent_mask(jnp.asarray(pts), jnp.asarray(m))
    got = tgeo.robust_extent_mask(tpts, tm)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < m.sum()         # the outliers went


def test_batched_fit_equals_per_mask_fits():
    K, depth, masks, _ = cli.synthetic_scene(np.random.RandomState(0))
    empty = np.zeros_like(masks[0])
    stack = torch.from_numpy(np.stack(masks + [empty]))
    batched = tgeo.fit_box_from_mask_depth(stack, torch.from_numpy(depth),
                                           torch.from_numpy(K))
    assert batched["valid"].tolist() == [True, True, True, False]
    for i in range(3):
        one = tgeo.fit_box_from_mask_depth(stack[i], torch.from_numpy(depth),
                                           torch.from_numpy(K))
        for key in ("center", "dims", "pose", "corners", "num_points"):
            torch.testing.assert_close(batched[key][i], one[key], rtol=1e-6,
                                       atol=1e-6)
    # An empty mask gives zeros and the identity, flagged invalid.
    assert batched["num_points"][3] == 0
    assert not batched["center"][3].any() and not batched["dims"][3].any()
    torch.testing.assert_close(batched["pose"][3], torch.eye(3))


def test_synthetic_scene_matches_jax_tool():
    want = jax_cli.synthetic_scene(np.random.RandomState(0))
    got = cli.synthetic_scene(np.random.RandomState(0))
    np.testing.assert_array_equal(got[0], want[0])          # K
    np.testing.assert_array_equal(got[1], want[1])          # depth
    for g, w in zip(got[2], want[2]):                       # masks
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[3], want[3]):
        for key in ("center", "dims", "front_z"):
            np.testing.assert_array_equal(g[key], w[key])


def test_synthetic_self_check_passes(tmp_path, capsys):
    ok, err_c, err_d, preds = cli.synthetic_check("cpu")
    assert ok and err_c < 0.1 and err_d < 0.15 and len(preds) == 3
    cli.main(["--synthetic", "--device", "cpu",
              "--output-dir", str(tmp_path)])
    assert "GEO synthetic self-check: PASS" in capsys.readouterr().out
    assert (tmp_path / "geo_predictions_synthetic.pkl").is_file()


@pytest.mark.parametrize("fmt", ["sam", "depth_pth", "depth_npz"])
def test_cli_checkpoint_flags_load(geo_models, tmp_path, monkeypatch, fmt):
    """--sam-ckpt (an official segment-anything file of --sam-arch's depth)
    and --depth-ckpt (HF-layout .pth or flat flax-path .npz, the JAX CLI's
    two branches) load into the models the CLI serves the fixture with:
    every parameter equal to the converted tree under the bridge's rule."""
    from ovmono3d_tpu_torch.utils import flax_bridge, release_states
    from ovmono3d_tpu_torch.utils.depth_convert import convert_depth_pro
    from ovmono3d_tpu_torch.utils.sam_convert import (convert_sam_encoder,
                                                      convert_sam_segmenter)

    _, tiny = geo_models
    models = cli.GeoModels(*(copy.deepcopy(m) for m in (
        tiny.sam_encoder, tiny.segmenter, tiny.depth)), sam_size=S_SAM,
        depth_size=S_DEPTH, max_instances=MAX_INSTANCES)
    monkeypatch.setattr(cli, "build_geo_models", lambda *a, **k: models)
    monkeypatch.setitem(cli.SAM_ARCHS, "tiny", dict(
        embed_dim=SAM_KW["embed_dim"], depth=SAM_KW["depth"],
        num_heads=SAM_KW["num_heads"], global_blocks=SAM_KW["global_blocks"]))
    if fmt == "sam":
        state = release_states.sam_state(
            embed_dim=32, depth=3, num_heads=2, global_blocks=(1,),
            window_size=4, grid=6, patch=8, neck=16, decoder_dim=16,
            decoder_mlp=32, seed=4)
        pairs = [(models.sam_encoder, convert_sam_encoder(state, depth=3)),
                 (models.segmenter, convert_sam_segmenter(state))]
        path = tmp_path / "sam_vit_tiny.pth"
    else:
        state = release_states.depth_pro_state(seed=5, **TINY)
        pairs = [(models.depth, convert_depth_pro(state))]
        path = tmp_path / "depth_pro.pth"
    if fmt == "depth_npz":
        path = tmp_path / "depth_pro.npz"
        np.savez(path, **{"params/" + k: v for k, v in
                          flax_bridge._flatten(pairs[0][1]).items()})
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    flag = "--sam-ckpt" if fmt == "sam" else "--depth-ckpt"
    tinyds = build_dataset(tmp_path / "tiny_omni3d")
    res, _ = _run(cli.main, _dataset_argv(tinyds, tmp_path / "out")
                  + ["--sam-arch", "tiny", flag, str(path)])
    assert res["TinyDS_test"]["images"] == 4
    for module, tree in pairs:
        ref = dict(module.named_parameters())
        for name, arr in flax_bridge.torch_arrays(module, tree).items():
            np.testing.assert_array_equal(ref[name].detach().numpy(), arr)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default is the card, which is here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.build_geo_models(depth_bf16=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.synthetic_check()


# -- one image through the slice at tiny models --------------------------

SEG_KW = dict(embed_dim=16, decoder_mlp_dim=32)
S_SAM, S_DEPTH, MAX_INSTANCES = 48, 128, 3
MEAN = np.array(cli.PIXEL_MEAN, np.float32)
STD = np.array(cli.PIXEL_STD, np.float32)


def _jax_resize(x, hw):
    """cv2.resize's INTER_LINEAR as the JAX package's F.interpolate
    counterparts compute it."""
    return jax.image.resize(x, (*hw, *x.shape[2:]), "bilinear",
                            antialias=False)


def jax_predict(jmods, image, K, dets):
    """tools/ovmono3d_geo.py:340-400 with the JAX modules, jax.image.resize
    in place of cv2.resize, one SAM call and one fit per box."""
    (sam, p_sam), (seg, p_seg), (dp, p_dp) = jmods
    img = image.astype(np.float32) / 255.0
    H, W = img.shape[:2]
    dimg = _jax_resize(jnp.asarray(img), (S_DEPTH, S_DEPTH))
    dout = dp.apply(p_dp, ((dimg - MEAN) / STD)[None])
    depth_full = jax_metric_depth(dout["canonical_inverse_depth"],
                                  jnp.asarray([K[0, 0] * S_DEPTH / W]),
                                  S_DEPTH)[0]
    depth_map = _jax_resize(depth_full, (H, W))
    scale = S_SAM / max(H, W)
    simg = _jax_resize(jnp.asarray(img), (int(H * scale), int(W * scale)))
    canvas = jnp.zeros((S_SAM, S_SAM, 3)).at[:simg.shape[0], :simg.shape[1]
                                             ].set((simg - MEAN) / STD)
    embed = sam.apply(p_sam, canvas[None])["last_feat"]
    kept = sorted((d for d in dets if d["score"] >= cli.SCORE_THRESHOLD),
                  key=lambda d: -d["score"])[:MAX_INSTANCES]
    preds, logits = [], []
    for det in kept:
        box = np.asarray(det["bbox2d"], np.float32) * scale
        masks, _ = seg.apply(p_seg, embed, jnp.asarray(box)[None],
                             float(S_SAM))
        m = masks[0, 2]
        logits.append(np.asarray(m))
        ch = max(1, int(round(m.shape[0] * (H * scale) / S_SAM)))
        cw = max(1, int(round(m.shape[1] * (W * scale) / S_SAM)))
        mask_img = _jax_resize(m[:ch, :cw], (H, W)) > 0
        out = jgeo.fit_box_from_mask_depth(mask_img.astype(jnp.float32),
                                           depth_map, jnp.asarray(K))
        if bool(out["valid"]):
            preds.append({k: np.asarray(out[k]) for k in
                          ("center", "dims", "pose")})
    trace = {"depth_map": np.asarray(depth_map), "embed": np.asarray(embed),
             "mask_logits": np.stack(logits)}
    return preds, trace


@pytest.fixture(scope="module")
def geo_models():
    """The tiny SAM encoder, SAM decoder and Depth-Pro in f32 in both
    packages, the same weights: (JAX (module, params) pairs, GeoModels)."""
    sam = JaxViT(dtype=jnp.float32, **SAM_KW)
    p_sam = rel_pos_filled(jax.jit(sam.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, S_SAM, S_SAM, 3))))
    seg = JaxSamSegmenter(**SEG_KW)
    p_seg = jax.tree_util.tree_map(np.asarray, jax.jit(seg.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 6, 6, 16)), jnp.zeros((1, 4)),
        float(S_SAM)))
    dp = JaxDepthPro(dtype=jnp.float32, **TINY)
    p_dp = depth_params(jax.jit(dp.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, S_DEPTH, S_DEPTH, 3))))
    models = cli.GeoModels(
        VisionTransformer(dtype=torch.float32, pos_interp_offset=0.0,
                          **SAM_KW),
        SamSegmenter(**SEG_KW), DepthPro(dtype=torch.float32, **TINY),
        sam_size=S_SAM, depth_size=S_DEPTH, max_instances=MAX_INSTANCES)
    for port, params in ((models.sam_encoder, p_sam),
                         (models.segmenter, p_seg), (models.depth, p_dp)):
        load_flax_params(port, params)
    return ((sam, p_sam), (seg, p_seg), (dp, p_dp)), models


@pytest.fixture(scope="module")
def geo_pair(geo_models):
    jmods, models = geo_models
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    K = np.array([[60.0, 0, 28.0], [0, 60.0, 20.0], [0, 0, 1]], np.float32)
    dets = [{"bbox2d": b, "score": s, "category_id": i}
            for i, (b, s) in enumerate([
                ([4.0, 3.0, 30.0, 25.0], 0.9), ([10.0, 10.0, 20.0, 20.0], 0.2),
                ([20.0, 5.0, 55.0, 39.0], 0.5), ([0.0, 0.0, 50.0, 36.0], 0.95),
                ([30.0, 12.0, 45.0, 30.0], 0.4)])]
    trace: dict = {}
    got = cli.predict_image(models, image, K, dets, trace=trace)
    want = jax_predict(jmods, image, K, dets)
    return got, trace, want


def test_predict_image_intermediates_match_jax(geo_pair):
    _, trace, (_, want) = geo_pair
    assert set(trace["ms"]) == {"depth", "sam_encoder", "segment", "fit"}
    # f32 through the tiny Depth-Pro, SAM encoder and decoder; sums in
    # another order.
    for key in ("depth_map", "embed", "mask_logits"):
        got = trace[key].numpy()
        if key == "embed":
            assert got.shape == (1, 6, 6, 16)
        np.testing.assert_allclose(got, want[key], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[key]).max(),
                                   err_msg=key)


def test_predict_image_matches_jax(geo_pair):
    got, _, (want, _) = geo_pair
    # The threshold drops the 0.2 box, max_instances the 0.4 one; the rest
    # in score order.
    assert [p["category_id"] for p in got] == [3, 0, 2][:len(got)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        # The same masks and depth up to f32 rounding: boxes within 1e-4.
        np.testing.assert_allclose(g["center_cam"], w["center"], atol=1e-4)
        np.testing.assert_allclose(g["dimensions"], w["dims"], atol=1e-4)
        np.testing.assert_allclose(g["pose"], w["pose"], atol=1e-3)


# -- the CLI over a dataset on the tiny Omni3D fixture ---------------------

REPO = Path(__file__).resolve().parents[1]
GEO_CLASSES = ["chair", "cup"]


def _dataset_argv(tinyds, out_dir):
    return ["--config-file",
            str(REPO / "configs" / "OVMono3D_dinov2_SFP.yaml"),
            "--device", "cpu", "--output-dir", str(out_dir),
            f"datasets.data_root={tinyds['root']}",
            "datasets.test_novel=TinyDS_test",
            f"datasets.category_names={','.join(GEO_CLASSES)}",
            "datasets.oracle2d_files.target_aware.novel.TinyDS_test="
            f"{tinyds['oracle']}"]


def _run(fn, *args):
    """fn(*args) and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


@pytest.fixture(scope="module")
def geo_dataset_run(geo_models, tmp_path_factory):
    """`geo.cli --config-file --eval` over the fixture's test split with the
    tiny models (in place of `build_geo_models`' full-size ones): (fixture,
    output dir, the CLI's result, what it printed)."""
    _, models = geo_models
    tinyds = build_dataset(tmp_path_factory.mktemp("tiny_omni3d"))
    out_dir = tmp_path_factory.mktemp("geo")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build_geo_models",
                   lambda *a, **k: dataclasses.replace(models))
        res, printed = _run(cli.main, _dataset_argv(tinyds, out_dir)
                            + ["--eval"])
    return tinyds, out_dir, res, printed


def test_cli_dataset_eval_matches_jax_evaluation(geo_dataset_run):
    """The CLI's predictions for the 4 test images, evaluated by the JAX
    tool's `evaluate_geo_predictions` on the same records: the same result
    (to 1e-6) and the same printed table."""
    tinyds, out_dir, res, printed = geo_dataset_run
    with open(out_dir / "geo_predictions_TinyDS_test.pkl", "rb") as fh:
        preds_all = pickle.load(fh)
    assert sorted(preds_all) == [100, 101, 102, 103]
    assert sum(len(v) for v in preds_all.values()) > 0
    run = res["TinyDS_test"]
    assert run["images"] == 4
    assert set(run["stage_ms"]) == {"depth", "sam_encoder", "segment", "fit"}
    argv = _dataset_argv(tinyds, out_dir)
    jc = jcfg.load_config(argv[1], overrides=argv[6:])
    cat_map = {n: i for i, n in enumerate(GEO_CLASSES)}
    jdatasets.simple_register("TinyDS_test", tinyds["root"] / "Omni3D"
                              / "TinyDS_test.json",
                              jdatasets.filter_settings_from_cfg(jc), cat_map)
    records = jdatasets.get_dataset("TinyDS_test")
    want, want_printed = _run(jax_cli.evaluate_geo_predictions, records,
                              preds_all, GEO_CLASSES)
    _same(run["eval"], want)
    assert "== OVMono3D-GEO ==" in printed and want_printed in printed


def test_cli_eval_only_reproduces_the_table(geo_dataset_run, monkeypatch):
    """`--eval-only` (and `geo.eval_cli`, which adds it) evaluates the
    written pickle without building the models: the same result and
    table."""
    tinyds, out_dir, res, printed = geo_dataset_run
    monkeypatch.setattr(cli, "build_geo_models", None)
    table = printed[printed.index("== OVMono3D-GEO =="):]
    for main, extra in ((cli.main, ["--eval-only"]), (eval_cli.main, [])):
        again, again_printed = _run(main, _dataset_argv(tinyds, out_dir)
                                    + extra)
        _same(again["TinyDS_test"]["eval"], res["TinyDS_test"]["eval"])
        assert again["TinyDS_test"]["stage_ms"] == {}
        assert table in again_printed


def test_cli_max_instances_and_threshold_keep_the_jax_loops_boxes(
        geo_models, geo_dataset_run, tmp_path):
    """The boxes fitted: at or above 0.30, best first, at most
    --max-instances, as tools/ovmono3d_geo.py's loop takes them (copied
    below) on random scores; and through the CLI with --max-instances 1,
    every image's prediction is its best oracle box."""
    rng = np.random.default_rng(3)
    for k in (0, 1, 3, 16):
        dets = [{"bbox2d": rng.random(4).tolist(), "score": float(s),
                 "category_id": i}
                for i, s in enumerate(rng.choice([0.1, 0.29, 0.3, 0.5, 0.9],
                                                 size=12))]
        want = sorted((d for d in dets
                       if d["score"] >= jax_cli.SCORE_THRESHOLD),
                      key=lambda d: -d["score"])[:k]
        assert cli.kept_detections(dets, k) == want
    _, models = geo_models
    tinyds = geo_dataset_run[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build_geo_models",
                   lambda *a, **k: dataclasses.replace(models))
        _run(cli.main, _dataset_argv(tinyds, tmp_path)
             + ["--max-instances", "1"])
    with open(tmp_path / "geo_predictions_TinyDS_test.pkl", "rb") as fh:
        preds_all = pickle.load(fh)
    oracle = json.loads(Path(tinyds["oracle"]).read_text())
    for image_id, preds in preds_all.items():
        assert len(preds) <= 1
        best = max((d for d in oracle if d["image_id"] == image_id),
                   key=lambda d: d["score"])
        for p in preds:
            x, y, w, h = best["bbox"]
            np.testing.assert_allclose(p["bbox2d"], [x, y, x + w, y + h])
