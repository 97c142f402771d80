"""The port's GEO pipeline against the JAX package: the box fit and its
density filter, the synthetic scene and self-check, and one image through
`predict_image` at tiny models against the same composition of JAX modules
(CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.geo import pipeline as jgeo
from ovmono3d_tpu.models.depth import DepthPro as JaxDepthPro
from ovmono3d_tpu.models.depth import metric_depth as jax_metric_depth
from ovmono3d_tpu.models.sam import SamSegmenter as JaxSamSegmenter
from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
from ovmono3d_tpu_torch.geo import cli
from ovmono3d_tpu_torch.geo import pipeline as tgeo
from ovmono3d_tpu_torch.models.depth import DepthPro
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from test_geo import _render_box_depth
from test_torch_depth import TINY, depth_params
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


@pytest.mark.parametrize("argv", [["--config-file", "x.yaml"], ["--eval"],
                                  ["--eval-only"]])
def test_cli_dataset_flags_raise(argv):
    with pytest.raises(NotImplementedError, match="queue 1 items 3-5"):
        cli.main(argv + ["--device", "cpu", "--depth-bf16"])


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
def geo_pair():
    rng = np.random.default_rng(5)
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
    image = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    K = np.array([[60.0, 0, 28.0], [0, 60.0, 20.0], [0, 0, 1]], np.float32)
    dets = [{"bbox2d": b, "score": s, "category_id": i}
            for i, (b, s) in enumerate([
                ([4.0, 3.0, 30.0, 25.0], 0.9), ([10.0, 10.0, 20.0, 20.0], 0.2),
                ([20.0, 5.0, 55.0, 39.0], 0.5), ([0.0, 0.0, 50.0, 36.0], 0.95),
                ([30.0, 12.0, 45.0, 30.0], 0.4)])]
    trace: dict = {}
    got = cli.predict_image(models, image, K, dets, trace=trace)
    want = jax_predict(((sam, p_sam), (seg, p_seg), (dp, p_dp)), image, K,
                       dets)
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
