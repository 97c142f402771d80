"""The open-vocabulary demo (ovmono3d_tpu_torch/demo.py) against
tools/demo.py, and the evaluation CLI's --vis-dir panels, on the CPU.

- `demo_image` on the tiny pipeline pair of tests/test_torch_ovmono3d.py
  (bridged weights, GroundingDINO in f32): the detections it keeps are the
  JAX pipeline's (slots, classes, 2D boxes to 1e-4 of their scale), and its
  panel lies within two pixels of tools/demo.py's drawing of the JAX
  detections (`vis/draw.py` scene_panel; painted pixels as in
  tests/test_torch_vis.py, the labels' bands left out; the second pixel is
  the cube model's bf16 trunk, which moves the corners by up to 2e-2 of
  their scale in both packages);
- the demo CLI and tools/demo.py on one folder (the builds patched to the
  tiny pair): the same files written, --labels-file skips, the flags'
  intrinsics, and each panel the per-image function's;
- eval.cli --vis-dir --vis-period: a panel every period, each the JAX
  package's pred_vs_gt_panels of the same GT and predictions within a
  pixel.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_ovmono3d import CATS, _pipelines
from test_torch_vis import _near, _painted

from ovmono3d_tpu.models import ovmono3d as jov
from ovmono3d_tpu.vis import draw as jdraw
from ovmono3d_tpu_torch import demo
from ovmono3d_tpu_torch.data.build import read_png, write_png
from ovmono3d_tpu_torch.models import ovmono3d as tov

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "OVMono3D_dinov2_SFP.yaml")
SIZES = {"a": (96, 112), "b": (100, 140), "c": (112, 112)}


@pytest.fixture(scope="module")
def pair():
    return _pipelines()


def _image(h, w, seed):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)


def _dilated_near(a, b, k: int) -> bool:
    import cv2

    grown = cv2.dilate(b.astype(np.uint8), np.ones((k, k), np.uint8)) > 0
    return bool(np.all(grown[a]))


def _same_panel(got, want, boxes, reach: int = 1) -> None:
    """Two scene panels [H, W + H, 3]: the image part within `reach`
    pixels (labels left out), the bird's-eye view likewise on white."""
    h, w = got.shape[0], got.shape[1] - got.shape[0]
    assert got.shape == want.shape
    keep = np.ones((h, w), bool)
    for x1, y1, _, _ in np.asarray(boxes):
        top = max(int(round(y1)) - 4, 10)
        keep[max(top - 13, 0):top + 3, max(int(round(x1)), 0):
             int(round(x1)) + 160] = False
    k = 2 * reach + 1
    for part, bg, mask in ((np.s_[:, :w], 0, keep), (np.s_[:, w:], 255,
                                                     None)):
        pg, pw = _painted(got[part], bg), _painted(want[part], bg)
        if mask is not None:
            pg, pw = pg & mask, pw & mask
        assert _dilated_near(pg, pw, k) and _dilated_near(pw, pg, k)


@pytest.mark.parametrize("name", ["a", "b"])
def test_demo_image_matches_the_jax_demo(pair, name):
    jp, tp = pair
    image = _image(*SIZES[name], seed=ord(name))
    K = demo.intrinsics(*SIZES[name])
    np.testing.assert_array_equal(K, jov.default_focal_K(*SIZES[name]))
    panel, det, ms = demo.demo_image(tp, image, CATS, K, threshold=0.0)
    want = jp.predict(image, K, CATS)
    np.testing.assert_array_equal(det["valid"], np.asarray(want.valid))
    np.testing.assert_array_equal(det["classes"], np.asarray(want.classes))
    wb = np.asarray(want.boxes)
    np.testing.assert_allclose(det["boxes"], wb, rtol=1e-4,
                               atol=1e-4 * np.abs(wb).max())
    assert det["valid"].sum() >= 2 and set(ms) == {"predict_ms", "draw_ms"}
    jpanel = jdraw.scene_panel(image, want, K, class_names=CATS)
    assert panel.shape == (image.shape[0], image.shape[1] + image.shape[0],
                           3)
    _same_panel(panel, jpanel, det["boxes"][det["valid"]], reach=2)
    # The threshold drops the slots scored below it, and nothing else.
    cut = float(np.median(det["scores"][det["valid"]]))
    _, kept, _ = demo.demo_image(tp, image, CATS, K, threshold=cut)
    np.testing.assert_array_equal(
        kept["valid"], det["valid"] & (det["scores"] >= cut))


def _folder(tmp_path: Path) -> Path:
    folder = tmp_path / "imgs"
    folder.mkdir()
    for name, (h, w) in SIZES.items():
        write_png(folder / f"{name}.png", _image(h, w, seed=ord(name)))
    (folder / "notes.txt").write_text("not an image")
    return folder


def test_demo_cli_writes_what_the_jax_tool_writes(monkeypatch, tmp_path,
                                                  pair):
    from tools import demo as jax_demo

    jp, tp = pair
    monkeypatch.setattr(jov.OVMono3DLift, "build", classmethod(
        lambda cls, cfg, tok, **kw: jp))
    monkeypatch.setattr(tov.OVMono3DLift, "build", classmethod(
        lambda cls, cfg, tok, **kw: tp))
    folder = _folder(tmp_path)
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"a": CATS, "b": [], "c": CATS[:2]}))
    common = ["--input-folder", str(folder), "--labels-file", str(labels),
              "--config-file", CONFIG, "--threshold", "0",
              "--focal-length", "150", "--principal-point", "50", "40"]
    monkeypatch.setattr(sys, "argv", ["demo.py", *common, "--output-dir",
                                      str(tmp_path / "jax")])
    jax_demo.main()
    served = demo.main([*common, "--output-dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    written = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert written == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert written == ["a_3d.png", "c_3d.png"]          # "b": [] skipped
    assert [Path(s["image"]).stem for s in served] == ["a", "c"]
    K = demo.intrinsics(0, 0, 150.0, (50.0, 40.0))
    np.testing.assert_array_equal(K, [[150, 0, 50], [0, 150, 40], [0, 0, 1]])
    for stem, cats in (("a", CATS), ("c", CATS[:2])):
        image = read_png(folder / f"{stem}.png")
        panel, det, _ = demo.demo_image(tp, image, cats, K, 0.0)
        got = read_png(tmp_path / "port" / f"{stem}_3d.png")
        np.testing.assert_array_equal(got, panel)
        want = read_png(tmp_path / "jax" / f"{stem}_3d.png")
        _same_panel(got, want, det["boxes"][det["valid"]], reach=2)


def test_eval_vis_dir_panels_are_the_jax_drawing(tmp_path, monkeypatch):
    from test_torch_config_data import TINY

    from ovmono3d_tpu_torch.eval import cli as tcli

    seen = []
    write = tcli.write_panel

    def spy(path, rec, loader, gt, pred, names):
        seen.append((Path(path).name, rec, gt, pred, names))
        return write(path, rec, loader, gt, pred, names)

    monkeypatch.setattr(tcli, "write_panel", spy)
    vis = tmp_path / "vis"
    tcli.main(["--synthetic", "--device", "cpu", *TINY, "--vis-dir",
               str(vis), "--vis-period", "3"])
    files = sorted(p.name for p in vis.iterdir())
    assert files == sorted(name for name, *_ in seen)
    # Every third image of each dataset, rank 0's.
    assert {f.rsplit("_", 1)[-1] for f in files} >= {"000000.png",
                                                    "000003.png"}
    assert all(f.startswith(("synthetic_a_p0_", "synthetic_b_p0_"))
               for f in files)
    for name, rec, gt, pred, names in seen:
        got = read_png(vis / name)
        white = np.full((rec["height"], rec["width"], 3), 255, np.uint8)
        want = jdraw.pred_vs_gt_panels(white, np.asarray(rec["K"]), gt, pred,
                                       class_names=names)
        h, w = rec["height"], rec["width"]
        assert got.shape == want.shape == (2 * h, 3 * w, 3)
        keep = np.ones(got.shape[:2], bool)
        for dx in (0, w, 2 * w):
            for x1, y1, _, _ in np.concatenate([gt["boxes2d"],
                                                pred["boxes2d"]]):
                top = max(int(round(y1)) - 4, 10)
                keep[max(top - 13, 0):top + 3,
                     max(int(round(x1)) + dx, 0):int(round(x1)) + dx
                     + 160] = False
            keep[:, [dx, dx + w - 1]] = False
        keep[[0, h - 1, h, 2 * h - 1]] = False
        pg, pw = _painted(got, 255) & keep, _painted(want, 255) & keep
        assert pw.sum() > 20
        assert _near(pg, pw) and _near(pw, pg), name
