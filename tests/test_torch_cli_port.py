"""The port's dataset CLIs against the JAX tools on the CPU: the offline
evaluator `eval.predictions` (tools/eval_predictions.py) and the oracle-2D
generator `eval.oracle2d` (tools/generate_oracle2d.py), as tests/test_cli.py
:224-330 drives the JAX ones, and both on the tiny Omni3D fixture
(tests/fixtures/tiny_omni3d.py). Printed AP tables are compared as text (the
port's vis/logperf.py is a copy of the JAX one); detections to 1e-4
(GroundingDINO in f32 in both packages, the same weights)."""
import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from fixtures.tiny_omni3d import build_dataset
from test_torch_config_data import TINY
from test_torch_stream import gdino_pair  # noqa: F401 (a fixture)

from ovmono3d_tpu.models import ovmono3d as jov
from ovmono3d_tpu_torch.data.datasets import merge_oracle2d
from ovmono3d_tpu_torch.data.synthetic import synthetic_records
from ovmono3d_tpu_torch.eval import cli as eval_cli
from ovmono3d_tpu_torch.eval import oracle2d, predictions
from ovmono3d_tpu_torch.models import ovmono3d as tov
from tools import eval_predictions as jax_eval_predictions
from tools import generate_oracle2d as jax_oracle2d

torch.set_num_threads(2)

REPO_CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
                  / "OVMono3D_dinov2_SFP.yaml")


@pytest.fixture(scope="module")
def tinyds(tmp_path_factory):
    return build_dataset(tmp_path_factory.mktemp("tiny_omni3d"))


def _printed(fn, *args):
    """fn(*args) and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def _jax_tool(monkeypatch, module, argv):
    """A JAX tool's main() on `argv`, and what it printed."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    return _printed(module.main)


# -- eval.predictions -------------------------------------------------------

def _one_chair(tmp_path):
    """tests/test_cli.py's one-image dataset and its GT-equal prediction."""
    data = {
        "categories": [{"id": 1, "name": "chair"}],
        "images": [{"id": 10, "width": 640, "height": 480,
                    "K": [[500, 0, 320], [0, 500, 240], [0, 0, 1]],
                    "file_path": "img10.jpg"}],
        "annotations": [{"image_id": 10, "category_id": 1,
                         "bbox2D_trunc": [100, 100, 150, 180],
                         "center_cam": [0.1, 0.2, 3.0],
                         "dimensions": [0.5, 0.9, 0.5],
                         "R_cam": np.eye(3).tolist(), "truncation": 0.1,
                         "visibility": 0.9, "valid3D": True}],
    }
    ds = tmp_path / "ds.json"
    ds.write_text(json.dumps(data))
    preds = [{"image_id": 10, "instances": [{
        "category_id": 0, "score": 0.9, "bbox": [100, 100, 50, 80],
        "center_cam": [0.1, 0.2, 3.0], "dimensions": [0.5, 0.9, 0.5],
        "pose": np.eye(3).tolist()}]}]
    return ds, preds


@pytest.mark.parametrize("which", ["gt", "empty"])
def test_eval_predictions_offline(monkeypatch, tmp_path, which):
    """A GT-equal prediction scores AP 100; an empty file scores 0, not a
    skipped image (the dataset drives the loop). Both print the JAX tool's
    tables."""
    ds, preds = _one_chair(tmp_path)
    pf = tmp_path / "preds.json"
    pf.write_text(json.dumps(preds if which == "gt" else []))
    argv = ["--predictions", str(pf), "--dataset-json", str(ds),
            "--categories", "chair"]
    summary, out = _printed(predictions.main, argv + ["--device", "cpu"])
    _, want = _jax_tool(monkeypatch, jax_eval_predictions, argv)
    assert "offline predictions" in out and out == want
    if which == "gt":
        assert summary["overall"]["AP3D"] == pytest.approx(100.0)
        assert "100.00" in out
    else:
        assert summary["overall"]["AP3D"] == 0.0 and "100.0" not in out


def test_eval_predictions_reproduces_eval_cli(monkeypatch, tmp_path, tinyds):
    """The tiny model over the fixture's test split through `eval.cli
    --dump-predictions`; the dump through `eval.predictions` gives the same
    AP2D and AP3D as `eval.cli` itself, and the JAX tool's tables on the
    same file."""
    dump = tmp_path / "preds"
    summary = eval_cli.main([
        "--config-file", REPO_CONFIG, "--device", "cpu", "--batch-size", "4",
        "--dump-predictions", str(dump), *TINY,
        f"datasets.data_root={tinyds['root']}",
        "datasets.test_base=TinyDS_test", "test.cat_mode=base",
        "test.oracle2d=true",
        "datasets.oracle2d_files.target_aware.base.TinyDS_test="
        f"{tinyds['oracle']}"])
    want = summary["datasets"]["TinyDS_test"]
    argv = ["--predictions", str(tmp_path / "preds_TinyDS_test.json"),
            "--dataset-json",
            str(tinyds["root"] / "Omni3D" / "TinyDS_test.json"),
            "--categories", "chair,cup"]
    got, out = _printed(predictions.main, argv + ["--device", "cpu"])
    for key in ("AP2D", "AP3D"):
        assert got["overall"][key] == pytest.approx(want[key], abs=1e-9)
    assert want["AP2D"] == pytest.approx(100.0)
    _, jax_out = _jax_tool(monkeypatch, jax_eval_predictions, argv)
    assert out == jax_out


# -- eval.oracle2d ----------------------------------------------------------

def _tiny_detectors(monkeypatch, pair):
    """Both packages' `build_2d_only` give the tiny f32 GroundingDINO with
    the pair's weights on a 64^2 canvas."""
    jmodel, params, port, _, _ = pair
    monkeypatch.setattr(jov.OVMono3DLift, "build_2d_only", classmethod(
        lambda cls, tok, **kw: cls(None, None, None, jmodel, params, tok,
                                   gdino_size=64)))
    monkeypatch.setattr(tov.OVMono3DLift, "build_2d_only", classmethod(
        lambda cls, tok, device=None, **kw: cls(None, None, port, tok,
                                                gdino_size=64)))


def test_generate_oracle2d_cli(monkeypatch, tmp_path, gdino_pair):
    """--synthetic writes per-dataset detection JSONs in the schema
    `merge_oracle2d` reads, and they round-trip through it."""
    _tiny_detectors(monkeypatch, gdino_pair)
    out_dir = tmp_path / "oracle2d"
    paths, printed = _printed(oracle2d.main, [
        "--synthetic", "--device", "cpu", "--output-dir", str(out_dir),
        "--topk", "8", "model.num_classes=9"])
    assert sorted(p.name for p in out_dir.glob("*.json")) == [
        "synthetic_a_base.json", "synthetic_b_base.json"]
    assert ("datasets.oracle2d_files.target_aware.base.synthetic_a="
            f"{paths['synthetic_a']}") in printed
    dets = json.loads(paths["synthetic_a"].read_text())
    assert dets
    for d in dets:
        assert set(d) == {"image_id", "bbox2d", "category_id", "score"}
        assert 0 <= d["category_id"] < 9 and len(d["bbox2d"]) == 4
    assert max(sum(d["image_id"] == i for d in dets) for i in range(4)) <= 8
    recs = merge_oracle2d(synthetic_records(4, 9, seed=7),
                          paths["synthetic_a"])
    assert sum(len(r["oracle2d"]) for r in recs) == len(dets)


@pytest.mark.parametrize("mode", ["base", "novel", "previous_metric"])
def test_oracle2d_on_the_fixture_matches_jax_tool(monkeypatch, tmp_path,
                                                  tinyds, gdino_pair, mode):
    """Both tools over the fixture's test split with the same weights (its
    64x48 images sit on the 64^2 canvas at scale 1): the same prompts and
    the same detections, boxes and scores to 1e-4. 'novel' prompts with
    the dataset's novel split, which TinyDS has not (so its own
    categories); previous_metric with every configured category."""
    _tiny_detectors(monkeypatch, gdino_pair)
    cat_mode = "base" if mode == "previous_metric" else mode
    eval_mode = ("previous_metric" if mode == "previous_metric"
                 else "target_aware")
    overrides = [f"datasets.data_root={tinyds['root']}",
                 f"datasets.test_{cat_mode}=TinyDS_test",
                 f"test.cat_mode={cat_mode}",
                 f"datasets.oracle2d_eval_mode={eval_mode}",
                 "datasets.category_names=chair,cup,bicycle"]
    got = oracle2d.main(["--device", "cpu", "--output-dir",
                         str(tmp_path / "port"), *overrides])
    _jax_tool(monkeypatch, jax_oracle2d,
              ["--output-dir", str(tmp_path / "jax"), *overrides])
    name = f"TinyDS_test_{cat_mode}.json"
    assert got["TinyDS_test"].name == name
    mine = json.loads(got["TinyDS_test"].read_text())
    theirs = json.loads((tmp_path / "jax" / name).read_text())
    assert len(mine) == len(theirs) > 0
    assert {d["category_id"] for d in mine} <= (
        {0, 1, 2} if mode == "previous_metric" else {0, 1})
    for g, w in zip(mine, theirs):
        assert (g["image_id"], g["category_id"]) == \
            (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox2d"], w["bbox2d"], atol=1e-4)
        assert g["score"] == pytest.approx(w["score"], abs=1e-4)


@pytest.mark.parametrize("flag", ["--gdino-ckpt", "--vocab"])
def test_oracle2d_loads_what_the_jax_tool_loads(monkeypatch, tmp_path, tinyds,
                                                gdino_pair, flag):
    """--gdino-ckpt (a GroundingDINO file in the original repo's layout,
    wrapped as {'model': ...} with 'module.' prefixes) and --vocab (a BERT
    vocab.txt) in both tools (tools/generate_oracle2d.py:169-190): the same
    detections over the fixture (1e-4); the port's detector holds the
    file's weights bit for bit, its tokenizer the file's vocabulary."""
    import copy

    from test_torch_gdino import GDINO_KWARGS

    from ovmono3d_tpu_torch.utils import flax_bridge, release_states
    from ovmono3d_tpu_torch.utils.gdino_convert import convert_groundingdino

    jmodel, params, port, _, _ = gdino_pair
    port = copy.deepcopy(port)
    toks = []
    monkeypatch.setattr(jov.OVMono3DLift, "build_2d_only", classmethod(
        lambda cls, tok, **kw: cls(None, None, None, jmodel, params, tok,
                                   gdino_size=64)))
    monkeypatch.setattr(tov.OVMono3DLift, "build_2d_only", classmethod(
        lambda cls, tok, device=None, **kw: toks.append(tok) or cls(
            None, None, port, tok, gdino_size=64)))
    if flag == "--gdino-ckpt":
        state = release_states.gdino_state(seed=3, **GDINO_KWARGS)
        path = tmp_path / "groundingdino_swinb_cogcoor.pth"
        torch.save({"model": {"module." + k: torch.from_numpy(v)
                              for k, v in state.items()}}, path)
    else:
        words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", "?", "cup",
                 "bicycle", "chair", "##s"]
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(words) + "\n")
    overrides = [f"datasets.data_root={tinyds['root']}",
                 "datasets.test_base=TinyDS_test", "test.cat_mode=base",
                 "datasets.category_names=chair,cup,bicycle"]
    got = oracle2d.main(["--device", "cpu", "--output-dir",
                         str(tmp_path / "port"), flag, str(path),
                         *overrides])
    _jax_tool(monkeypatch, jax_oracle2d, ["--output-dir",
                                          str(tmp_path / "jax"), flag,
                                          str(path), *overrides])
    mine = json.loads(got["TinyDS_test"].read_text())
    theirs = json.loads((tmp_path / "jax" / got["TinyDS_test"].name)
                        .read_text())
    assert len(mine) == len(theirs) > 0
    for g, w in zip(mine, theirs):
        assert (g["image_id"], g["category_id"]) == \
            (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox2d"], w["bbox2d"], atol=1e-4)
        assert g["score"] == pytest.approx(w["score"], abs=1e-4)
    if flag == "--vocab":
        assert toks[0].vocab == {w: i for i, w in enumerate(words)}
        return
    tree = convert_groundingdino(state)
    ref = dict(port.named_parameters())
    for name, arr in flax_bridge.torch_arrays(port, tree).items():
        np.testing.assert_array_equal(ref[name].detach().numpy(), arr)


def test_category_tokenizer_matches_jax_tools_vocab():
    """Without --vocab both tools tokenize with the category words."""
    names = ["chair", "cereal box", "Traffic Cone", "cup"]
    tok = oracle2d.category_tokenizer(names)
    assert tok.vocab == {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
                         ".": 4, "box": 5, "cereal": 6, "chair": 7, "cone": 8,
                         "cup": 9, "traffic": 10}


def test_write_png_reads_back_with_cv2_and_read_png(tmp_path):
    """The port's PNG writer (the card's smoke writes the fixture's images
    with it): cv2 and `read_png` read the same pixels back."""
    import cv2

    from ovmono3d_tpu_torch.data.build import read_png, write_png

    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    write_png(tmp_path / "a.png", rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_COLOR)[..., ::-1], rgb)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), rgb)
