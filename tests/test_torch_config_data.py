"""The port's configuration files and test data pipeline against the JAX
package: `load_config` on every shipped YAML and on overrides, the copied
modules (category splits, dataset loading and filters, oracle merge, prompt
depth, category meta, priors, generated records), the mapper, the test
iterator and the PNG loader, on the on-disk fixture tests/fixtures/
tiny_omni3d.py and on in-memory records.

Limits: everything but pixels is equal value for value; pixels differ only
by the resize (torch's bilinear F.interpolate against cv2.resize on the same
f32 image: 1e-3 of the 0-255 range, far inside the 0.012 cv2 allows itself
on uint8 input).
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from fixtures.tiny_omni3d import CATEGORY_NAMES, build_dataset

from ovmono3d_tpu import config as jcfg
from ovmono3d_tpu.data import build as jbuild
from ovmono3d_tpu.data import builtin as jbuiltin
from ovmono3d_tpu.data import datasets as jdatasets
from ovmono3d_tpu.data import mapper as jmapper
from ovmono3d_tpu.utils import priors as jpriors
from ovmono3d_tpu.utils.util import imread_rgb
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.data import build as tbuild
from ovmono3d_tpu_torch.data import builtin as tbuiltin
from ovmono3d_tpu_torch.data import datasets as tdatasets
from ovmono3d_tpu_torch.data import mapper as tmapper
from ovmono3d_tpu_torch.data import synthetic as tsynthetic
from ovmono3d_tpu_torch.utils import priors as tpriors

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
PIXEL_ATOL = 1e-3 * 255
# The tiny model and sizes the CLI tests use.
TINY = ["model.num_classes=2", "model.backbone.embed_dim=32",
        "model.backbone.depth=1", "model.backbone.num_heads=2",
        "model.backbone.pretrain_grid=8", "model.backbone.out_channels=32",
        "model.backbone.square_pad=112", "model.roi_box.fc_dim=32",
        "model.cube.fc_dim=32", "input.min_size_test=96",
        "input.max_size_test=112",
        f"datasets.category_names={','.join(CATEGORY_NAMES)}"]


def assert_same(port, ref, path="cfg"):
    """Every field of the port's config equal to the JAX one's."""
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            assert_same(mine, theirs, f"{path}.{f.name}")
        else:
            assert mine == theirs, f"{path}.{f.name}: {mine!r} != {theirs!r}"
            assert type(mine) is type(theirs), f"{path}.{f.name}"


@pytest.fixture(scope="module")
def tinyds(tmp_path_factory):
    return build_dataset(tmp_path_factory.mktemp("tiny_omni3d"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_shipped_configs_load_as_in_jax(path):
    assert_same(tcfg.load_config(path), jcfg.load_config(path))


def test_overrides_and_oracle2d_lookup_as_in_jax(tmp_path):
    yml = tmp_path / "child.yaml"
    (tmp_path / "base.yaml").write_text(
        "model:\n  num_classes: 43\nsolver:\n  base_lr: 0.02\n")
    yml.write_text(
        "_BASE_: base.yaml\nsolver:\n  base_lr: 0.12\n"
        "datasets:\n  train: [Objectron_train, Objectron_val]\n"
        "  oracle2d_files:\n    target_aware:\n"
        "      base: {Objectron_test: a.json}\n      novel: {KITTI_test: b.json}\n"
        "    previous_metric:\n      base: {Objectron_test: c.json}\n")
    cases = [
        [],
        ["model.num_classes=50", "model.cube.z_type=log",
         "input.min_size_train=96", "model.anchors.sizes=[[32],[64]]",
         "test.oracle2d=false", "datasets.oracle2d_eval_mode=previous_metric",
         "datasets.oracle2d_files.target_aware.base.SUNRGBD_test=x.json",
         "model.backbone.scale_factors=(4.0,2.0)", "solver.steps=[5, 7]"],
        ["datasets.oracle2d_files.Objectron_test=y.json"],
    ]
    for overrides in cases:
        port = tcfg.load_config(yml, overrides=overrides)
        ref = jcfg.load_config(yml, overrides=overrides)
        assert_same(port, ref)
        for ds in ("Objectron_test", "KITTI_test", "SUNRGBD_test"):
            for mode in ("base", "novel", "all"):
                assert tcfg.oracle2d_file(port.datasets, ds, mode) == \
                    jcfg.oracle2d_file(ref.datasets, ds, mode)
    flat = tcfg.load_config(None, overrides=cases[2])
    assert tcfg.oracle2d_file(flat.datasets, "Objectron_test", "base") \
        == "y.json"


def test_unknown_key_and_trunks_the_port_lacks():
    with pytest.raises(KeyError, match="unknown config key"):
        tcfg.load_config(None, overrides=["model.backbone.attention=xla"])
    from ovmono3d_tpu_torch.models.rcnn3d import build_model

    # Every shipped config builds: the SAM one (once refused) on meta, at
    # its full width.
    cfg = tcfg.load_config(REPO / "configs" / "OVMono3D_sam_SFP.yaml")
    model = build_model(cfg.model, device="meta")
    assert model.backbone.vit.neck_channels == 256
    assert len(model.backbone.vit.blocks()) == 12


def test_builtin_categories_are_a_copy():
    for name in jbuiltin._CATEGORY_SETS:
        assert tbuiltin.get_omni3d_categories(name) == \
            jbuiltin.get_omni3d_categories(name)
    for name in ("Objectron_test", "KITTI_test_novel", "omni3d_in"):
        assert tbuiltin.get_omni3d_categories(name) == \
            jbuiltin.get_omni3d_categories(name)


def _load(mod, cfg, tinyds, split="TinyDS_test"):
    fs = dataclasses.replace(mod.filter_settings_from_cfg(cfg),
                             visibility_thres=cfg.test.visibility_thres,
                             truncation_thres=cfg.test.truncation_thres)
    cat_map = {n: i for i, n in enumerate(cfg.datasets.category_names)}
    path = tinyds["root"] / "Omni3D" / f"{split}.json"
    mod.simple_register(split, path, fs, cat_map)
    recs = mod.get_dataset(split)
    recs = mod.merge_oracle2d(recs, tinyds["oracle"]) \
        if split == "TinyDS_test" else recs
    mod.attach_depth_files(recs, tinyds["root"] / "depth")
    return recs


def _configs(*extra):
    return (tcfg.load_config(None, overrides=[*TINY, *extra]),
            jcfg.load_config(None, overrides=[*TINY, *extra]))


@pytest.mark.parametrize("split", ["TinyDS_test", "TinyDS_train"])
def test_dataset_loading_is_a_copy(tinyds, split):
    tc, jc = _configs()
    port, ref = _load(tdatasets, tc, tinyds, split), \
        _load(jdatasets, jc, tinyds, split)
    assert len(port) == len(ref) > 0
    assert json.dumps(port, sort_keys=True, default=str) == \
        json.dumps(ref, sort_keys=True, default=str)
    assert any(a["category_id"] == -1 for r in port
               for a in r["annotations"]) or split == "TinyDS_test"
    meta = REPO / "configs" / "category_meta50.json"
    assert tdatasets.load_category_meta(meta) == \
        jdatasets.load_category_meta(meta)


def test_png_loader_reads_the_fixture(tinyds):
    files = sorted((tinyds["root"] / "TinyDS" / "images").glob("*.png"))
    assert files
    for f in files:
        np.testing.assert_array_equal(tbuild.read_png(f), imread_rgb(f))
    loader = tbuild.default_image_loader(str(tinyds["root"]))
    assert loader({"file_name": "TinyDS/images/missing.png"}) is None


def test_png_loader_refuses_other_formats(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    with pytest.raises(ValueError, match="JPEG"):
        tbuild.read_png(tmp_path / "a.jpg")
    cv2.imwrite(str(tmp_path / "b.png"), np.zeros((4, 5), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        tbuild.read_png(tmp_path / "b.png")
    cv2.imwrite(str(tmp_path / "c.png"), np.arange(20, dtype=np.uint8)
                .reshape(4, 5))
    np.testing.assert_array_equal(
        tbuild.read_png(tmp_path / "c.png"),
        np.repeat(np.arange(20, dtype=np.uint8).reshape(4, 5, 1), 3, -1))


def _compare_examples(got, want):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("image", "depth") and w is not None:
            assert g.shape == w.shape and g.dtype == w.dtype, f.name
            np.testing.assert_allclose(g, w, atol=PIXEL_ATOL, rtol=0,
                                       err_msg=f.name)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
            assert g.dtype == w.dtype, f.name
        else:
            assert g == w, f.name


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
def test_mapper_matches_jax_on_the_fixture(tinyds, is_train):
    tc, jc = _configs("input.min_size_train=[80,96,112]",
                      "input.max_size_train=112")
    recs = _load(jdatasets, jc, tinyds,
                 "TinyDS_train" if is_train else "TinyDS_test")
    loader = tbuild.default_image_loader(str(tinyds["root"]))
    for i, rec in enumerate(recs):
        image = loader(rec)
        kw = dict(is_train=is_train, max_gt=6, max_oracle=5)
        got = tmapper.map_example(
            rec, tc, image=image, rng=np.random.RandomState(i), **kw)
        want = jmapper.map_example(
            rec, jc, image=image, rng=np.random.RandomState(i), **kw)
        _compare_examples(got, want)


def test_mapper_matches_jax_on_in_memory_records():
    """A 640x480 record of the JAX data tests' kind with a synthetic image
    and an in-memory prompt depth, at the default 896 canvas."""
    rng = np.random.default_rng(0)
    rec = tsynthetic.synthetic_records(1, 5, seed=3)[0]
    rec["depth"] = rng.random((480, 640)).astype(np.float32) * 5
    image = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
    tc, jc = tcfg.Config(), jcfg.Config()
    for is_train in (False, True):
        got = tmapper.map_example(rec, tc, image=image, is_train=is_train,
                                  rng=np.random.RandomState(1))
        want = jmapper.map_example(rec, jc, image=image, is_train=is_train,
                                   rng=np.random.RandomState(1))
        _compare_examples(got, want)
    batch = tmapper.batch_examples([got, got])
    assert batch["depth"].shape == (2, 896, 896, 1)


def test_test_iterator_matches_jax(tinyds):
    tc, jc = _configs()
    recs = _load(jdatasets, jc, tinyds)
    loader = tbuild.default_image_loader(str(tinyds["root"]))
    got = list(tbuild.build_test_iterator(tc, recs, 3, loader, max_oracle=7))
    want = list(jbuild.build_test_iterator(jc, recs, 3, loader, max_oracle=7,
                                           use_native=False))
    assert len(got) == len(want) == 2
    for (gc, gb), (wc, wb) in zip(got, want):
        assert [r["image_id"] for r in gc] == [r["image_id"] for r in wc]
        assert sorted(gb) == sorted(wb)
        assert "oracle_boxes" in gb and "depth" not in gb   # half lack depth
        for k in wb:
            if k == "image":
                np.testing.assert_allclose(gb[k], wb[k], atol=PIXEL_ATOL)
            else:
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_priors_and_synthetic_records_are_copies():
    spec = importlib.util.spec_from_file_location(
        "train_net", REPO / "tools" / "train_net.py")
    train_net = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_net)
    for seed in (0, 7, 11):
        assert tsynthetic.synthetic_records(16, 5, seed) == \
            train_net.synthetic_records(16, 5, seed)
    recs = train_net.synthetic_records(64, 4, seed=2)
    kw = dict(virtual_depth=True, virtual_focal=512.0, test_min=532,
              test_max=896, anchor_min=64.0, anchor_max=512.0)
    for bins in (1, 3):
        got = tpriors.compute_priors(recs, 4, bins, **kw)
        want = jpriors.compute_priors(recs, 4, bins, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for hw in ((480, 640), (375, 1242)):
        assert tpriors.approx_eval_resolution(*hw, 532, 896) == \
            jpriors.approx_eval_resolution(*hw, 532, 896)


def test_synthetic_datasets_as_the_jax_cli_builds_them():
    data, novel = tsynthetic.synthetic_datasets(6, [str(i) for i in range(6)])
    assert list(data) == ["synthetic_a", "synthetic_b"]
    assert novel == {"0", "1", "2"}
    for name, seed in tsynthetic.SYNTHETIC_DATASETS:
        recs = data[name]
        assert recs[0]["annotations"] == \
            tsynthetic.synthetic_records(16, 6, seed)[0]["annotations"]
        for rec in recs:
            assert [o["bbox2d"] for o in rec["oracle2d"]] == \
                [a["bbox2d"] for a in rec["annotations"]]
    data, _ = tsynthetic.synthetic_datasets(6, ["a"] * 6, oracle=False)
    assert all("oracle2d" not in r for r in data["synthetic_a"])
