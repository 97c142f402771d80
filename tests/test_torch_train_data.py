"""The training half of the port's data pipeline (data/build.py) against the
JAX package's: the repeat factors, the dataset-balance weights and the
subsample equal value for value; `build_train_iterator` with one producer
thread and the JAX iterator with the same seed draw the same records in the
same order and, with no image loader, equal batches; on the tiny Omni3D
fixture with the PNG loader, the same records and images within the
resize tolerance of tests/test_torch_config_data.py (torch's bilinear
against cv2's, 1e-3 of the 0-255 range); with several threads the batches
come in the same order on every run; each process of a data-parallel run
(a seed offset by its rank) draws its own stream.
"""
import itertools

import numpy as np
import pytest
import torch
from fixtures.tiny_omni3d import build_dataset

from ovmono3d_tpu import config as jcfg
from ovmono3d_tpu.data import build as jbuild
from ovmono3d_tpu.data import datasets as jdatasets
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.data import build as tbuild
from ovmono3d_tpu_torch.data import datasets as tdatasets
from ovmono3d_tpu_torch.data.synthetic import synthetic_records
from test_torch_config_data import PIXEL_ATOL, TINY, _load

torch.set_num_threads(2)

BATCHES = 4


def _records(first_id: int = 0):
    """Generated records over 3 sources, some categories rare, one image
    (the 6th) without a kept annotation; ids from `first_id`."""
    recs = synthetic_records(40, 6, seed=3)
    for i, rec in enumerate(recs):
        rec["image_id"] += first_id
        rec["source"] = ("A", "B", "B", "C")[i % 4]
        rec["dataset_id"] = i % 4
        if i % 7 == 0:
            for a in rec["annotations"]:
                a["category_id"] = 5
    for a in recs[5]["annotations"]:
        a["category_id"] = -1
    return recs


def test_repeat_factors_balance_and_subsample_match_jax():
    recs = _records()
    for t in (0.001, 0.1, 0.5):
        np.testing.assert_array_equal(
            tbuild.repeat_factors_from_category_frequency(recs, t),
            jbuild.repeat_factors_from_category_frequency(recs, t))
    for sources in ([r["source"] for r in recs], [0] * 5, [1, 2, 2, 2]):
        np.testing.assert_array_equal(
            tbuild.dataset_balance_weights(sources),
            jbuild.dataset_balance_weights(sources))
    for pct in (1.0, 0.5, 0.13):
        assert tbuild.subsample_records(recs, pct) == \
            jbuild.subsample_records(recs, pct)


def _taken(module, monkeypatch, records):
    """Record the ids of `records` that `module`'s iterators map (a JAX
    iterator's producer never stops, so an earlier test's may still be
    mapping its own records)."""
    seen = []
    real = module.map_example
    ids = {r["image_id"] for r in records}

    def recording(rec, *args, **kwargs):
        if rec["image_id"] in ids:
            seen.append(rec["image_id"])
        return real(rec, *args, **kwargs)

    monkeypatch.setattr(module, "map_example", recording)
    return seen


def _configs(*extra):
    return (tcfg.load_config(None, overrides=[*TINY, *extra]),
            jcfg.load_config(None, overrides=[*TINY, *extra]))


def _assert_batches_equal(got, want, pixel_atol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        if k in ("image", "depth"):         # resized on the host
            np.testing.assert_allclose(got[k], want[k], atol=pixel_atol,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("first_id,extra", [
    (0, []), (1000, ["datasets.balance_datasets=true",
                     "datasets.repeat_threshold=0.1",
                     "input.train_set_percentage=0.6"])],
    ids=["plain", "weighted"])
def test_one_thread_matches_the_jax_iterator(monkeypatch, first_id, extra):
    tc, jc = _configs("input.min_size_train=[80,96,112]",
                      "input.max_size_train=112", *extra)
    recs = _records(first_id)
    seen_t = _taken(tbuild, monkeypatch, recs)
    seen_j = _taken(jbuild, monkeypatch, recs)
    got = list(itertools.islice(
        tbuild.build_train_iterator(tc, recs, 3, seed=7, num_threads=1,
                                    max_gt=6), BATCHES))
    want = list(itertools.islice(
        jbuild.build_train_iterator(jc, recs, 3, seed=7, num_threads=1,
                                    max_gt=6), BATCHES))
    # The JAX producer may have mapped one batch ahead.
    assert seen_t[:3 * BATCHES] == seen_j[:3 * BATCHES]
    assert first_id + 5 not in seen_t        # the empty image is filtered
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


@pytest.fixture(scope="module")
def tinyds(tmp_path_factory):
    return build_dataset(tmp_path_factory.mktemp("tiny_omni3d"))


def test_fixture_with_the_png_loader_matches_jax(tinyds, monkeypatch):
    tc, jc = _configs("input.min_size_train=[32,40,48]",
                      "input.max_size_train=112")
    recs = _load(tdatasets, tc, tinyds, "TinyDS_train")
    assert recs == _load(jdatasets, jc, tinyds, "TinyDS_train")
    loader = tbuild.default_image_loader(str(tinyds["root"]))
    jloader = jbuild.default_image_loader(str(tinyds["root"]))
    seen_t = _taken(tbuild, monkeypatch, recs)
    seen_j = _taken(jbuild, monkeypatch, recs)
    got = list(itertools.islice(tbuild.build_train_iterator(
        tc, recs, 2, loader, max_gt=6, seed=3, num_threads=1), BATCHES))
    want = list(itertools.islice(jbuild.build_train_iterator(
        jc, recs, 2, jloader, max_gt=6, seed=3, num_threads=1), BATCHES))
    assert seen_t[:2 * BATCHES] == seen_j[:2 * BATCHES]
    for g, w in zip(got, want):
        assert np.abs(g["image"]).max() > 0
        _assert_batches_equal(g, w, pixel_atol=PIXEL_ATOL)


def test_threads_give_one_order_and_ranks_their_own_streams():
    tc, _ = _configs()
    recs = _records()

    def ids(seed, threads):
        it = tbuild.build_train_iterator(tc, recs, 4, seed=seed,
                                         num_threads=threads)
        out = [b["gt_boxes"].tobytes() for b in itertools.islice(it, 8)]
        it.close()
        return out

    first = ids(5, 4)
    assert ids(5, 4) == first
    # Thread t makes batches t, t + 4, ...: thread 0's are the one-thread
    # stream's.
    assert first[0::4] == ids(5, 1)[:2]
    assert ids(5 + 1, 4) != first            # rank 1 of a group: seed + 1


def test_producer_errors_reach_the_consumer():
    tc, _ = _configs()

    def broken(rec):
        raise OSError(f"cannot read {rec['file_name']}")

    it = tbuild.build_train_iterator(tc, _records(), 2, image_loader=broken,
                                     num_threads=2)
    with pytest.raises(OSError, match="cannot read"):
        next(it)
    with pytest.raises(ValueError, match="no training record"):
        tbuild.build_train_iterator(tc, [], 2)
