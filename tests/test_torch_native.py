"""The port's native batch resize (data/native.py, its copy of
native/preproc.cc built with g++ into build/native/): against the JAX
package's library on the images of tests/test_native_preproc.py and
against the port's per-image torch resize through `build_test_iterator`:
equal geometry, pixels within 2e-2 (the same half-pixel bilinear filter in
f32, computed in another order: the JAX Makefile's -march=native contracts
the source coordinate's arithmetic into FMAs, which moves it by an ulp,
~6e-5 at 500 pixels, times a 255-level step); one OpenMP runtime in a
fresh process with PyTorch, the 4-core gate, and a failed build that
raises where the native route was taken.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ovmono3d_tpu.data.native import preprocess_batch_native as jax_native
from ovmono3d_tpu_torch.config import load_config
from ovmono3d_tpu_torch.data import build as tbuild
from ovmono3d_tpu_torch.data import native

torch.set_num_threads(2)

ATOL = 2e-2


def _images(seed: int, shapes) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in shapes]


CASES = {
    "geometry": (_images(0, [(480, 640), (300, 400)]), 896, 532, 896),
    "pixels": (_images(1, [(240, 320)]), 896, 532, 896),
    "identity": (_images(2, [(100, 100)]), 128, 100, 128),
    "large_batch": (_images(3, [(200 + 19 * i, 480 - 17 * i)
                                for i in range(16)]), 896, 532, 896),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_the_jax_library(case):
    images, s, short, mx = CASES[case]
    got = native.preprocess_batch_native(images, s, short, mx)
    want = jax_native(images, s, short, mx)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    for i, (h, w) in enumerate(got[1]):
        assert not got[0][i, h:].any() and not got[0][i, :, w:].any()
    if case == "identity":
        np.testing.assert_array_equal(got[0][0, :100, :100], images[0])


GOMP = """
maps = open("/proc/self/maps").read()
print(sorted({line.split()[-1] for line in maps.splitlines()
              if "libgomp" in line}))
"""
LOAD = "from ovmono3d_tpu_torch.data import native\nnative.load()\n"
TORCH = "import torch\ntorch.ones(1)\n"


def test_library_is_the_ports_own_build():
    import ast
    import subprocess
    import sys

    lib = native.load()
    path = native.library_path()
    assert lib._name == str(path) and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    # One OpenMP runtime in a fresh process, whichever of PyTorch and the
    # library loads first: the library's libgomp.so.1 is the one already
    # loaded (one SONAME).
    for code in (TORCH + LOAD + GOMP, LOAD + TORCH + GOMP):
        out = subprocess.run([sys.executable, "-c", code],
                             cwd=native.SOURCE.parents[2], capture_output=True,
                             text=True, timeout=120, check=True).stdout
        assert len(ast.literal_eval(out)) == 1, out


def test_refuses_images_that_are_not_rgb():
    with pytest.raises(ValueError, match="HWC RGB"):
        native.preprocess_batch_native([np.zeros((8, 8), np.uint8)], 16, 8,
                                       16)


def _records(tmp_path, n=3):
    """n PNG images of different sizes on disk, as test records."""
    recs = []
    for i, img in enumerate(_images(4, [(120 + 10 * i, 160 - 8 * i)
                                        for i in range(n)])):
        tbuild.write_png(tmp_path / f"{i}.png", img)
        recs.append({"file_name": f"{i}.png", "height": img.shape[0],
                     "width": img.shape[1], "image_id": i,
                     "K": [[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]]})
    return recs


def _cfg():
    cfg = load_config(None, overrides=["model.backbone.square_pad=112"])
    return dataclasses.replace(cfg, input=dataclasses.replace(
        cfg.input, min_size_test=96, max_size_test=112))


def test_iterator_native_route_matches_the_torch_resize(tmp_path,
                                                        monkeypatch):
    recs, cfg = _records(tmp_path), _cfg()
    loader = tbuild.default_image_loader(str(tmp_path))
    calls = []
    real = native.preprocess_batch_native
    monkeypatch.setattr(native, "preprocess_batch_native",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(native.os, "cpu_count", lambda: 8)
    fast = list(tbuild.build_test_iterator(cfg, recs, 2, loader))
    assert len(calls) == 2
    slow = list(tbuild.build_test_iterator(cfg, recs, 2, loader,
                                           use_native=False))
    assert len(calls) == 2
    for (c1, b1), (c2, b2) in zip(fast, slow):
        assert c1 == c2 and b1.keys() == b2.keys()
        for k in b1:
            if k == "image":
                np.testing.assert_allclose(b1[k], b2[k], rtol=0, atol=ATOL)
            elif k == "im_scale_ratio":      # 1 / s in f32 in C, f64 here
                np.testing.assert_allclose(b1[k], b2[k], rtol=1e-6)
            else:
                np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)
    # Fewer than 4 cores: the per-image path, no native call.
    monkeypatch.setattr(native.os, "cpu_count", lambda: 2)
    list(tbuild.build_test_iterator(cfg, recs, 2, loader))
    assert len(calls) == 2


def test_a_failed_build_raises_on_the_native_route(tmp_path, monkeypatch):
    broken = tmp_path / "preproc.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native.os, "cpu_count", lambda: 8)
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            native.build()
        imgs = tmp_path / "imgs"
        imgs.mkdir()
        it = tbuild.build_test_iterator(
            _cfg(), _records(imgs), 2,
            tbuild.default_image_loader(str(imgs)))
        with pytest.raises(RuntimeError, match="build failed"):
            next(it)
    finally:
        native.load.cache_clear()
