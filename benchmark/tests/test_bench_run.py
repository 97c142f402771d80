"""run.py's result line and its last look for JAX, on the CPU: the look
for a chip answered as if a card were there, the traffic driver and the
per-layer readers replaced by stubs."""
import importlib
import json
import sys
import types

import pytest
import torch

from benchmark import harness

WORKLOAD = "dinov2-eval-b8"


def fake_driver(run):
    run.e2e.update(setup_s=1.0, infer_img_per_s=100.0, request_ms_p95=50.0)
    run.attempted = 3
    run.work = {"requests": 2, "images": 16}
    run.traced = {"busy_s": 0.5, "window_s": 1.0, "top_ops": [["k", 0.5]],
                  "idle_gaps": [["no CUDA call before k", 0.1]],
                  "kernels": {"k": 0.5}, "device_ops": 1}
    run.checks = {"score_gap": (0.001, 0.009)}


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    """A card as far as run.py looks, and a reader that imports `jax`
    from a stub module on the path, when a test plants it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    # run.py sets the caches' and libraries' variables when imported.
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX",
                "USE_JAX"):
        monkeypatch.setenv(var, "")
    importlib.import_module("benchmark.run")
    (tmp_path / "jax.py").write_text("LOADED = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    saved = sys.modules.pop("jax", None)
    planted = set()
    load = harness.load_module

    def load_module(kind, name):
        if kind == "traffic":
            return types.SimpleNamespace(run=fake_driver)
        if kind == "metrics" and name in planted:
            def read(run):
                import jax  # noqa: F401
                return 1.0
            return types.SimpleNamespace(read=read)
        return load(kind, name)
    monkeypatch.setattr(harness, "load_module", load_module)
    yield planted
    sys.modules.pop("jax", None)
    if saved is not None:
        sys.modules["jax"] = saved


def main(trace):
    importlib.import_module("benchmark.run").main(["--workload", WORKLOAD, "--seed", str(2**31 + 9),
                    "--seconds", "1", "--trace", str(trace)])


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_ends_with_the_checks(stubbed, capsys, trace):
    main(trace)
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"score_gap": {"value": 0.001,
                                              "limit": 0.009}}
    assert result["correct"] is True
    assert err.strip().splitlines()[-1] == \
        "check score_gap = 0.001 (limit 0.009)"
    if trace:
        assert result["device"]["busy_s"] == 0.5
        assert "launches.infer" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"setup_s", "infer_img_per_s",
                                          "request_ms_p95"}


def test_a_reader_that_loads_jax_fails_the_run(stubbed, capsys):
    """A reader is loaded after the window: the look for JAX comes after
    every reader, so what one loads still stops the result."""
    stubbed.add("idle.infer")
    with pytest.raises(SystemExit) as stop:
        main(1)
    assert stop.value.code == 3
    out, err = capsys.readouterr()
    assert out.strip() == ""
    assert "jax" in err
