"""BENCHMARK.json against the contract the benchmark is written to, and
every file it names found by name."""
import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}


def reports(cell: str) -> set[str]:
    return {m["name"] for m in MAN["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # A full check of 24 cells (2 runs and 14 a cell) fits in 43,200 s.
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entry_keys(kind, keys):
    for entry in MAN[kind]:
        assert set(entry) == keys, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_names_and_units(kind):
    names = [m["name"] for m in MAN[kind]]
    assert len(names) == len(set(names))
    for m in MAN[kind]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    if kind == "end_to_end":
        assert "setup_s" in names
        for m in MAN[kind]:
            assert set(m) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
    else:
        for m in MAN[kind]:
            assert set(m) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                    or "mfu" in m["name"]:
                assert m["unit"] == "%"


def test_moves_name_a_metric_each_cell_reports():
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        for cell in m["workloads"]:
            assert cell in CELLS, (m["name"], cell)
            assert m["moves"] in reports(cell), (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in CELLS:
        got = reports(cell)
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(cell in m["workloads"] for m in MAN["per_layer"]), cell


def test_layers_are_one_line_and_shared_names_agree():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers == {"host dispatch", "model step", "attention kernels",
                      "device"}
    perf = (harness.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf


def test_files_found_by_name():
    configs = {c["name"]: c for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = harness.read_json("configs", c["name"])
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in configs
        assert w["chips"] == 1
        traffic = harness.read_json("workloads", w["traffic"])
        driver = harness.BENCH / "traffic" / f"{traffic['driver']}.py"
        assert driver.is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in MAN["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
    used = {w["config"] for w in MAN["workloads"]}
    assert used == set(configs)


def test_claimed_launches_name_the_ports_counters():
    """Each cell's traffic claims the attention kernels its path launches
    (`launches`, a unit of work), by the wrapper that counts them."""
    from ovmono3d_tpu_torch.ops import attention
    for w in MAN["workloads"]:
        claimed = harness.read_json("workloads", w["traffic"])["launches"]
        assert claimed, w["name"]
        for name, count in claimed.items():
            assert isinstance(getattr(attention, name).launches, int), name
            assert isinstance(count, int) and count > 0, (w["name"], name)


def test_configs_keep_published_widths():
    for c in MAN["configs"]:
        assert c["reduced"] == []
        data = harness.read_json("configs", c["name"])
        b = data["model"]["backbone"]
        assert (b["embed_dim"], b["depth"], b["num_heads"]) == (768, 12, 12)
        assert data["trunk"]["embed_dim"] == b["embed_dim"]


def test_paths_hold_only_the_benchmark_and_names_fit():
    for path in harness.BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "ovmono3d_tpu_torch", *harness.FORBIDDEN), (path, name)


def test_import_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "ovmono3d_tpu_torch_x",
                        types.ModuleType("ovmono3d_tpu_torch_x"))
    assert "ovmono3d_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    assert harness.forbidden_modules() == ["jaxlib.fake"]


def test_a_cells_modules_load_no_jax():
    """Every module a run imports, in a fresh process."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness, controls;"
            "import benchmark.run;"
            "[harness.load_module('traffic', t) for t in ('train', 'infer')];"
            "[harness.load_module('metrics', m['name']) for m in "
            "harness.manifest()['per_layer']];"
            "import ovmono3d_tpu_torch.eval.cli, "
            "ovmono3d_tpu_torch.parallel.train_step, "
            "ovmono3d_tpu_torch.train.optim;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_readme_and_run_entry_are_there():
    json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert Path(harness.BENCH / "README.md").is_file()
    assert (harness.ROOT / MAN["command"][1]).is_file()
