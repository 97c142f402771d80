"""A short run of each cell on the card: one JSON line, correct, every
end-to-end metric of the cell. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(workload, card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    wanted = {m["name"] for m in harness.manifest()["end_to_end"]
              if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) == wanted
    assert result["device"]["platform"] == "gpu"
