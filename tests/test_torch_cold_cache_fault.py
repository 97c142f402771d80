"""The port's plain CPU math after JAX work that writes a cold persistent
compilation cache, in fresh processes (marker `slow`: about a minute). An
unconfirmed probe of a fault seen once in a whole-suite run (ROADMAP queue
3), not a reproducer: it has not shown the fault, and it does not run the
xdist `--dist loadfile` sequence of that run. Run it with `-m slow`; the
repo sets no addopts, so leave it out of other runs with `-m 'not slow'`.

Each process sets the 8-device XLA flag and a new, empty cache directory
itself, fills sentinel tensors, runs tests/test_rasterize.py's JAX work,
then one plain SGD step with skip=True (nothing may change: once a NaN
appeared in a 3-element parameter), f32 attention on two torch threads
against float64, and re-reads the sentinels. It also reads, by their
effect, the flush-to-zero, denormals-are-zero and rounding state of torch's
worker threads (large elementwise ops split across them).

    python -m pytest -p no:cacheprovider -m slow \
        tests/test_torch_cold_cache_fault.py
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PROCESSES = 8

SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path[:0] = [sys.argv[1], os.path.join(sys.argv[1], "tests")]
    import numpy as np
    import torch
    bad = []
    sentinels = [torch.tensor([1.0, 2.0, 3.0]) for _ in range(4000)]

    def workers():
        n = 1 << 20
        return [int(((torch.full((n,), 1e-40) * 1.0) == 0).sum()),
                int(((torch.ones(n) + 1.5 * 2.0 ** -24) != 1 + 2.0 ** -23)
                    .sum())]

    state = [workers()]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", sys.argv[2])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    import test_rasterize
    for name in sorted(dir(test_rasterize)):
        if name.startswith("test_"):
            getattr(test_rasterize, name)()
    state.append(workers())
    from ovmono3d_tpu_torch import config
    from ovmono3d_tpu_torch.ops import attention
    from ovmono3d_tpu_torch.train import optim
    for _ in range(100):
        mod = torch.nn.Module()
        mod.a = torch.nn.Parameter(torch.tensor([1.0, -2.0, 0.5]))
        opt = optim.Optimizer(config.SolverConfig(warmup_iters=0), mod)
        opt.step([torch.ones_like(p) for p in opt.params])
        before = [p.detach().clone() for p in opt.params]
        opt.step([torch.full_like(p, float("nan")) for p in opt.params],
                 skip=torch.tensor(True))
        bad += [("skip", p.tolist()) for p, b in zip(opt.params, before)
                if not torch.equal(p, b)]
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    for _ in range(10):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 150, 3, 32))
                                    .astype(np.float32)) for _ in range(3))
        err = (attention.attention_ref(q, k, v).double()
               - attention.attention_ref(q.double(), k.double(), v.double())
               ).abs().max().item()
        if err > 5e-6:
            bad.append(("attention", err))
    bad += [("sentinel", i, s.tolist()) for i, s in enumerate(sentinels)
            if s.tolist() != [1.0, 2.0, 3.0]]
    print(json.dumps({"bad": bad, "workers": state}))
""")


@pytest.mark.slow
def test_plain_math_after_cold_cache_jax_work(tmp_path):
    results = []
    for i in range(PROCESSES):
        cache = tmp_path / f"cache{i}"
        cache.mkdir()
        proc = subprocess.run(
            [sys.executable, "-c", SCRIPT, str(ROOT), str(cache)],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert [r["bad"] for r in results] == [[]] * PROCESSES
    # No worker thread flushes denormals or rounds other than to nearest.
    assert all(w == [0, 0] for r in results for w in r["workers"])
