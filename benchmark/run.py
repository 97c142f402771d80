"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic file and traffic driver are found by
name from BENCHMARK.json (harness.py). With --trace 0 the result carries
the cell's end-to-end metrics, with --trace 1 its per-layer metrics, read
by each metric's reader from a profiler trace of the window. Every run
checks the timed path's outputs against the plain reference and prints
each number compared beside its limit, last on standard error and under
the result's last key. Exits non-zero, with no result, without enough CUDA
devices, without the port, or when a JAX module was loaded.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

# Caches live at fixed places inside the checkout (the port builds its
# kernels into build/kernels/ beside its package); no library loads flax.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(harness.ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def fail(code: int, message: str) -> None:
    print(message, file=sys.stderr)
    sys.exit(code)


def select(entries: list, workload: str, reported: set | None = None):
    """The manifest's metrics that this cell reports: those listing it, or
    listing no cells (per-layer ones then follow their end-to-end metric)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        fail(2, f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    cfg = harness.read_json("configs", cell["config"])
    traffic = harness.read_json("workloads", cell["traffic"])
    driver = harness.load_module("traffic", traffic["driver"])

    import torch
    if not torch.cuda.is_available():
        fail(2, "no CUDA device: the benchmark measures the port on the card")
    if torch.cuda.device_count() < cell["chips"]:
        fail(2, f"{cell['chips']} CUDA devices needed, "
                f"{torch.cuda.device_count()} found")

    run = harness.Run(workload=args.workload, cfg=cfg, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), started=STARTED)
    driver.run(run)

    e2e = select(man["end_to_end"], args.workload)
    if args.trace:
        reported = {m["name"] for m in e2e}
        metrics = {}
        for m in select(man["per_layer"], args.workload, reported):
            value = harness.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
                   for m in e2e}

    result = {
        "correct": run.correct, "attempted": run.attempted,
        "failed": run.failed, "metrics": metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": run.memory_peak_bytes},
    }
    if args.trace and run.traced:
        result["device"]["busy_s"] = run.traced["busy_s"]
        result["device"]["window_s"] = run.traced["window_s"]
        result["breakdown"] = {"device_ops": run.traced["top_ops"],
                               "idle_gaps": run.traced["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    # Last before the result: whatever the driver or a reader loaded.
    loaded = harness.forbidden_modules()
    if loaded:
        fail(3, "JAX modules loaded in the benchmark's process: "
                + ", ".join(loaded))
    for note in run.notes:
        print(note, file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
