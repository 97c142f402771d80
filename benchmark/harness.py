"""What every cell's run shares: the manifest and the files it names, the
port's Config built from a configuration file, the record of one run, the
reduction of a profiler trace, and the check that no JAX module was loaded.

The harness finds everything by name: a cell's configuration in
`configs/<config>.json`, its traffic in `workloads/<traffic>.json`, the
traffic's driver in `traffic/<driver>.py` and each per-layer metric's reader
in `metrics/<name>.py`. Adding any of them takes new files only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ovmono3d_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX one or the JAX
    package, compared whole (the port's name starts with the JAX
    package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _from_dict(cls, data: dict):
    """A Config dataclass from a plain dict (lists become tuples)."""
    def conv(v, default):
        if dataclasses.is_dataclass(default):
            return _from_dict(type(default), v)
        if isinstance(v, list):
            return tuple(conv(x, None) for x in v)
        return v
    base = cls()
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kw[f.name] = conv(data[f.name], getattr(base, f.name))
    return dataclasses.replace(base, **kw)


def port_config(cfg: dict):
    """The port's Config of a configuration file's model, solver and input
    sections."""
    from ovmono3d_tpu_torch.config import Config
    return _from_dict(Config, {k: cfg[k] for k in ("model", "solver", "input")
                               if k in cfg})


@dataclass
class Run:
    """One run of one cell: its inputs, and what the driver measured."""

    workload: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    started: float = 0.0
    e2e: dict = field(default_factory=dict)       # name -> value
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)    # name -> (value, limit)
    memory_peak_bytes: int = 0
    work: dict = field(default_factory=dict)      # steps / images traced
    traced: dict | None = None                    # reduce_trace's result
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())

    def port(self):
        return port_config(self.cfg)


TRACE_SECONDS = 5.0


def attention_launches(run: Run) -> dict | None:
    """The launch counters of the port's attention wrappers that the
    cell's traffic claims (`launches`: wrapper -> launches a unit of
    work); None off the card, where the wrappers launch nothing."""
    claimed = run.traffic.get("launches")
    if not claimed or run.device != "cuda":
        return None
    from ovmono3d_tpu_torch.ops import attention
    return {n: getattr(attention, n).launches for n in claimed}


class Window:
    """The timed window: units of work (steps, requests) while `seconds`
    have not passed. With tracing, the window's last TRACE_SECONDS run
    under torch.profiler (device activity alone: recording every host op
    as well slowed the host and raised the idle share it reads), started
    after a synchronize and counted from when the profiler is up (starting
    it took seconds on the card), so a traced window may run past
    `seconds`. `traced` then holds reduce_trace's result and
    `traced_units` the units it covers.

    On the card, close() also holds the path to the cell's claim: every
    attention kernel the traffic names has to have launched its count for
    every unit, or `missing_launches` (an exact check, limit 0) fails the
    run.

        window = Window(run, sync)
        while window.next():
            ...one unit...
        window.close()
    """

    def __init__(self, run: Run, sync):
        self.run, self.sync = run, sync
        self.units = 0
        self.t0 = self.prof = None
        self.trace_t0, self.traced_units, self.traced = None, 0, None
        self.launches0 = attention_launches(run)

    def next(self) -> bool:
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        elapsed = now - self.t0
        if self.prof is not None:
            if now - self.trace_t0 >= min(TRACE_SECONDS, self.run.seconds):
                return False
        elif elapsed >= self.run.seconds:
            return False
        elif (self.run.trace
                and elapsed >= self.run.seconds - TRACE_SECONDS):
            from torch.profiler import ProfilerActivity, profile
            self.sync()
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.run.device == "cuda"
                else ProfilerActivity.CPU])
            self.prof.__enter__()
            self.trace_t0, self.traced_from = time.perf_counter(), self.units
        self.units += 1
        return True

    def close(self) -> float:
        """Synchronize; returns the window's seconds."""
        self.sync()
        end = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.traced_units = self.units - self.traced_from
            self.traced = reduce_trace(trace_events(self.prof),
                                       end - self.trace_t0)
            self.prof = None
        if self.launches0 is not None:
            now = attention_launches(self.run)
            claimed = self.run.traffic["launches"]
            self.run.checks["missing_launches"] = (sum(
                max(0, claimed[n] * self.units - (now[n] - self.launches0[n]))
                for n in claimed), 0)
        return end - self.t0


def trace_events(prof) -> list[tuple]:
    """(name, on the device, start us, end us) of each event of a stopped
    torch.profiler.profile, read from its raw results: the profiler's own
    event objects and tree took minutes to build for a training window."""
    from torch.autograd import DeviceType
    raw = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
            e.duration_ns()) for e in prof.profiler.kineto_results.events()]
    t0 = min((r[2] for r in raw), default=0)     # exact in integer ns
    return [(n, dev, (s - t0) * 1e-3, (s - t0 + d) * 1e-3)
            for n, dev, s, d in raw]


def short(name: str, n: int = 120) -> str:
    return name.removeprefix("void ")[:n]


def reduce_trace(events: list[tuple], window_s: float) -> dict:
    """Device time by kernel name, the device's busy seconds (the union of
    its operations' intervals), the count of device operations, the ten
    kernels with most device time and the ten longest idle gaps, each
    labelled with the host's CUDA call open across it (none: the host was
    dispatching) and the device operation that ended it."""
    device = sorted((s, t, n) for n, on_device, s, t in events if on_device)
    host = [(s, t, n) for n, on_device, s, t in events if not on_device]
    busy_us, gaps, cur = 0.0, [], None
    for i, (s, t, _) in enumerate(device):
        if cur is None:
            cur = [s, t]
        elif s > cur[1]:
            busy_us += cur[1] - cur[0]
            gaps.append((s - cur[1], cur[1], s, i))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    by_kernel: dict[str, float] = {}
    for s, t, n in device:
        by_kernel[n] = by_kernel.get(n, 0.0) + (t - s) * 1e-6
    gaps.sort(reverse=True)
    labelled = []
    for dur, a, b, i in gaps[:10]:
        mid = 0.5 * (a + b)
        open_calls = [(t - s, n) for s, t, n in host if s <= mid <= t]
        call = min(open_calls)[1] if open_calls else "no CUDA call"
        labelled.append([f"{call} before {short(device[i][2], 80)}",
                         dur * 1e-6])
    return {
        "kernels": by_kernel,
        "device_ops": len(device),
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "top_ops": [[short(k), v] for k, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": labelled,
    }


def kernel_seconds(run: Run, names: tuple[str, ...]) -> float:
    """Device seconds of the traced kernels whose names hold any of
    `names`."""
    if not run.traced:
        return 0.0
    return sum(s for k, s in run.traced["kernels"].items()
               if any(n in k for n in names))
