"""Fixed-shape work captured once as CUDA graphs cut at the port's spans,
then replayed with the spans it opened.

    graphs = SpanGraphs()
    out = graphs.capture(fn, capture_stream(device))  # captured, not run
    graphs.replay()                                  # runs it; `out` holds
    ...                                              # the results, every time

`capture` runs `fn` with its CUDA work captured, not run. Each span that
`fn` opens or closes (`utils.trace.span`) ends the current graph, a segment,
and starts the next, so the capture yields a plan: segments, and between
them the spans opened and closed. All segments share one memory pool and
replay in capture order. `replay` walks the plan on the current stream:
replay a segment, open a span, replay, close it, and so on. While spans
record (a profiler or `trace.recording()`), the replayed work thus records
the spans an eager run records, by name, nesting and unit, with their
timing events on the stream between segments; no event is recorded inside
a graph. A segment that captured nothing is dropped.

The kernel wrappers' launch counters (`<wrapper>.launches` in
ops/attention.py, ops/quant.py, ops/optim_kernels.py, ops/attn_sweep.py)
count kernels that ran: `capture` leaves each as it was, and each `replay`
adds what the capture counted.

`fn` must not wait for the card or copy from the host's pageable memory;
what it allocates comes from the pool and is overwritten by the next
replay, and the tensors it reads must stay where they are. Caches that
`fn` fills on first use should be filled before the capture, by an eager
run of the same shapes. The graphs, and the pool with them, go when the
object does.
"""
from __future__ import annotations

import contextlib
import functools
import warnings

import torch
import torch.nn.functional as F

from ovmono3d_tpu_torch.utils import trace

_EMPTY = "CUDA Graph is empty"
_streams: dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of `device` that captures run on (the legacy default
    stream cannot capture), made once a process. Its cuBLAS handle and
    workspaces, which a stream gets at its first product, are made here by a
    product of each dtype, so that none is taken from a graph's pool."""
    stream = _streams.get(device)
    if stream is None:
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.ones(16, 16, dtype=dt, device=device)
                F.linear(x, x, x[0])
                torch.mm(x, x)
        torch.cuda.current_stream(device).wait_stream(stream)
        _streams[device] = stream
    return stream


def _launch_counters() -> list[tuple]:
    """(holder, key, get, set) of every launch counter: the int attributes
    `launches*` of the kernel wrappers, and each entry of a dict one."""
    from ovmono3d_tpu_torch.ops import (attention, attn_sweep, optim_kernels,
                                        quant)
    cells = []
    for module in (attention, attn_sweep, optim_kernels, quant):
        for fn in vars(module).values():
            if not callable(fn):
                continue
            for attr in ("launches", "launches_f32"):
                value = getattr(fn, attr, None)
                if isinstance(value, int):
                    cells.append((fn, attr, getattr, setattr))
                elif isinstance(value, dict):
                    cells += [(value, k, dict.__getitem__, dict.__setitem__)
                              for k in value]
    return cells


class _Cut:
    """A span inside a capture: its entry and its exit each end a segment
    and note the span in the plan."""

    __slots__ = ("graphs", "name", "unit")

    def __init__(self, graphs: "SpanGraphs", name: str, unit: bool):
        self.graphs, self.name, self.unit = graphs, name, unit

    def __enter__(self) -> "_Cut":
        self.graphs._step(("open", self.name, self.unit))
        return self

    def __exit__(self, *exc) -> None:
        self.graphs._step(("close",))


class SpanGraphs:
    """One capture's plan of segments and spans, and its replay (see the
    module's docstring). `make_graph` and `pool` are the graph class and
    the shared pool's handle (`torch.cuda.CUDAGraph` and a new pool by
    default)."""

    def __init__(self, make_graph=None, pool=None):
        if make_graph is None:
            make_graph = torch.cuda.CUDAGraph
            pool = torch.cuda.graph_pool_handle()
        self._make, self._pool = make_graph, pool
        self.plan: list[tuple] = []
        self.launches: list[tuple] = []    # (counter cell, launches captured)
        self._open = None

    def capture(self, fn, stream: torch.cuda.Stream | None = None):
        """fn() with its work captured on `stream` (the current stream when
        None), cut at its spans; returns what fn returns."""
        if self.plan:
            raise RuntimeError("SpanGraphs captures once")
        cells = _launch_counters()
        before = [get(h, k) for h, k, get, _ in cells]
        ctx = (contextlib.nullcontext() if stream is None
               else torch.cuda.stream(stream))
        with ctx, trace.cutting(functools.partial(_Cut, self)):
            self._begin()
            try:
                out = fn()
            finally:
                self._end()
        for (h, k, get, put), was in zip(cells, before):
            ran = get(h, k) - was
            put(h, k, was)
            if ran:
                self.launches.append(((h, k, get, put), ran))
        return out

    def replay(self) -> None:
        """The plan on the current stream: each segment replayed, each span
        opened and closed where the capture met it."""
        opened = []
        for step in self.plan:
            if step[0] == "graph":
                step[1].replay()
            elif step[0] == "open":
                s = trace.span(step[1], step[2])
                s.__enter__()
                opened.append(s)
            else:
                opened.pop().__exit__(None, None, None)
        for (h, k, get, put), ran in self.launches:
            put(h, k, get(h, k) + ran)

    def _step(self, step: tuple) -> None:
        self._end()
        self.plan.append(step)
        self._begin()

    def _begin(self) -> None:
        graph = self._make()
        graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        self._open = graph

    def _end(self) -> None:
        graph, self._open = self._open, None
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in seen:
            if _EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if not empty:
            self.plan.append(("graph", graph))

