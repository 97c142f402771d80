"""Spans at the port's layer boundaries, on the profiler's clock.

    with span("train.step", unit=True):
        with span("model.trunk"):
            ...

A span records its name, its parent (the innermost span open on the same
thread), its unit (the ordinal of the innermost unit span it lies in, a
train step or an eval batch, shared by all of that unit's spans), its host
start and end in `time.time_ns()` (nanoseconds since the Unix epoch, the
clock of torch.profiler's raw events, so spans land on the profiler's
timeline) and, once CUDA is up, a pair of timing events recorded on the
current stream at entry and exit. Nothing synchronises: the events are
resolved when the spans are read (`read`), after the caller has
synchronised the device.

Under a profiler of device activity a CUDA call costs the host several
microseconds more, and making an event (its first record) and looking up
the current stream cost as much as recording it. So spans take their
events from a pool, which a unit span refills when it closes, where the
device usually trails the host, with as many made events as the unit took;
`clear` returns the cleared spans' events to it. The current stream's
handle is kept by its id.

Spans record only while a torch profiler runs on the thread
(`torch.autograd._profiler_enabled()`) or inside `recording()`. Off, `span`
costs one check and allocates nothing. Inside `cutting(cut)`, where a CUDA
graph captures work that nothing runs yet (`utils/graphs.py`), `span`
records nothing and returns `cut(name, unit)` instead, which ends the
graph's segment there; the replay opens the span between segments. When
the running profiler records CPU activity (the train CLI's --profile), a
span also opens a record function of its name, so the Chrome trace shows
the program's structure; a profiler of device activity alone records
none. Recorded spans wait in a
bounded buffer (the oldest go past MAX_SPANS) until `clear`, after
which their events are reused (a span kept elsewhere then reads no device
time).

`read` gives per span: host ms; device ms (the stream's time from the start
event to the end event, idle inside the span included; None without
events); self ms (the span less its children: device ms where there are
events, else host ms); and the backlog at entry, how far the device trailed
the host when the span opened: its start event's device offset less its
host offset, less the least such difference among the spans read. Near 0
the device was waiting for the host. `summarize` sums them by name.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

MAX_SPANS = 16384

_profiler_enabled = torch.autograd._profiler_enabled
# A record function that costs nothing unless the profiler's CPU callbacks
# are registered (a profiler of CPU activity).
_RecordFunction = torch._C._profiler._RecordFunctionFast

_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_collectors: list[list] = []     # the open recording() scopes' lists
_cut = None                      # cutting()'s cut while a capture runs
_ids = itertools.count()
_units = itertools.count()
_local = threading.local()
# Made timing events by device, and the count taken since a unit last
# closed; the current stream's handle by (id, device, type).
_pool: dict[int, list] = collections.defaultdict(list)
_taken = 0
_streams: dict[tuple, torch.cuda.Stream] = {}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded span; its own context manager (see the module's
    docstring)."""

    __slots__ = ("name", "is_unit", "id", "parent", "unit", "start_ns",
                 "end_ns", "events", "_record")

    def __init__(self, name: str, is_unit: bool):
        self.name, self.is_unit = name, is_unit
        self.events = None

    def __enter__(self) -> Span:
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.unit = (next(_units) if self.is_unit
                     else None if up is None else up.unit)
        self.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            stream = _current_stream()
            self.events = (_event(stream), _event(stream))
            self.events[0].record(stream)
        self._record = _RecordFunction(self.name)
        self._record.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        self._record.__exit__(*exc)
        if self.events is not None:
            stream = _current_stream()
            self.events[1].record(stream)
        self.end_ns = time.time_ns()
        if self.is_unit and self.events is not None:
            _refill(stream)
        _stack().pop()
        _buffer.append(self)
        for got in _collectors:
            got.append(self)


def _current_stream() -> torch.cuda.Stream:
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def _event(stream: torch.cuda.Stream) -> torch.cuda.Event:
    global _taken
    _taken += 1
    free = _pool[stream.device_index]
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _refill(stream: torch.cuda.Stream) -> None:
    """Make (record once) as many events as were taken since a unit last
    closed, less those the pool holds."""
    global _taken
    free = _pool[stream.device_index]
    for _ in range(_taken - len(free)):
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        free.append(event)
    _taken = 0


_OFF = contextlib.nullcontext()


def span(name: str, unit: bool = False):
    """A span of `name` while spans record, else a shared no-op context.
    `unit` makes it a unit of work: its spans share its ordinal."""
    if _collectors or _profiler_enabled():
        return Span(name, unit) if _cut is None else _cut(name, unit)
    return _OFF


@contextlib.contextmanager
def recording():
    """Spans record inside this scope whether or not a profiler runs;
    yields the list of the spans that close in it."""
    got: list[Span] = []
    _collectors.append(got)
    try:
        yield got
    finally:
        _collectors.remove(got)


@contextlib.contextmanager
def cutting(cut):
    """Inside this scope `span(name, unit)` returns `cut(name, unit)`, a
    context manager, whether or not spans record, and records nothing: the
    scope of a graph capture, which cuts its segments at the spans."""
    global _cut
    _collectors.append([])
    _cut = cut
    try:
        yield
    finally:
        _cut = None
        _collectors.pop()


def clear() -> None:
    """Empty the buffer; its spans' events go back to the pool."""
    for s in _buffer:
        if s.events is not None:
            _pool[s.events[0].device.index].extend(s.events)
            s.events = None
    _buffer.clear()


def read(recorded: list[Span] | None = None) -> list[dict]:
    """Each span's readings (the buffer's when `recorded` is None), in the
    order they opened: name, id, parent, unit, start_ns, end_ns, host_ms,
    device_ms, self_ms, backlog_ms (None without events). Waits for each
    end event, which costs nothing after the caller's synchronise."""
    recorded = sorted(_buffer if recorded is None else recorded,
                      key=lambda s: s.id)
    rows = []
    for s in recorded:
        row = {"name": s.name, "id": s.id, "parent": s.parent,
               "unit": s.unit, "start_ns": s.start_ns, "end_ns": s.end_ns,
               "host_ms": (s.end_ns - s.start_ns) * 1e-6,
               "device_ms": None, "backlog_ms": None}
        if s.events is not None:
            s.events[1].synchronize()
            row["device_ms"] = s.events[0].elapsed_time(s.events[1])
        rows.append(row)
    timed = [(s, r) for s, r in zip(recorded, rows) if s.events is not None]
    if timed:
        ref, _ = timed[0]
        lag = [ref.events[0].elapsed_time(s.events[0])
               - (s.start_ns - ref.start_ns) * 1e-6 for s, _ in timed]
        least = min(lag)
        for (_, r), x in zip(timed, lag):
            r["backlog_ms"] = x - least
    inner: dict = collections.defaultdict(float)
    for r in rows:
        if r["parent"] is not None:
            inner[r["parent"]] += _own_ms(r)
    for r in rows:
        r["self_ms"] = _own_ms(r) - inner.get(r["id"], 0.0)
    return rows


def _own_ms(row: dict) -> float:
    return row["host_ms"] if row["device_ms"] is None else row["device_ms"]


def summarize(rows: list[dict], per: float = 1.0) -> dict[str, dict]:
    """`read`'s rows by name, in the order each name first opened: count,
    host_ms, device_ms (None without events) and self_ms summed and divided
    by `per` (the units read, for a mean a unit), backlog_ms averaged over
    the name's spans."""
    out: dict[str, dict] = {}
    for r in rows:
        s = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0,
                                       "device_ms": None, "self_ms": 0.0,
                                       "backlog_ms": None, "_lags": []})
        s["count"] += 1
        s["host_ms"] += r["host_ms"] / per
        s["self_ms"] += r["self_ms"] / per
        if r["device_ms"] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r["device_ms"] / per
            s["_lags"].append(r["backlog_ms"])
    for s in out.values():
        lags = s.pop("_lags")
        if lags:
            s["backlog_ms"] = sum(lags) / len(lags)
    return out


@contextlib.contextmanager
def stages(trace: dict | None, names: tuple[str, ...]):
    """A serving call's stage spans into trace["ms"]: each of `names` that
    opened, in the order they opened, with its device ms (host ms without
    events), after the scope; nothing when `trace` is None."""
    if trace is None:
        yield
        return
    with recording() as got:
        yield
    trace["ms"] = {r["name"]: _own_ms(r) for r in read(
        [s for s in got if s.name in names])}
