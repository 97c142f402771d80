"""How a per-layer reader finds the program's spans.

The port opens spans at its layer boundaries (ovmono3d_tpu_torch/utils/
trace.py: train.step, train.backward, train.optimizer, eval.batch,
model.trunk, model.pyramid, model.rpn, model.proposals, model.box_head,
model.cube_head, ...). They record only while a torch profiler runs, so in
a traced run they record in the window's last TRACE_SECONDS, under the
window's profiler, and nowhere else: set-up and the check after the window
run without one. They wait in the port's buffer, with their CUDA events,
until a reader reads them after the window's closing synchronize.

A reader asks `per_unit_ms(run, names, kind, unit)`: the named spans' host
or device milliseconds summed over the window and divided by its units
(run.work["steps"] or ["requests"]). It gives None where nothing was
recorded: a program without the recorder (an older commit), a device
reading with no events (off the card), or no span of those names; the
harness then leaves the metric out.
"""
from __future__ import annotations


def table(run) -> dict | None:
    """The recorded spans summed by name (`trace.summarize`: count,
    host_ms, device_ms, self_ms, backlog_ms), or None."""
    try:
        from ovmono3d_tpu_torch.utils import trace
    except ImportError:
        return None
    rows = trace.read()
    return trace.summarize(rows) if rows else None


def per_unit_ms(run, names: tuple[str, ...], kind: str, unit: str):
    """`kind` ("host_ms" or "device_ms") of the spans named `names`,
    summed, over run.work[unit]; None when there is nothing to read."""
    units = run.work.get(unit)
    spans = table(run)
    if not units or not spans:
        return None
    got = [spans[n][kind] for n in names
           if n in spans and spans[n][kind] is not None]
    return sum(got) / units if got else None
