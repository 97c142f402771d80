"""The span readers (spans.py and the metrics reading program spans) on a
fake run: per-unit means of the named spans, and None where nothing was
recorded, where the program lacks the recorder, or off the card for a
device reading."""
import sys

import pytest

from benchmark import harness, spans
from ovmono3d_tpu_torch.utils import trace

# reader -> (span names, kind, unit)
READERS = {
    "host_ms.train": (("train.step",), "host_ms", "steps"),
    "host_ms.infer": (("eval.batch",), "host_ms", "requests"),
    "pyramid_ms.train": (("model.pyramid",), "device_ms", "steps"),
    "proposals_ms.train": (("model.proposals",), "device_ms", "steps"),
    "roi_heads_ms.train": (("model.box_head", "model.cube_head"),
                           "device_ms", "steps"),
    "backward_ms.train": (("train.backward",), "device_ms", "steps"),
    "optimizer_ms.train": (("train.optimizer",), "device_ms", "steps"),
    "roi_heads_ms.infer": (("model.cube_head",), "device_ms", "requests"),
}


def fake_run(units: int = 2):
    run = harness.Run(workload="w", cfg={}, traffic={}, seed=0, seconds=1,
                      trace=True)
    run.work = {"steps": units, "requests": units, "images": 8 * units}
    return run


def fake_rows():
    """Two units of every span name, each unit's span i of name n lasting
    (i + 1) ms on the host and 10 * (i + 1) ms on the device, nested under
    its unit span."""
    names = ["train.step", "eval.batch", "model.trunk", "model.pyramid",
             "model.pyramid", "model.rpn", "model.proposals",
             "model.box_head", "model.cube_head", "train.backward",
             "train.optimizer"]
    rows, ident = [], 0
    for unit in range(2):
        root = ident
        for i, name in enumerate(names):
            rows.append({"name": name, "id": ident,
                         "parent": None if i == 0 else root, "unit": unit,
                         "start_ns": ident, "end_ns": ident + 1,
                         "host_ms": float(i + 1),
                         "device_ms": 10.0 * (i + 1),
                         "backlog_ms": float(unit)})
            ident += 1
    for r in rows:
        r["self_ms"] = r["device_ms"]
    return rows, names


@pytest.fixture
def empty():
    trace.clear()
    yield
    trace.clear()


@pytest.mark.parametrize("name", list(READERS))
def test_reader_is_the_per_unit_sum_of_its_spans(name, monkeypatch):
    rows, names = fake_rows()
    monkeypatch.setattr(trace, "read", lambda recorded=None: rows)
    wanted, kind, _ = READERS[name]
    scale = 1.0 if kind == "host_ms" else 10.0
    # Both units' spans of each name, over 2 units.
    want = sum(scale * (i + 1) for i, n in enumerate(names)
               if n in wanted)
    got = harness.load_module("metrics", name).read(fake_run())
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_nothing_without_spans(name, empty):
    assert harness.load_module("metrics", name).read(fake_run()) is None


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_nothing_without_the_recorder(name, monkeypatch):
    """An older program, whose package has no utils/trace.py."""
    monkeypatch.setitem(sys.modules, "ovmono3d_tpu_torch.utils.trace", None)
    assert spans.table(fake_run()) is None
    assert harness.load_module("metrics", name).read(fake_run()) is None


def test_off_the_card_only_host_readers_read(empty):
    """CPU spans carry no events: the device readers give None, the host
    ones the host time a unit."""
    with trace.recording():
        for _ in range(2):
            with trace.span("train.step", unit=True):
                with trace.span("model.pyramid"):
                    pass
    run = fake_run()
    host = harness.load_module("metrics", "host_ms.train").read(run)
    rows = trace.read()
    assert host == pytest.approx(
        sum(r["host_ms"] for r in rows if r["name"] == "train.step") / 2)
    assert harness.load_module("metrics", "pyramid_ms.train").read(run) \
        is None


def test_no_units_reads_nothing(monkeypatch):
    rows, _ = fake_rows()
    monkeypatch.setattr(trace, "read", lambda recorded=None: rows)
    assert spans.per_unit_ms(fake_run(0), ("train.step",), "host_ms",
                             "steps") is None
    table = spans.table(fake_run())
    assert table["model.pyramid"]["count"] == 4
    assert table["model.pyramid"]["backlog_ms"] == pytest.approx(0.5)
