"""The stream's chunk replayed from CUDA graphs cut at the spans
(`utils/graphs.py`, `parallel/serve.py` `make_lift_stream_fn`).

On the CPU: a span's off path allocates nothing; a capture scope cuts at
every span, recorded or not; the segment plan (open, segment, close) is
built in span order with a stand-in for the graph, drops the segments that
captured nothing, replays in order with the spans an eager run records,
and leaves the launch counters as they were until it replays; the CPU
stream runs and counts every chunk eagerly.

On the card (`cuda`, skipped without one), at a small GroundingDINO + LIFT
configuration whose Swin and ViT run kernels 8 and 1: four full chunks and
a partial one count 2 eager, 1 captured and 2 replayed, and equal one-chunk
(eager) streams of the same rows bit for bit in every Detections field and
every captured tensor; the attention wrappers' launches grow by the eager
count a chunk, the capture's chunk included; a recorded replay yields the
eager chunk's spans; closing the stream gives back its device memory.
"""
import dataclasses
import gc
import itertools
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.eval.oracle2d import category_tokenizer
from ovmono3d_tpu_torch.models import ovmono3d as tov
from ovmono3d_tpu_torch.ops import attention
from ovmono3d_tpu_torch.parallel import serve
from ovmono3d_tpu_torch.utils import graphs, trace
from test_torch_gdino_stream import CATS, GDINO, _config

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _chunks() -> tuple[int, int, int]:
    c = serve.lift_stream_chunks
    return c.eager, c.captured, c.replayed


def _items(n: int, seed: int = 5) -> list[tuple]:
    rng = np.random.default_rng(seed)
    sizes = itertools.cycle(((120, 160), (112, 112), (150, 100), (90, 200)))
    return [((rng.random((h, w, 3)) * 255).astype(np.uint8),
             tov.default_focal_K(h, w)) for (h, w), _ in zip(sizes, range(n))]


# -- the CPU ------------------------------------------------------------------


def test_span_off_allocates_nothing():
    assert not torch.autograd._profiler_enabled()
    with trace.span("warm"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("off.a"):
                with trace.span("off.b", unit=True):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename.endswith("utils/trace.py")
             and d.size_diff > 0]
    assert grown == []
    assert trace.span("off.c") is trace.span("off.d")


def test_cutting_takes_every_span_recorded_or_not():
    seen = []

    def cut(name, unit):
        seen.append((name, unit))
        return trace._OFF

    with trace.recording() as got:
        with trace.cutting(cut):
            with trace.span("a"):
                with trace.span("b", unit=True):
                    pass
        with trace.span("after"):
            pass
    with trace.cutting(cut):
        with trace.span("c"):
            pass
    assert seen == [("a", False), ("b", True), ("c", False)]
    assert [s.name for s in got] == ["after"]
    assert trace._cut is None and trace._collectors == []


class FakeGraph:
    """A stand-in for torch.cuda.CUDAGraph: records its capture's index and
    the work done while it captured, warns as PyTorch does when it captured
    nothing, and logs its replays."""

    work: list = []
    log: list = []
    made = 0

    def capture_begin(self, pool=None, capture_error_mode=None):
        assert pool == "pool" and capture_error_mode == "thread_local"
        self.index, FakeGraph.made = FakeGraph.made, FakeGraph.made + 1
        self.start = len(FakeGraph.work)

    def capture_end(self):
        self.did = FakeGraph.work[self.start:]
        if not self.did:
            warnings.warn("The CUDA Graph is empty. This usually means ...")

    def replay(self):
        FakeGraph.log.append(("replay", self.did))


def _work(tag: str) -> None:
    FakeGraph.work.append(tag)


def _nested():
    """Work and spans as a chunk opens them: a span with children, two
    spans back to back (nothing between them), work before and after."""
    _work("prep")
    with trace.span("gdino"):
        _work("a")
        with trace.span("gdino.bert"):
            _work("b")
        with trace.span("gdino.swin"):
            _work("c")
            attention.window_flash_attention.launches += 3
    with trace.span("lift"):
        _work("d")
        attention.flash_attention_packed.launches += 1
    return "out"


def _span_tree(rows: list[dict]) -> list[tuple]:
    names = {r["id"]: r["name"] for r in rows}
    return [(r["name"], names.get(r["parent"]), r["unit"]) for r in rows]


def test_segment_plan_follows_the_spans():
    FakeGraph.work, FakeGraph.log, FakeGraph.made = [], [], 0
    window0 = attention.window_flash_attention.launches
    packed0 = attention.flash_attention_packed.launches
    g = graphs.SpanGraphs(FakeGraph, "pool")
    assert g.capture(_nested) == "out"
    # The capture counted 3 + 1 launches and put them back.
    assert attention.window_flash_attention.launches == window0
    assert attention.flash_attention_packed.launches == packed0
    plan = [(s[0], s[1].did) if s[0] == "graph" else s for s in g.plan]
    assert plan == [
        ("graph", ["prep"]), ("open", "gdino", False), ("graph", ["a"]),
        ("open", "gdino.bert", False), ("graph", ["b"]), ("close",),
        ("open", "gdino.swin", False), ("graph", ["c"]), ("close",),
        ("close",), ("open", "lift", False), ("graph", ["d"]), ("close",)]
    # 9 graphs captured: 4 empty ones (between spans, and the last) dropped.
    assert FakeGraph.made == 9
    assert sum(s[0] == "graph" for s in g.plan) == 5
    assert trace._cut is None

    # Replayed under a recording, the spans are the eager run's.
    with trace.recording() as eager:
        with trace.span("stream.chunk", unit=True):
            _nested()
    with trace.recording() as replayed:
        with trace.span("stream.chunk", unit=True):
            g.replay()
    assert FakeGraph.log == [("replay", w) for w in
                             (["prep"], ["a"], ["b"], ["c"], ["d"])]
    tree = _span_tree(trace.read(eager))
    got = _span_tree(trace.read(replayed))
    assert [t[:2] for t in got] == [t[:2] for t in tree]
    assert [t[0] for t in got] == ["stream.chunk", "gdino", "gdino.bert",
                                   "gdino.swin", "lift"]
    assert len({t[2] for t in got}) == 1
    assert attention.window_flash_attention.launches == window0 + 6
    assert attention.flash_attention_packed.launches == packed0 + 2
    with pytest.raises(RuntimeError):
        g.capture(_nested)
    attention.window_flash_attention.launches = window0
    attention.flash_attention_packed.launches = packed0


def test_cpu_stream_runs_every_chunk_eagerly():
    pipe = tov.OVMono3DLift.build(_config(), category_tokenizer(CATS),
                                  gdino_kwargs=GDINO, device="cpu", seed=3)
    items = _items(5)
    start = _chunks()
    caps: dict = {}
    got = list(pipe.predict_stream(items, CATS, chunk=2,
                                   capture=lambda i: caps.setdefault(i, {})))
    end = _chunks()
    assert (end[0] - start[0], end[1] - start[1], end[2] - start[2]) == (
        3, 0, 0)
    assert len(got) == 5 and sorted(caps) == list(range(5))
    # The same rows one chunk a stream.
    for at in range(0, 5, 2):
        alone = list(pipe.predict_stream(items[at:at + 2], CATS, chunk=2))
        for a, b in zip(alone, got[at:at + 2]):
            for (k, x), (_, y) in zip(a.items(), b.items()):
                assert torch.equal(x, y), k


# -- the card -----------------------------------------------------------------

CHUNK = 2


@pytest.fixture(scope="module")
def card_pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = _config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(
            cfg.model.backbone, embed_dim=64, num_heads=2)))
    # bf16 Swin with 32-wide heads (kernel 8) and a ViT of 32-wide heads
    # (kernel 1).
    kw = dict(GDINO, compute_dtype=torch.bfloat16, swin_embed_dim=32)
    return tov.OVMono3DLift.build(cfg, category_tokenizer(CATS),
                                  gdino_kwargs=kw, device="cuda", seed=3)


def _launches() -> dict:
    return {n: getattr(attention, n).launches for n in
            ("window_flash_attention", "flash_attention_packed")}


def _stream(pipe, items, caps=None, probe=None):
    """predict_stream over `items` in chunks of CHUNK, each row captured
    into `caps`; `probe(i)` is called as item i is taken."""
    def taken():
        for i, item in enumerate(items):
            if probe is not None:
                probe(i)
            yield item
    return pipe.predict_stream(
        taken(), CATS, chunk=CHUNK,
        capture=None if caps is None else lambda i: caps.setdefault(i, {}))


def _equal(a, b, where: str) -> None:
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.cpu(), b.cpu()), where


@pytest.mark.cuda
def test_graphed_stream_equals_eager_chunks(card_pipe):
    """Four full chunks and a partial one: the second is captured, the
    third and fourth replayed; every Detections field and every captured
    tensor equals a one-chunk stream of the same rows (run eagerly) bit
    for bit, and the attention launches grow by the eager count a chunk."""
    items = _items(4 * CHUNK + 1)
    snaps = []
    start = _chunks()
    caps: dict = {}
    got = list(_stream(card_pipe, items, caps,
                       probe=lambda i: snaps.append(_launches())
                       if i % CHUNK == 0 else None))
    torch.cuda.synchronize()
    snaps.append(_launches())
    end = _chunks()
    assert (end[0] - start[0], end[1] - start[1], end[2] - start[2]) == (
        2, 1, 2)
    per = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]
    full, last = per[:4], per[4]
    assert full[0]["window_flash_attention"] > 0
    assert full[0]["flash_attention_packed"] > 0
    assert all(p == full[0] for p in full), per
    assert last == full[0]       # the partial chunk: another eager batch
    for at in range(0, len(items), CHUNK):
        mine: dict = {}
        alone = list(_stream(card_pipe, items[at:at + CHUNK], mine))
        for j, (a, b) in enumerate(zip(alone, got[at:at + CHUNK])):
            _equal(dict(a.items()), dict(b.items()), f"row {at + j}")
            _equal(mine[j], caps[at + j], f"capture {at + j}")


@pytest.mark.cuda
def test_replayed_chunk_records_the_eager_spans(card_pipe):
    with trace.recording() as got:
        list(_stream(card_pipe, _items(3 * CHUNK)))
    torch.cuda.synchronize()
    rows = trace.read(got)
    units = sorted({r["unit"] for r in rows})
    assert len(units) == 3
    trees = [[t[:2] for t in _span_tree(rows) if t[2] == u] for u in units]
    assert trees[0][0] == ("stream.chunk", None)
    names = [t[0] for t in trees[0]]
    assert {"gdino", "gdino.swin", "gdino.encoder", "gdino.deformable",
            "postprocess", "lift", "model.cube_head"} <= set(names)
    assert trees[1] == trees[0] and trees[2] == trees[0]
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0
               for r in rows)


@pytest.mark.cuda
def test_closing_the_stream_frees_the_graphs(card_pipe):
    """The second stream of the process (the first made the caches and the
    capture stream's handles): its device memory, the graphs' pool
    included, is back once it is closed mid-way."""
    list(_stream(card_pipe, _items(2 * CHUNK)))
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    start = _chunks()
    stream = _stream(card_pipe, itertools.cycle(_items(2 * CHUNK)), {})
    for _ in range(4 * CHUNK):
        next(stream)
    assert _chunks()[1] - start[1] == 1
    assert torch.cuda.memory_allocated() > before
    stream.close()
    del stream
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
