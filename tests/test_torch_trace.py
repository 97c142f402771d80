"""The span recorder (utils/trace.py) on the CPU at tiny sizes: nesting,
parents, units and self time; off without a profiler or a recording scope;
on under a CPU profiler; host stamps on the profiler's clock; the train
step's and the oracle batch's span trees. One `cuda` test checks the
clock and the events against the profiler's raw events on the card."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ovmono3d_tpu_torch.config import load_config
from ovmono3d_tpu_torch.eval.cli import make_run_fn
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
from ovmono3d_tpu_torch.train.optim import Optimizer
from ovmono3d_tpu_torch.utils import trace

MODEL_SPANS = ("model.trunk", "model.pyramid", "model.rpn",
               "model.proposals", "model.box_head", "model.cube_head")
# A tiny flagship detector (the DINOv2 preset at small widths), its trunk
# frozen as published.
TINY = [
    "model.backbone.embed_dim=32", "model.backbone.depth=1",
    "model.backbone.num_heads=2", "model.backbone.pretrain_grid=8",
    "model.backbone.out_channels=32", "model.backbone.square_pad=112",
    "model.roi_box.fc_dim=32", "model.roi_box.batch_size_per_image=16",
    "model.rpn.pre_nms_topk_train=64", "model.rpn.post_nms_topk_train=64",
    "model.rpn.pre_nms_topk_test=64", "model.rpn.post_nms_topk_test=32",
    "model.rpn.batch_size_per_image=32", "model.cube.fc_dim=32",
    "model.num_classes=5", "model.max_detections=16",
]
B, M, S = 2, 3, 112


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _busy(ms: float) -> None:
    end = time.perf_counter() + ms * 1e-3
    while time.perf_counter() < end:
        pass


def test_nesting_parents_units_and_self_time():
    with trace.recording() as got:
        for _ in range(2):
            with trace.span("unit", unit=True):
                with trace.span("a"):
                    _busy(2)
                    with trace.span("b"):
                        _busy(3)
                with trace.span("c"):
                    _busy(1)
        with trace.span("loose"):
            pass
    assert [s.name for s in got] == ["b", "a", "c", "unit"] * 2 + ["loose"]
    rows = trace.read(got)
    assert [r["name"] for r in rows] == ["unit", "a", "b", "c"] * 2 + [
        "loose"]
    by_id = {r["id"]: r for r in rows}
    units = [r for r in rows if r["name"] == "unit"]
    assert len({r["unit"] for r in units}) == 2
    for r in rows:
        if r["name"] == "loose":
            assert r["parent"] is None and r["unit"] is None
            continue
        parent = by_id.get(r["parent"])
        want = {"unit": None, "a": "unit", "b": "a", "c": "unit"}[r["name"]]
        assert (parent and parent["name"]) == want
        assert r["unit"] == (r["unit"] if parent is None else parent["unit"])
        assert r["device_ms"] is None and r["backlog_ms"] is None
    a, b, c, u = (rows[i] for i in (1, 2, 3, 0))
    assert a["self_ms"] == pytest.approx(a["host_ms"] - b["host_ms"])
    assert u["self_ms"] == pytest.approx(
        u["host_ms"] - a["host_ms"] - c["host_ms"])
    assert b["self_ms"] == b["host_ms"] >= 3.0
    assert a["self_ms"] >= 2.0
    summary = trace.summarize(rows, per=2)
    assert list(summary) == ["unit", "a", "b", "c", "loose"]
    assert summary["b"]["count"] == 2
    assert summary["b"]["host_ms"] == pytest.approx(
        sum(r["host_ms"] for r in rows if r["name"] == "b") / 2)
    assert summary["b"]["device_ms"] is None


def test_off_records_nothing():
    assert not torch.autograd._profiler_enabled()
    ctx = trace.span("off")
    assert ctx is trace.span("other")       # one shared no-op, no span
    assert not isinstance(ctx, trace.Span)
    with ctx:
        pass
    assert trace.read() == []


def test_on_under_a_cpu_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("probe.on", unit=True):
            torch.ones(4).sum()
    assert [r["name"] for r in trace.read()] == ["probe.on"]
    with trace.span("probe.after"):
        pass
    assert len(trace.read()) == 1


def test_recording_scope():
    with trace.recording() as got:
        with trace.span("inside"):
            pass
    assert [s.name for s in got] == ["inside"]
    with trace.span("outside"):
        pass
    assert [r["name"] for r in trace.read()] == ["inside"]
    ms: dict = {}
    with trace.stages(ms, ("inside", "second")):
        with trace.span("second"):
            _busy(1)
        with trace.span("inside"):
            with trace.span("not.a.stage"):
                pass
    assert list(ms["ms"]) == ["second", "inside"]
    assert ms["ms"]["second"] >= 1.0
    with trace.stages(None, ("x",)):
        with trace.span("x"):
            pass
    assert "x" not in {r["name"] for r in trace.read()}


def test_host_stamps_agree_with_the_profilers_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe.clock") as s:
            _busy(2)
            torch.ones(64).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "probe.clock"]
    assert len(events) == 1
    e = events[0]
    assert abs(e.start_ns() - s.start_ns) < 1_000_000
    assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000


def _batch(seed: int) -> dict:
    """B images with M GT slots each (the last of the second invalid):
    boxes in front of the camera, their 2D boxes the projected extents;
    the GT doubles as the oracle 2D boxes."""
    rng = np.random.default_rng(seed)
    f = 100.0
    K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
    center = np.stack([rng.uniform(-1, 1, (B, M)),
                       rng.uniform(-.5, .5, (B, M)),
                       rng.uniform(3, 8, (B, M))], -1)
    dims = rng.uniform(0.5, 1.5, (B, M, 3))
    uv = center[..., :2] / center[..., 2:] * f + S / 2
    half = dims[..., :2] * f / center[..., 2:] / 2
    boxes = np.clip(np.concatenate([uv - half, uv + half], -1), 0, S - 1)
    valid = np.ones((B, M), bool)
    valid[1, -1] = False
    classes = torch.tensor(rng.integers(0, 5, (B, M)))
    boxes = torch.tensor(boxes, dtype=torch.float32)
    return {
        "image": torch.tensor(rng.uniform(0, 255, (B, S, S, 3)),
                              dtype=torch.float32),
        "K": torch.tensor(np.tile(K, (B, 1, 1))),
        "im_hw": torch.full((B, 2), S, dtype=torch.int32),
        "im_scale_ratio": torch.ones(B),
        "gt_boxes": boxes, "gt_classes": classes,
        "gt_boxes3d": torch.tensor(np.concatenate(
            [uv, center[..., 2:], dims, center], -1), dtype=torch.float32),
        "gt_poses": torch.eye(3).expand(B, M, 3, 3).contiguous(),
        "gt_valid": torch.tensor(valid),
        "oracle_boxes": boxes, "oracle_classes": classes,
        "oracle_scores": torch.ones(B, M),
        "oracle_valid": torch.tensor(valid),
    }


def _tiny_train():
    cfg = load_config(None, overrides=TINY)
    model = build_model(cfg.model, device="cpu", seed=1)
    opt = Optimizer(cfg.solver, model)
    state = create_train_state(model, opt, seed=3)
    batch = {k: v for k, v in _batch(3).items()
             if not k.startswith("oracle")}
    return state, make_train_step(model, opt, cfg.model.stabilize), batch


def test_train_step_records_its_span_tree_once_a_step():
    state, step, batch = _tiny_train()
    step(state, batch)                       # nothing records off
    assert trace.read() == []
    with trace.recording():
        for _ in range(2):
            state, _ = step(state, batch)
    rows = trace.read()
    by_id = {r["id"]: r for r in rows}
    steps = [r for r in rows if r["name"] == "train.step"]
    assert len(steps) == 2 and all(r["parent"] is None for r in steps)
    assert steps[0]["unit"] != steps[1]["unit"]
    want = {"train.step": None, "train.backward": "train.step",
            "train.optimizer": "train.step",
            **{n: "train.step" for n in MODEL_SPANS}}
    for root in steps:
        tree = [r for r in rows if r["unit"] == root["unit"]]
        assert sorted(r["name"] for r in tree) == sorted(want)
        for r in tree:
            parent = by_id.get(r["parent"])
            assert (parent and parent["name"]) == want[r["name"]], r
            assert r["start_ns"] >= root["start_ns"]
            assert r["end_ns"] <= root["end_ns"]
    order = [r["name"] for r in rows if r["unit"] == steps[0]["unit"]]
    assert order == ["train.step", *MODEL_SPANS, "train.backward",
                     "train.optimizer"]


def test_oracle_batch_records_the_eval_batch_and_its_model_spans():
    cfg = load_config(None, overrides=TINY)
    model = build_model(cfg.model, device="cpu", seed=1)
    model.requires_grad_(False)
    model.eval()
    batch = _batch(4)
    run = make_run_fn(model)
    with trace.recording():
        det = run(batch, None)
    assert det.corners3d.shape[:2] == batch["oracle_boxes"].shape[:2]
    rows = trace.read()
    assert [r["name"] for r in rows] == [
        "eval.batch", "model.trunk", "model.pyramid", "model.cube_head"]
    root = rows[0]
    assert root["unit"] is not None and root["parent"] is None
    assert all(r["parent"] == root["id"] and r["unit"] == root["unit"]
               for r in rows[1:])


@pytest.mark.cuda
def test_spans_share_the_profilers_clock_on_the_card():
    """A span's host interval holds the cudaLaunchKernel of a kernel
    launched inside it, and its events bracket that kernel on the stream:
    the span's device time covers the kernel and fits in the gap that the
    kernels before and after it leave."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda.init()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd._profiler_enabled()
        torch.cuda._sleep(2_000_000)
        with trace.span("probe.card", unit=True) as s:
            torch.cuda._sleep(4_000_000)
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
    row = trace.read([s])[0]
    events = list(prof.profiler.kineto_results.events())
    kernels = sorted((e for e in events
                      if e.device_type() == torch.autograd.DeviceType.CUDA
                      and "spin" in e.name()), key=lambda e: e.start_ns())
    assert len(kernels) == 3, [e.name() for e in kernels]
    before, inside, after = kernels
    launch = {e.correlation_id(): e for e in events
              if e.device_type() != torch.autograd.DeviceType.CUDA
              and "LaunchKernel" in e.name()}
    launched = [launch[k.correlation_id()] for k in kernels]
    assert s.start_ns <= launched[1].start_ns()
    assert launched[1].start_ns() + launched[1].duration_ns() <= s.end_ns
    assert launched[0].start_ns() < s.start_ns < launched[2].start_ns()
    gap_ms = (after.start_ns() - (before.start_ns() + before.duration_ns())
              ) * 1e-6
    kernel_ms = inside.duration_ns() * 1e-6
    print(f"span host [{s.start_ns}, {s.end_ns}] ns, launch at "
          f"{launched[1].start_ns()} ns; device {row['device_ms']:.4f} ms, "
          f"kernel {kernel_ms:.4f} ms, gap between its neighbours "
          f"{gap_ms:.4f} ms; backlog {row['backlog_ms']}")
    assert kernel_ms - 0.01 <= row["device_ms"] <= gap_ms + 0.01
    assert row["backlog_ms"] == 0.0


@pytest.mark.cuda
def test_a_unit_refills_the_event_pool_on_the_card():
    """Spans take their events from the pool; a unit span, when it
    closes, refills the pool with at least as many made events as it took,
    so the next unit records on those; `clear` returns the buffer's events
    to the pool, and a span kept elsewhere then reads no device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda.init()

    def unit():
        with trace.recording() as got:
            with trace.span("probe.unit", unit=True):
                with trace.span("probe.inner"):
                    torch.cuda._sleep(100_000)
        return got

    pool = trace._pool[torch.cuda.current_device()]
    first = unit()
    assert len(pool) >= 4
    made = {id(e) for e in pool}
    second = unit()
    assert {id(e) for s in second for e in s.events} <= made
    torch.cuda.synchronize()
    rows = trace.read(first + second)
    assert all(r["device_ms"] > 0 for r in rows)
    assert [r["name"] for r in rows] == ["probe.unit", "probe.inner"] * 2
    held = len(pool)
    trace.clear()
    assert len(pool) == held + 8
    assert all(r["device_ms"] is None for r in trace.read(first))
