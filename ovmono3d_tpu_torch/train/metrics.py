"""Training hooks: the metrics writer, the profiler window and the training
panels (counterpart of ovmono3d_tpu/train/metrics.py; the reference's
detectron2 EventStorage with its console, metrics.json and TensorBoard
writers and its visualize_training panels).

A hook is called as hook(step, state, metrics, batch=batch) after each
train step (train/loop.py) and closed at the end. `metrics` are device
tensors: reading one waits for the card, so `MetricsWriter` keeps them and
reads them only every METRICS_PERIOD steps, and `TrainVisHook` copies the
batch to the host only on its own steps.
"""
from __future__ import annotations

import json
import logging
import time
from collections import defaultdict, deque
from pathlib import Path

import numpy as np
import torch

from ovmono3d_tpu_torch.train.tb_writer import TBEventWriter
from ovmono3d_tpu_torch.utils import trace
from ovmono3d_tpu_torch.utils.geometry import backproject, cuboid_corners
from ovmono3d_tpu_torch.utils.util import imwrite_rgb
from ovmono3d_tpu_torch.vis.draw import draw_boxes_2d, draw_cuboid_3d

logger = logging.getLogger(__name__)

METRICS_PERIOD = 20       # steps between the writer's flushes
SMOOTHING = 20            # steps in the console line's moving mean
PROFILE_STEPS = (10, 15)  # the profiler's window, steps (start, stop]


class MetricsWriter:
    """Per-step scalars to `metrics.jsonl` (one line a flush: the step,
    it/s and the latest step's values), a console line with the smoothed
    total loss and skip rate, and TensorBoard scalars under `tb/`
    (`use_tensorboard`). Flushes every METRICS_PERIOD steps and at close."""

    def __init__(self, output_dir: str | Path, use_tensorboard: bool = False):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.dir / "metrics.jsonl", "a")
        self.history: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=SMOOTHING))
        self.tb = TBEventWriter(self.dir / "tb") if use_tensorboard else None
        self._last_flush = time.time()
        self._buffer: list[tuple[int, dict]] = []

    def __call__(self, step: int, state, metrics: dict, **_) -> None:
        self._buffer.append((step, metrics))
        if step % METRICS_PERIOD == 0:
            self._flush(step)

    def _flush(self, step: int) -> None:
        scalars = {}
        for _, m in self._buffer:
            vals = {}
            for k, v in m.items():
                try:
                    vals[k] = float(v)
                except (TypeError, ValueError):
                    continue
                self.history[k].append(vals[k])
            scalars = vals          # the latest step's values go on record
        # The steps since the last flush over their time (the JAX writer
        # divides `period`, which overstates a short last flush).
        rate = len(self._buffer) / max(time.time() - self._last_flush, 1e-9)
        self._buffer.clear()
        self._last_flush = time.time()
        self.jsonl.write(json.dumps({"step": step, "it_per_s": round(rate, 3),
                                     **scalars}) + "\n")
        self.jsonl.flush()
        smoothed = {k: sum(v) / len(v) for k, v in self.history.items() if v}
        headline = ", ".join(f"{k}={v:.4f}"
                             for k, v in sorted(smoothed.items())
                             if k in ("total_loss", "skipped"))
        logger.info("iter %d (%.2f it/s) %s", step, rate, headline)
        if self.tb is not None:
            self.tb.add_scalars(step, scalars)
            self.tb.flush()

    def close(self) -> None:
        """Flush the steps after the last period and close the files."""
        if self._buffer:
            self._flush(self._buffer[-1][0])
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class ProfilerHook:
    """torch.profiler over the steps PROFILE_STEPS = (start, stop] (the hook
    runs after a step), CPU activity and CUDA activity when there is a card;
    the trace goes to output_dir/profile/trace_<start>-<stop>.json (Chrome's
    format), where the port's spans (utils/trace.py) show as record
    functions. When the window closes it logs one line per span name, a
    step's count, host ms, device ms and backlog at entry, and writes the
    lines beside the trace as spans_<start>-<stop>.txt. A restart that
    rewinds past `start` opens no second window; training that ends inside
    the window closes it."""

    def __init__(self, output_dir: str | Path):
        self.dir = Path(output_dir) / "profile"
        self.start, self.stop = PROFILE_STEPS
        self._prof = None
        self._done = False

    def __call__(self, step: int, state, metrics: dict, **_) -> None:
        if step == self.start and self._prof is None and not self._done:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            trace.clear()
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            logger.info("profiler started at step %d -> %s", step, self.dir)
        elif step >= self.stop and self._prof is not None:
            self._finish()

    def _finish(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.dir.mkdir(parents=True, exist_ok=True)
        name = f"{self.start}-{self.stop}"
        path = self.dir / f"trace_{name}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        self._done = True
        logger.info("profiler trace written -> %s", path)
        lines = span_lines(trace.read())
        trace.clear()
        for line in lines:
            logger.info("%s", line)
        (self.dir / f"spans_{name}.txt").write_text(
            "".join(line + "\n" for line in lines))

    def close(self) -> None:
        if self._prof is not None:
            self._finish()


def span_lines(rows: list[dict]) -> list[str]:
    """One line per span name of `trace.read`'s rows: count, host ms and
    device ms a step (a unit span: train.step), and the mean backlog at
    entry ("-" off the card)."""
    def ms(v):
        return "-" if v is None else f"{v:.3f}"
    steps = max(len({r["unit"] for r in rows if r["unit"] is not None}), 1)
    out = [f"spans over {steps} steps: name count/step host_ms/step "
           "device_ms/step backlog_ms"]
    for name, s in trace.summarize(rows, steps).items():
        out.append(f"{name} {s['count'] / steps:g} {ms(s['host_ms'])} "
                   f"{ms(s['device_ms'])} {ms(s['backlog_ms'])}")
    return out


# The mapper's 3D row for a 2D-only annotation (no center_cam): drawing it
# would put a unit cube at the image origin. A real box never equals it.
_DEFAULT_3D_ROW = np.array([0, 0, 1, 1, 1, 1, 0, 0, 0], np.float32)


class TrainVisHook:
    """Every `period` steps, the batch's first image with its GT 2D boxes
    and the projected GT cuboids, to output_dir/vis/train_<step>.png and,
    with `tb`, to TensorBoard as "train/vis" (the reference's
    visualize_training, rcnn3d.py:119-250)."""

    KEYS = ("image", "K", "im_scale_ratio", "gt_boxes", "gt_classes",
            "gt_boxes3d", "gt_poses", "gt_valid")

    def __init__(self, output_dir: str | Path, period: int = 2320,
                 tb: TBEventWriter | None = None):
        self.dir = Path(output_dir) / "vis"
        self.period = max(period, 1)
        self.tb = tb

    def __call__(self, step: int, state, metrics: dict, batch=None) -> None:
        if batch is None or step % self.period != 0 or "gt_boxes" not in batch:
            return
        b = {k: np.asarray(torch.as_tensor(batch[k])[0].cpu())
             for k in self.KEYS if k in batch}
        img = np.clip(b["image"], 0, 255).astype(np.uint8)
        fg = b["gt_valid"].astype(bool) & (b["gt_classes"] >= 0)
        panel = draw_boxes_2d(img, b["gt_boxes"][fg],
                              labels=[str(c) for c in b["gt_classes"][fg]])
        # The cuboids project with the network-resolution K.
        K_net = b["K"] / float(b["im_scale_ratio"])
        K_net[2, 2] = 1.0
        g3d, poses = b["gt_boxes3d"], b["gt_poses"]
        has3d = ~np.all(g3d == _DEFAULT_3D_ROW, axis=-1)
        for i in np.flatnonzero(fg & has3d):
            K_t = torch.from_numpy(K_net.astype(np.float32))
            center = backproject(K_t, torch.from_numpy(g3d[i, :2]),
                                 torch.tensor(g3d[i, 2]))
            corners = cuboid_corners(
                torch.cat([center, torch.from_numpy(g3d[i, 3:6])]),
                torch.from_numpy(poses[i]))
            panel = draw_cuboid_3d(panel, corners.numpy(), K_net)
        out = self.dir / f"train_{step:07d}.png"
        imwrite_rgb(out, panel)
        if self.tb is not None:
            self.tb.add_image(step, "train/vis", panel)
            self.tb.flush()
        logger.info("train vis -> %s", out)
