"""The port's training hooks and what they write (train/tb_writer.py,
train/metrics.py, vis/draw.py, utils/util.py) against the JAX package's:
the event files' CRC32C on its published vectors, the round trip and the
header; an event file the port writes read by the JAX reader and one the
JAX writer writes read by the port; an image event's PNG decoding to the
panel's pixels; `MetricsWriter` reading no scalar between its flushes;
`TrainVisHook` writing its PNG and its TensorBoard image; the numpy
drawings of boxes and cuboids against the JAX package's cv2 ones: every
pixel either paints lies within one pixel (a 3 x 3 neighbourhood) of one
the other paints (labels left out), with and without z-clipping.
"""
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from ovmono3d_tpu.train import tb_writer as jtb
from ovmono3d_tpu.vis import draw as jdraw
from ovmono3d_tpu_torch.data.build import encode_png, read_png
from ovmono3d_tpu_torch.train import metrics as tmetrics
from ovmono3d_tpu_torch.train import tb_writer as ttb
from ovmono3d_tpu_torch.utils.util import get_color, imwrite_rgb
from ovmono3d_tpu_torch.vis import draw as tdraw

torch.set_num_threads(2)


def _event_file(logdir: Path) -> Path:
    (path,) = list(Path(logdir).glob("events.out.tfevents.*"))
    return path


def test_crc32c_vectors_round_trip_and_header(tmp_path):
    # RFC 3720 B.4 and the usual check value.
    assert ttb.crc32c(b"123456789") == 0xE3069283
    assert ttb.crc32c(bytes(32)) == 0x8A9136AA
    assert ttb.crc32c(bytes(range(32))) == 0x46DD794E
    assert ttb.crc32c(b"") == 0
    w = ttb.TBEventWriter(tmp_path)
    w.add_scalars(3, {"loss": 1.5, "lr": 0.25})
    w.add_scalars(7, {"loss": 0.5})
    w.add_scalars(8, {})
    w.close()
    events = ttb.read_events_full(_event_file(tmp_path))
    assert events[0] == (0, {}, {})           # the header record
    raw = _event_file(tmp_path).read_bytes()
    assert b"brain.Event:2" in raw[:64]
    assert ttb.read_events(_event_file(tmp_path)) == [
        (3, {"loss": 1.5, "lr": 0.25}), (7, {"loss": 0.5})]
    corrupt = bytearray(raw)
    corrupt[-6] ^= 0xFF
    (tmp_path / "bad").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="crc"):
        ttb.read_events(tmp_path / "bad")


def test_event_files_cross_read_with_the_jax_package(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (9, 13, 3), np.uint8)
    for writer, reader, image_reader, d in (
            (ttb.TBEventWriter, jtb.read_events, jtb.read_image_events, "p"),
            (jtb.TBEventWriter, ttb.read_events, ttb.read_image_events, "j")):
        w = writer(tmp_path / d)
        w.add_scalars(1, {"a": 2.0, "b/c": -0.125})
        w.add_image(2, "train/vis", rgb)
        w.close()
        path = _event_file(tmp_path / d)
        assert reader(path) == [(1, {"a": 2.0, "b/c": -0.125})]
        ((step, images),) = image_reader(path)
        img = images["train/vis"]
        assert step == 2 and (img["height"], img["width"]) == (9, 13)
        assert img["colorspace"] == 3
        # Both encoders' PNGs decode to the panel's pixels.
        decoded = cv2.imdecode(np.frombuffer(img["png"], np.uint8),
                               cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(decoded, rgb)
        (tmp_path / f"{d}.png").write_bytes(img["png"])
        np.testing.assert_array_equal(read_png(tmp_path / f"{d}.png"), rgb)


class _Lazy:
    """A device scalar stand-in that counts its reads."""
    reads = 0

    def __init__(self, v):
        self.v = v

    def __float__(self):
        _Lazy.reads += 1
        return self.v


def test_metrics_writer_reads_scalars_only_when_it_flushes(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(tmetrics, "METRICS_PERIOD", 4)
    w = tmetrics.MetricsWriter(tmp_path, use_tensorboard=True)
    _Lazy.reads = 0
    for step in range(1, 10):
        w(step, None, {"total_loss": _Lazy(1.0 / step), "skipped": _Lazy(0.0),
                       "note": "text"})
        assert _Lazy.reads == 2 * 4 * (step // 4), step
    w.close()                                   # flushes step 9
    assert _Lazy.reads == 18
    lines = [json.loads(s) for s in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [4, 8, 9]
    assert lines[0]["total_loss"] == pytest.approx(0.25)
    assert "note" not in lines[0]
    scalars = ttb.read_events(_event_file(tmp_path / "tb"))
    assert [s for s, _ in scalars] == [4, 8, 9]


def test_train_vis_hook_writes_png_and_tensorboard_image(tmp_path):
    tb = ttb.TBEventWriter(tmp_path / "tb")
    hook = tmetrics.TrainVisHook(tmp_path, period=2, tb=tb)
    K = torch.tensor([[100.0, 0, 48], [0, 100, 40], [0, 0, 1]]).repeat(
        2, 1, 1)
    batch = {
        "image": torch.full((2, 80, 96, 3), 30.0),
        "K": K, "im_scale_ratio": torch.ones(2),
        "gt_boxes": torch.tensor([[[10.0, 10, 50, 40], [0, 0, 1, 1]]] * 2),
        "gt_classes": torch.tensor([[3, -1]] * 2),
        "gt_boxes3d": torch.tensor([[[48.0, 40, 5, 1, 1, 1, 0, 0, 5],
                                     [0, 0, 1, 1, 1, 1, 0, 0, 0]]] * 2),
        "gt_poses": torch.eye(3).expand(2, 2, 3, 3),
        "gt_valid": torch.tensor([[True, True]] * 2),
    }
    hook(1, None, {}, batch=batch)
    assert not (tmp_path / "vis").exists()      # not its step
    hook(2, None, {}, batch=batch)
    tb.close()
    panel = read_png(tmp_path / "vis" / "train_0000002.png")
    assert panel.shape == (80, 96, 3)
    assert (panel != 30).any(axis=-1).sum() > 100     # boxes were drawn
    ((step, images),) = ttb.read_image_events(_event_file(tmp_path / "tb"))
    assert step == 2
    (tmp_path / "tb.png").write_bytes(images["train/vis"]["png"])
    np.testing.assert_array_equal(read_png(tmp_path / "tb.png"), panel)


def _near(a: np.ndarray, b: np.ndarray) -> bool:
    """Every painted pixel of `a` has a painted pixel of `b` in its 3 x 3
    neighbourhood."""
    grown = cv2.dilate(b.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0
    return bool(np.all(grown[a]))


def _painted(img: np.ndarray) -> np.ndarray:
    return img.any(axis=-1)


BOXES = np.array([[5.2, 7.9, 60.4, 41.0], [30, 20, 90.6, 70.2],
                  [-10, 50, 20, 95], [70, 3, 71, 4]], np.float32)
K = np.array([[120.0, 0, 50], [0, 120, 40], [0, 0, 1]])


def _cuboid(center, dims, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    signs = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]]) / 2
    return (signs * dims) @ R.T + center


@pytest.mark.parametrize("case", ["boxes", "cuboid", "cuboid_clipped"])
def test_drawings_lie_within_a_pixel_of_cv2(case):
    canvas = np.zeros((96, 112, 3), np.uint8)
    if case == "boxes":
        got = tdraw.draw_boxes_2d(canvas, BOXES)
        want = jdraw.draw_boxes_2d(canvas, BOXES)
    else:
        center = [0.3, 0.1, 4.0] if case == "cuboid" else [0.2, 0.0, 0.6]
        corners = _cuboid(np.array(center), np.array([1.2, 0.8, 2.0]), 0.4)
        if case == "cuboid_clipped":
            z = corners[:, 2]
            assert (z <= 0.05).any() and (z > 0.05).any()
        got = tdraw.draw_cuboid_3d(canvas, corners, K)
        want = jdraw.draw_cuboid_3d(canvas, corners, K)
    pg, pw = _painted(got), _painted(want)
    assert pg.sum() > 50 and pw.sum() > 50
    assert _near(pg, pw) and _near(pw, pg)
    assert not canvas.any()                       # drawn on a copy


def test_labels_colors_and_writer(tmp_path):
    canvas = np.zeros((40, 80, 3), np.uint8)
    out = tdraw.draw_boxes_2d(canvas, BOXES[:1], labels=["7"],
                              scores=np.array([0.5]))
    no_text = tdraw.draw_boxes_2d(canvas, BOXES[:1])
    assert (_painted(out) & ~_painted(no_text)).sum() > 20   # the label
    assert tuple(out[8, 30]) == get_color(0)
    from ovmono3d_tpu.utils.util import get_color as jax_get_color

    for i in (0, 5, 17, 40):
        for jitter in (False, True):
            assert get_color(i, jitter) == jax_get_color(i, jitter)
    imwrite_rgb(tmp_path / "a" / "b.png", out)
    np.testing.assert_array_equal(read_png(tmp_path / "a" / "b.png"), out)
    assert encode_png(out)[:8] == b"\x89PNG\r\n\x1a\n"


def test_profiler_hook_logs_the_spans_of_its_window(tmp_path, caplog):
    """Steps 11-15 under the profiler: the Chrome trace shows the spans,
    and the hook logs and writes one line per span name, a step's count,
    host ms, device ms and backlog ("-" off the card)."""
    from ovmono3d_tpu_torch.utils import trace
    hook = tmetrics.ProfilerHook(tmp_path)
    start, stop = tmetrics.PROFILE_STEPS
    caplog.set_level("INFO", logger=tmetrics.__name__)
    for step in range(1, stop + 2):
        with trace.span("train.step", unit=True):
            for _ in range(2):
                with trace.span("model.probe"):
                    torch.ones(8).sum()
        hook(step, None, {})
    hook.close()
    assert trace.read() == []
    name = f"{start}-{stop}"
    chrome = json.loads((tmp_path / "profile" /
                         f"trace_{name}.json").read_text())
    names = [e.get("name") for e in chrome["traceEvents"]]
    assert names.count("train.step") == stop - start
    assert names.count("model.probe") == 2 * (stop - start)
    lines = (tmp_path / "profile" / f"spans_{name}.txt").read_text()
    lines = lines.splitlines()
    assert lines[0].startswith(f"spans over {stop - start} steps")
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:]}
    assert list(rows) == ["train.step", "model.probe"]
    assert rows["model.probe"][0] == "2"
    assert float(rows["train.step"][1]) >= float(rows["model.probe"][1])
    if not torch.cuda.is_initialized():
        assert rows["train.step"][2:] == ["-", "-"]
    logged = [r.getMessage() for r in caplog.records]
    assert all(ln in logged for ln in lines)
