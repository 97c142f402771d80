"""Open-vocabulary serving over several devices (counterpart of
ovmono3d_tpu/parallel/serve.py).

The JAX package shards a batch over its mesh's `data` axis, one image per
chip, with the weights replicated. Here a list of `torch.device`s takes the
mesh's place: each device holds its own copy of the models (the caller's
modules themselves on their own device) and runs its share of the batch or
chunk, in input order. Nothing in the hot path crosses devices: each share's
results are read back into host memory behind an event on its card
(`utils.device.HostCopy`). Devices may repeat (several `cpu` entries split
the work the same way on the CPU).
"""
from __future__ import annotations

import copy
import types

import numpy as np
import torch

from ovmono3d_tpu_torch.models.gdino.inference import (BOX_THRESHOLD,
                                                       NMS_THRESHOLD,
                                                       build_text_inputs,
                                                       postprocess_grounding)
from ovmono3d_tpu_torch.models.gdino.model import GroundingDINO
from ovmono3d_tpu_torch.utils.device import (HostCopy, resolve_device,
                                             staged, to_device_async)
from ovmono3d_tpu_torch.utils.graphs import SpanGraphs, capture_stream
from ovmono3d_tpu_torch.utils.trace import span

TEXT_KEYS = ("input_ids", "text_mask", "text_self_mask", "position_ids",
             "span_matrix", "span_valid")


def make_gdino_serving_fn(model: GroundingDINO, devices, topk: int = 100):
    """run(images, text, im_hw, rel_biases=None) -> (boxes [N, k, 4] xyxy,
    scores, classes, valid [N, k]) in host memory, k = min(topk, queries).

    images: [N, S, S, 3] normalized (numpy or a CPU tensor), N a multiple of
    len(devices); device d runs images [d N/n, (d+1) N/n) as one batch on
    its copy of `model`, made here. text: `build_text_inputs`' dict (leading
    axis 1, broadcast over the batch); im_hw: [N, 2] per-image (h, w) the
    boxes are scaled to; rel_biases: one `backbone.rel_biases()` dict per
    device, on that device (None: each copy's own cached biases)."""
    devices = [resolve_device(d) for d in devices]
    home = model.level_embed.device
    copies = [model if d == home else copy.deepcopy(model).to(d)
              for d in devices]

    def run(images, text: dict, im_hw, rel_biases=None):
        images = torch.as_tensor(images)
        per = images.shape[0] // len(copies)
        im_hw = np.asarray(im_hw, np.float64)
        parts = []
        for d, (dev, gdino) in enumerate(zip(devices, copies)):
            x = to_device_async(staged(images[d * per:(d + 1) * per]), dev)
            t = {k: torch.as_tensor(np.asarray(text[k])).to(dev)
                 for k in TEXT_KEYS}
            b = x.shape[0]
            with torch.inference_mode():
                out = gdino(x, t["input_ids"].expand(b, -1),
                            t["text_mask"].expand(b, -1),
                            t["text_self_mask"].expand(b, -1, -1),
                            t["position_ids"].expand(b, -1),
                            rel_biases=(None if rel_biases is None
                                        else rel_biases[d]))
                res = [postprocess_grounding(
                    out["pred_logits"][i], out["pred_boxes"][i],
                    t["span_matrix"], t["span_valid"],
                    tuple(im_hw[d * per + i]), topk=topk,
                    box_threshold=BOX_THRESHOLD, nms_threshold=NMS_THRESHOLD)
                    for i in range(b)]
            parts.append({k: torch.stack([r[j] for r in res]) for j, k in
                          enumerate(("boxes", "scores", "classes", "valid"))})
        host = HostCopy(parts).wait()
        return host["boxes"], host["scores"], host["classes"], host["valid"]

    return run


# Chunk shares that make_lift_stream_fn's run replayed from graphs, captured
# into them and ran eagerly (a share: one device's rows of a chunk).
lift_stream_chunks = types.SimpleNamespace(replayed=0, captured=0, eager=0)


def make_lift_stream_fn(pipe, devices, per_device: int):
    """The data-parallel stream's chunk (JAX `make_lift_stream_fn`): run(rows,
    text) -> a `HostCopy` of the chunk's Detections fields, [n, ...] in input
    order.

    rows: up to len(devices) * per_device of `predict_stream`'s prepared
    rows (a staged uint8 image, K [3, 3], content (nh, nw), ratio, and a
    capture dict or None); device d
    takes rows [d per_device, (d+1) per_device) on `pipe.replicas(devices)`'s
    pipeline there (the models copied once and kept against the source's
    weights, as the JAX package keeps its replicated parameters), uploads
    them without waiting, resizes them into uint8 canvases, normalizes those
    for the detector together, and runs them as one batch
    (`OVMono3DLift.run_batch`, the detector's tensors given). text:
    `_text_device_inputs`' dict, moved to each device; the stream's prompt,
    the same at every call (the graphs keep the first). A partial chunk leaves
    the later devices less or nothing to do. A row's capture dict receives,
    on the device, its float canvas, hw [1, 2], K [1, 3, 3], ratio [1] and
    its row of `OVMono3DLift._detect_batch`'s trace. The chunk's dispatch
    is the unit span `stream.chunk`.

    On a card, a full share's work past the per-row resize has fixed shapes
    (rows, canvas, prompt length, queries, slots), so it is replayed from
    CUDA graphs (`_ChunkGraph`): a device's first full share runs eagerly
    and fills every lazy cache, the next is captured and replayed, and
    later ones write their rows into the graph's inputs and replay; the
    captured rows then receive device copies of what the replay computed.
    Partial shares and the CPU run eagerly. Each share counts once in
    `lift_stream_chunks`. `run.close()` frees the graphs and
    their memory pool."""
    replicas = pipe.replicas(devices)
    side = pipe.cfg.model.backbone.square_pad
    # Replica d -> None once a full share ran eagerly there, then its
    # _ChunkGraph.
    graphs: dict = {}

    def run(rows: list, text: dict) -> HostCopy:
        with span("stream.chunk", unit=True):
            return HostCopy(dispatch(rows, text))

    def dispatch(rows: list, text: dict) -> list:
        parts = []
        for d, rep in enumerate(replicas):
            share = rows[d * per_device:(d + 1) * per_device]
            if not share:
                break
            caps = [r[4] for r in share]
            if (rep.device.type != "cuda" or len(share) < per_device
                    or d not in graphs):
                if rep.device.type == "cuda" and len(share) == per_device:
                    graphs[d] = None
                lift_stream_chunks.eager += 1
                parts.append(eager(rep, share, text))
            elif graphs[d] is None:
                graphs[d] = _ChunkGraph(rep, share, text, side)
                lift_stream_chunks.captured += 1
                parts.append(graphs[d].replay(caps))
            else:
                graphs[d].fill(share)
                lift_stream_chunks.replayed += 1
                parts.append(graphs[d].replay(caps))
        return parts

    def eager(rep, share: list, text: dict) -> dict:
        dev = rep.device
        K, hw, ratio = (to_device_async(h, dev) for h in _row_fields(share))
        t = {k: v.to(dev) for k, v in text.items()}
        with torch.inference_mode():
            canvases = torch.stack([
                rep._stream_canvas(to_device_async(r[0], dev), side, r[2])
                for r in share]).float()
            tensors = rep._gdino_normalize(canvases, hw)
        caps = [r[4] for r in share]
        for i, cap in enumerate(caps):
            if cap is not None:
                cap.update(canvas=canvases[i], hw=hw[i:i + 1],
                           K=K[i:i + 1], ratio=ratio[i:i + 1])
        return dict(rep.run_batch(canvases, hw, ratio, K, t, tensors,
                                  caps).items())

    run.close = graphs.clear
    return run


def _row_fields(share: list) -> list[torch.Tensor]:
    """The rows' K [n, 3, 3], content sizes [n, 2] and ratios [n], staged."""
    return [staged(np.stack([r[j] for r in share]).astype(dt))
            for j, dt in ((1, np.float32), (2, np.int32), (3, np.float32))]


def _stacked_copies(rows: list[dict]) -> list[dict]:
    """Device copies of dicts of tensors with the same keys (nested dicts
    too): one stacked copy a key, each dict's its row of it."""
    out: list[dict] = [{} for _ in rows]
    for k, v in rows[0].items():
        parts = (_stacked_copies([r[k] for r in rows]) if isinstance(v, dict)
                 else torch.stack([r[k] for r in rows]).unbind(0))
        for o, p in zip(out, parts):
            o[k] = p
    return out


class _ChunkGraph:
    """One device's full share of the stream's chunk as CUDA graphs
    (`utils.graphs.SpanGraphs`, cut at the spans of `run_batch`): the uint8
    canvases, content sizes, ratios and K live in input buffers that the
    eager per-row prep writes into (`fill`), beside the prompt; the float
    canvases, the detector's tensors, `run_batch`, its Detections and each
    row's trace are captured. Made with a share's rows, it fills, captures
    once and is then replayed."""

    def __init__(self, rep, share: list, text: dict, side: int):
        dev, n = rep.device, len(share)
        self.rep, self.side = rep, side
        self.u8 = torch.empty(n, side, side, 3, dtype=torch.uint8, device=dev)
        self.K = torch.empty(n, 3, 3, device=dev)
        self.hw = torch.empty(n, 2, dtype=torch.int32, device=dev)
        self.ratio = torch.empty(n, device=dev)
        self.text = {k: v.to(dev) for k, v in text.items()}
        self.traces: list[dict] = [{} for _ in range(n)]
        self.fill(share)
        self.graphs = SpanGraphs()
        self.out = self.graphs.capture(self._body, capture_stream(dev))

    def fill(self, share: list) -> None:
        """The rows' uploads and canvases into the input buffers."""
        dev = self.rep.device
        for buf, host in zip((self.K, self.hw, self.ratio),
                             _row_fields(share)):
            buf.copy_(host, non_blocking=True)
        with torch.inference_mode():
            for i, r in enumerate(share):
                self.rep._stream_canvas(to_device_async(r[0], dev), self.side,
                                        r[2], out=self.u8[i])

    def _body(self) -> dict:
        with torch.inference_mode():
            canvases = self.u8.float()
            tensors = self.rep._gdino_normalize(canvases, self.hw)
            det = self.rep.run_batch(canvases, self.hw, self.ratio, self.K,
                                     self.text, tensors, self.traces)
        for i, tr in enumerate(self.traces):
            tr.update(canvas=canvases[i], hw=self.hw[i:i + 1],
                      K=self.K[i:i + 1], ratio=self.ratio[i:i + 1])
        return dict(det.items())

    def replay(self, caps: list) -> dict:
        """Runs the share; its captured rows receive copies of their traces.
        Returns the Detections fields, which the next replay overwrites."""
        self.graphs.replay()
        rows = [i for i, cap in enumerate(caps) if cap is not None]
        if rows:
            for i, got in zip(rows, _stacked_copies(
                    [self.traces[i] for i in rows])):
                caps[i].update(got)
        return self.out


def detect_open_vocabulary_batch(model: GroundingDINO, images, tok,
                                 categories: list[str], devices,
                                 topk: int = 100, run=None,
                                 rel_biases=None) -> dict:
    """Batched open-vocabulary detection over `devices` (JAX
    `detect_open_vocabulary_batch`): images [N, S, S, 3] normalized, padded
    with zero images to a multiple of len(devices), split, run and unpadded.
    Returns numpy {boxes [N, k, 4] in canvas pixels, scores, classes,
    valid}. Pass `run` (from `make_gdino_serving_fn`) to keep the device
    copies across calls, and `rel_biases` (one `backbone.rel_biases()` per
    device) to reuse precomputed Swin biases."""
    images = np.asarray(images, np.float32)
    N, S = images.shape[0], images.shape[1]
    pad = (-N) % len(devices)
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    text = build_text_inputs(tok, categories, max_len=model.max_text_len,
                             max_phrases=max(64, len(categories)))
    if run is None:
        run = make_gdino_serving_fn(model, devices, topk=topk)
    out = run(images, text, np.full((N + pad, 2), S, np.float32), rel_biases)
    return {k: v[:N].numpy()
            for k, v in zip(("boxes", "scores", "classes", "valid"), out)}
