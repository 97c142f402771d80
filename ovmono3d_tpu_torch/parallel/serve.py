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

import numpy as np
import torch

from ovmono3d_tpu_torch.models.gdino.inference import (BOX_THRESHOLD,
                                                       NMS_THRESHOLD,
                                                       build_text_inputs,
                                                       postprocess_grounding)
from ovmono3d_tpu_torch.models.gdino.model import GroundingDINO
from ovmono3d_tpu_torch.utils.device import (HostCopy, resolve_device,
                                             staged, to_device_async)

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


def make_lift_stream_fn(pipe, devices, per_device: int):
    """The data-parallel stream's chunk (JAX `make_lift_stream_fn`): run(rows,
    text) -> a `HostCopy` of the chunk's Detections fields, [n, ...] in input
    order.

    rows: up to len(devices) * per_device of `predict_stream`'s prepared
    rows (a staged uint8 image, K [3, 3], content (nh, nw), ratio); device d
    takes rows [d per_device, (d+1) per_device) on `pipe.replicas(devices)`'s
    pipeline there (the models copied once and kept against the source's
    weights, as the JAX package keeps its replicated parameters), uploads
    them without waiting, resizes them into uint8 canvases, normalizes those
    for the detector together, and runs `OVMono3DLift.run` on each in turn
    (the detector's tensor given, as for a canvas of its own). text:
    `_text_device_inputs`' dict, moved to each device. A partial chunk leaves
    the later devices less or nothing to do."""
    replicas = pipe.replicas(devices)
    side = pipe.cfg.model.backbone.square_pad

    def run(rows: list, text: dict) -> HostCopy:
        parts = []
        for d, rep in enumerate(replicas):
            share = rows[d * per_device:(d + 1) * per_device]
            if not share:
                break
            dev = rep.device
            K, hw, ratio = (to_device_async(staged(np.stack(
                [r[j] for r in share]).astype(dt)), dev)
                for j, dt in ((1, np.float32), (2, np.int32),
                              (3, np.float32)))
            t = {k: v.to(dev) for k, v in text.items()}
            with torch.inference_mode():
                canvases = torch.stack([
                    rep._stream_canvas(to_device_async(r[0], dev), side, r[2])
                    for r in share]).float()
                tensors = rep._gdino_normalize(canvases, hw)
            dets = [dict(rep.run({
                "canvas": canvases[i], "hw": hw[i:i + 1],
                "ratio": ratio[i:i + 1], "K": K[i:i + 1], "depth": None,
                "text": t, "gdino_tensor": tensors[i:i + 1],
                "box_scale": 1.0}).items()) for i in range(len(share))]
            parts.append({k: torch.stack([x[k] for x in dets])
                          for k in dets[0]})
        return HostCopy(parts)

    return run


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
