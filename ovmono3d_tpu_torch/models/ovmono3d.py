"""OVMono3D-LIFT open-vocabulary serving in PyTorch: text prompts -> 3D
cuboids.

Counterpart of ovmono3d_tpu/models/ovmono3d.py, the reference's
ROIHeads3DGDINO at inference (roi_heads_gdino.py:93-171):

  1. GroundingDINO on the ImageNet-normalized canvas with the ' . '-joined
     category caption -> open-vocabulary 2D boxes, classes and scores;
  2. the RCNN3D cube branch on those boxes (the oracle path) -> camera-space
     cuboids scored sqrt(s2d * conf).

`build` gives GroundingDINO the cube model's own square canvas (the
reference passes it the detectron2-preprocessed image): the shortest edge
resized to INPUT.MIN_SIZE_TEST (at most MAX_SIZE_TEST), placed top-left on
the square pad, so a 640x480 frame becomes 709x532 content on 896^2. The
detector's tensor is that canvas normalized where there is content and 0 in
the padding. The JAX package's fused and two-stage programs are one eager
path here: `prepare` uploads the image, K and the prompt and resizes on the
card, and `run` then detects, postprocesses and lifts without a host
synchronisation in between. Empty prompts give all-invalid slots (the
reference's empty-Instances fallback).

Resizing is F.interpolate bilinear (half-pixel, no antialias), cv2's
INTER_LINEAR. Entry points run on the card unless given a CPU device.

`predict_stream` and `detect_2d_stream` serve a sequence of images in
chunks, with one chunk in flight (`_stream_drive`): the host stages the next
chunk's images in page-locked memory while the card runs the current one,
uploads and reads back without waiting, and resizes on the card into uint8
canvases, as the JAX streams quantize theirs. `predict_stream(devices=...)`
splits each chunk over several devices (`parallel/serve.py`). Released
GroundingDINO weights load into `pipe.gdino` in place with
`utils.load.load_gdino_params(pipe.gdino, path)` (and the cube model's with
`load_rcnn_params(pipe.rcnn, path, cfg.model)`); the Swin bias cache and
`replicas` follow the weights' versions, so a load after serving takes
effect.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools

import numpy as np
import torch

from ovmono3d_tpu_torch.config import Config
from ovmono3d_tpu_torch.models.gdino.inference import (build_text_inputs,
                                                       postprocess_grounding)
from ovmono3d_tpu_torch.models.gdino.model import GroundingDINO
from ovmono3d_tpu_torch.models.gdino.tokenizer import BertTokenizer
from ovmono3d_tpu_torch.models.layers import init_seeded
from ovmono3d_tpu_torch.models.rcnn3d import RCNN3D, build_model
from ovmono3d_tpu_torch.structures import Detections
from ovmono3d_tpu_torch.utils.device import (HostCopy, device_constant,
                                             disable_tf32, resolve_device,
                                             staged, to_device_async)
from ovmono3d_tpu_torch.utils.image import (resize_bilinear,
                                            resize_shortest_edge)
from ovmono3d_tpu_torch.utils.trace import span, stages

# GroundingDINO's preprocessing: ImageNet statistics of 0-1 images.
GDINO_MEAN = (0.485, 0.456, 0.406)
GDINO_STD = (0.229, 0.224, 0.225)
# `predict`'s stages, the spans its trace reports.
SERVE_STAGES = ("canvas", "text", "gdino", "postprocess", "lift")


def build_gdino(gdino_kwargs: dict | None = None, device=None,
                seed: int = 0) -> GroundingDINO:
    """GroundingDINO (the SwinB configuration unless `gdino_kwargs` say
    otherwise) in eval mode, its weights drawn from torch.Generator(seed) on
    the CPU and moved to `device` (CUDA unless the caller asks for another;
    "meta" gives shapes only). On CUDA it turns TF32 off for matmuls and
    cuDNN (`utils.device.disable_tf32`): the f32 input projections and
    BERT feed a discrete top-900 selection."""
    device = resolve_device(device)
    disable_tf32(device)
    model = GroundingDINO(**(gdino_kwargs or {}), device="meta")
    if device.type == "meta":
        return model.eval()
    return init_seeded(model, seed).to(device).eval()


@dataclasses.dataclass
class OVMono3DLift:
    """GroundingDINO and the cube model, with the tokenizer, for end-to-end
    inference (the cube model and config are None for a detector-only
    pipeline)."""

    cfg: Config | None
    rcnn: RCNN3D | None
    gdino: GroundingDINO
    tokenizer: BertTokenizer
    gdino_size: int = 800   # the detector's square input side
    # ResizeShortestEdge(min, max) for the content on the detector's canvas
    # (None: the longest side to the canvas).
    gdino_min_size: int | None = None
    gdino_max_size: int | None = None
    # 2D slots: every box past threshold and NMS is lifted (the reference
    # keeps them all, roi_heads_gdino.py:252-257), so the final ranking is on
    # the fused score.
    detect_topk: int = 300
    # {devices: (weights' stamp, pipelines)}: `replicas`' copies.
    _replicas: dict = dataclasses.field(default_factory=dict, init=False,
                                        repr=False, compare=False)

    @classmethod
    def build(cls, cfg: Config, tokenizer: BertTokenizer,
              gdino_kwargs: dict | None = None, gdino_size: int | None = None,
              priors: dict | None = None, device=None,
              seed: int = 0) -> "OVMono3DLift":
        """Both models with weights from seeds (`seed` for the cube model,
        `seed + 1` for GroundingDINO), on `device`. `gdino_size` defaults to
        the cube model's square pad: the reference runs the detector on the
        same canvas. `priors` as `rcnn3d.build_model` takes them. On CUDA
        both builders turn TF32 off for matmuls and cuDNN
        (`utils.device.disable_tf32`)."""
        device = resolve_device(device)
        if gdino_size is None:
            gdino_size = cfg.model.backbone.square_pad
        rcnn = build_model(cfg.model, priors=priors, device=device,
                           seed=seed).eval()
        gdino = build_gdino(gdino_kwargs, device, seed + 1)
        return cls(cfg, rcnn, gdino, tokenizer, gdino_size=gdino_size,
                   gdino_min_size=cfg.input.min_size_test,
                   gdino_max_size=cfg.input.max_size_test)

    @classmethod
    def build_2d_only(cls, tokenizer: BertTokenizer,
                      gdino_kwargs: dict | None = None, gdino_size: int = 800,
                      device=None, seed: int = 1) -> "OVMono3DLift":
        """Detector only (no cube model): serves `detect_2d`. On CUDA,
        `build_gdino` turns TF32 off (`utils.device.disable_tf32`)."""
        return cls(None, None, build_gdino(gdino_kwargs, device, seed),
                   tokenizer, gdino_size=gdino_size)

    @property
    def device(self) -> torch.device:
        return self.gdino.level_embed.device

    def replicas(self, devices) -> list["OVMono3DLift"]:
        """This pipeline on each of `devices`: itself where its models are,
        else a copy of both models on that device. The copies are made once
        and kept until a weight of the models changes (its storage or, in
        place, its version)."""
        devices = tuple(resolve_device(d) for d in devices)
        modules = [m for m in (self.gdino, self.rcnn) if m is not None]
        stamp = tuple((t.data_ptr(), t._version) for t in itertools.chain(
            *(m.parameters() for m in modules),
            *(m.buffers() for m in modules)))
        cached = self._replicas.get(devices)
        if cached is None or cached[0] != stamp:
            def on(dev):
                if dev == self.device:
                    return self
                return dataclasses.replace(
                    self, gdino=copy.deepcopy(self.gdino).to(dev),
                    rcnn=(None if self.rcnn is None
                          else copy.deepcopy(self.rcnn).to(dev)))
            cached = (stamp, [on(d) for d in devices])
            self._replicas[devices] = cached
        return cached[1]

    # -- host preparation ---------------------------------------------------

    def _gdino_content_geometry(self, h: int, w: int
                                ) -> tuple[int, int, float]:
        """(nh, nw, scale) of the content on the detector's canvas: the
        ResizeShortestEdge(min, max) rule when gdino_min_size is set, capped
        to the canvas, else the longest side to the canvas; rounded half up
        like detectron2's int(x + 0.5)."""
        S = self.gdino_size
        if self.gdino_min_size:
            scale = self.gdino_min_size / min(h, w)
            max_size = self.gdino_max_size or S
            if max(h, w) * scale > max_size:
                scale = max_size / max(h, w)
            scale = min(scale, S / max(h, w))
        else:
            scale = S / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        return min(nh, S), min(nw, S), scale

    def _upload(self, x, dtype=None) -> torch.Tensor:
        """An array (numpy, tensor or nested lists) on the device."""
        return torch.as_tensor(np.array(x), dtype=dtype).to(self.device)

    def _prep_gdino_image(self, image) -> tuple[torch.Tensor, float]:
        """The detector's tensor [1, S, S, 3]: the resized 0-1 content,
        normalized, on a zero canvas; and the scale original -> canvas."""
        S = self.gdino_size
        h, w = image.shape[:2]
        nh, nw, scale = self._gdino_content_geometry(h, w)
        resized = resize_bilinear(self._upload(image).float() / 255.0,
                                  (nh, nw))
        tensor = torch.zeros(1, S, S, 3, device=self.device)
        tensor[0, :nh, :nw] = ((resized - device_constant(GDINO_MEAN,
                                                          self.device))
                               / device_constant(GDINO_STD, self.device))
        return tensor, scale

    def _prep_lift_canvas(self, image) -> tuple[torch.Tensor,
                                                tuple[int, int], float]:
        """Shortest-edge resize and top-left square pad for the cube model:
        (canvas [S, S, 3] f32 raw pixels, (nh, nw), scale)."""
        S = self.cfg.model.backbone.square_pad
        h, w = image.shape[:2]
        nh, nw, scale = resize_shortest_edge(
            (h, w), self.cfg.input.min_size_test,
            min(self.cfg.input.max_size_test, S))
        canvas = torch.zeros(S, S, 3, device=self.device)
        canvas[:nh, :nw] = resize_bilinear(self._upload(image).float(),
                                           (nh, nw))
        return canvas, (nh, nw), scale

    def _gdino_normalize(self, canvas: torch.Tensor, hw: torch.Tensor
                         ) -> torch.Tensor:
        """canvas [B, S, S, 3] raw pixels, hw [B, 2] content (nh, nw) ->
        (x / 255 - mean) / std on the content, exactly 0 in the padding."""
        S = canvas.shape[1]
        ar = torch.arange(S, device=canvas.device)
        content = ((ar[None, :, None] < hw[:, 0, None, None])
                   & (ar[None, None, :] < hw[:, 1, None, None]))
        norm = ((canvas / 255.0 - device_constant(GDINO_MEAN, canvas.device))
                / device_constant(GDINO_STD, canvas.device))
        return torch.where(content[..., None], norm, 0.0)

    def _text_device_inputs(self, categories: list[str]) -> dict:
        """The prompt tokenized at max_text_len, cut to the smallest power of
        two >= its length from 32 up (the reference runs the caption's own
        length), uploaded without a host synchronisation."""
        full = self.gdino.max_text_len
        text = build_text_inputs(self.tokenizer, categories, max_len=full,
                                 max_phrases=max(64, len(categories)))
        n_tok = int(text["text_mask"][0].sum())
        T = 32
        while T < n_tok and T < full:
            T *= 2
        T = min(T, full)
        cut = {"input_ids": text["input_ids"][:, :T],
               "text_mask": text["text_mask"][:, :T],
               "text_self_mask": text["text_self_mask"][:, :T, :T],
               "position_ids": text["position_ids"][:, :T],
               "span_matrix": text["span_matrix"],
               "span_valid": text["span_valid"]}
        return {k: to_device_async(staged(v), self.device)
                for k, v in cut.items()}

    # -- device stages --------------------------------------------------------

    def _empty_2d(self) -> dict:
        k = self.detect_topk
        return {"boxes": torch.zeros(k, 4, device=self.device),
                "scores": torch.zeros(k, device=self.device),
                "classes": torch.zeros(k, dtype=torch.int32,
                                       device=self.device),
                "valid": torch.zeros(k, dtype=torch.bool, device=self.device)}

    def _detect(self, tensor: torch.Tensor, text: dict,
                trace: dict | None = None) -> dict:
        """`_detect_batch` of one image's tensor [1, S, S, 3]: its 2D slots
        with the batch axis dropped."""
        det = self._detect_batch(tensor, text, [trace])
        return {k: v[0] for k, v in det.items()}

    def _detect_batch(self, tensors: torch.Tensor, text: dict,
                      traces: list | None = None) -> dict:
        """GroundingDINO on a batch of the detector's tensors [B, S, S, 3],
        the prompt broadcast over it, and the batch's postprocess (spans
        "gdino" and "postprocess"): {boxes [B, k, 4] in canvas pixels,
        scores, classes, valid}. `traces`, B dicts or Nones, keeps in each
        row's dict its raw pred_logits and pred_boxes, the selected
        query_index, the encoded prompt (text_features), the encoder's and
        the decoder's outputs (memory, hs) and its 2D slots (`slots`)."""
        b = tensors.shape[0]
        with span("gdino"):
            out = self.gdino(tensors, text["input_ids"].expand(b, -1),
                             text["text_mask"].expand(b, -1),
                             text["text_self_mask"].expand(b, -1, -1),
                             text["position_ids"].expand(b, -1))
        with span("postprocess"):
            S = float(self.gdino_size)
            det = dict(zip(("boxes", "scores", "classes", "valid"),
                           postprocess_grounding(
                               out["pred_logits"], out["pred_boxes"],
                               text["span_matrix"], text["span_valid"],
                               (S, S), topk=self.detect_topk)))
        for i, trace in enumerate(traces or ()):
            if trace is not None:
                trace.update({k: out[k][i] for k in (
                    "pred_logits", "pred_boxes", "query_index",
                    "text_features", "memory", "hs")},
                    slots={k: v[i] for k, v in det.items()})
        return det

    def detect_2d(self, image, categories: list[str]) -> dict:
        """Open-vocabulary 2D detection; numpy boxes in original image
        pixels."""
        if not categories:
            det = self._empty_2d()
            scale = 1.0
        else:
            text = self._text_device_inputs(categories)
            tensor, scale = self._prep_gdino_image(image)
            with torch.inference_mode():
                det = self._detect(tensor, text)
        out = {k: v.cpu().numpy() for k, v in det.items()}
        out["boxes"] = out["boxes"] / scale
        return out

    def _lift(self, canvas, hw, ratio, K, det2d: dict, box_scale: float,
              depth=None) -> Detections:
        """The cube model on `det2d`'s boxes times `box_scale` (canvas
        pixels): Detections with the batch axis dropped."""
        det = self._lift_batch(canvas[None], hw, ratio, K,
                               {k: v[None] for k, v in det2d.items()},
                               box_scale, depth)
        return Detections(**{k: v[0] for k, v in det.items()})

    def _lift_batch(self, canvases, hw, ratio, K, det2d: dict,
                    box_scale: float, depth=None) -> Detections:
        """The cube model on a batch: canvases [B, S, S, 3], hw [B, 2],
        ratio [B], K [B, 3, 3] and `det2d`'s fields [B, k, ...], its boxes
        times `box_scale` (canvas pixels)."""
        return self.rcnn(canvases, K, hw, ratio, depth,
                         oracle_boxes=det2d["boxes"] * box_scale,
                         oracle_classes=det2d["classes"],
                         oracle_scores=det2d["scores"],
                         oracle_valid=det2d["valid"])

    def lift_3d(self, image, K, det2d: dict, depth=None) -> Detections:
        """The cube branch on given 2D detections (boxes, classes, scores,
        valid; boxes in original pixels)."""
        req = self.prepare(image, K, [], depth)
        dtypes = {"boxes": torch.float32, "classes": torch.int32,
                  "scores": torch.float32, "valid": torch.bool}
        det2d = {k: self._upload(det2d[k], dt) for k, dt in dtypes.items()}
        with torch.inference_mode():
            return self._lift(req["canvas"], req["hw"], req["ratio"],
                              req["K"], det2d, req["box_scale"],
                              req["depth"])

    def _fusable(self) -> bool:
        """True when detection and lift read the same square canvas: the
        cube model is there, the detector's side is its square pad, and
        both use the same ResizeShortestEdge rule (always so after
        `build`)."""
        return (self.rcnn is not None and self.cfg is not None
                and self.gdino_size == self.cfg.model.backbone.square_pad
                and self.gdino_min_size == self.cfg.input.min_size_test
                and self.gdino_max_size == self.cfg.input.max_size_test)

    def prepare(self, image, K, categories: list[str],
                depth=None) -> dict:
        """Everything `run` needs on the device: the cube model's canvas
        (uploaded and resized here), its content size and ratio, K, the
        prompt's tensors and, when the detector does not share the canvas,
        its own tensor. Uploads end here: the image's, K's and the
        content size's synchronise the host with the card (the prompt's do
        not). Spans "canvas" and "text"."""
        dev = self.device
        with span("canvas"):
            canvas, (nh, nw), scale = self._prep_lift_canvas(image)
            req = {"canvas": canvas,
                   "hw": torch.tensor([[nh, nw]], dtype=torch.int32,
                                      device=dev),
                   "ratio": torch.tensor([1.0 / scale], device=dev),
                   "K": self._upload(K, torch.float32)[None],
                   "depth": (None if depth is None else self._upload(
                       depth, torch.float32)[None, ..., None]),
                   "text": None, "gdino_tensor": None, "box_scale": scale}
            if categories and not self._fusable():
                req["gdino_tensor"], gscale = self._prep_gdino_image(image)
                req["box_scale"] = scale / gscale
            elif categories:
                req["box_scale"] = 1.0
        with span("text"):
            if categories:
                req["text"] = self._text_device_inputs(categories)
        return req

    def run(self, req: dict, trace: dict | None = None) -> Detections:
        """Detection, postprocess and lift of a prepared request (spans
        "gdino", "postprocess", "lift"), with no host synchronisation.
        Given `trace`, keeps the detector's raw outputs and 2D slots there
        (`_detect`)."""
        with torch.inference_mode():
            if req["text"] is None:
                det2d = self._empty_2d()
            else:
                tensor = req["gdino_tensor"]
                if tensor is None:
                    tensor = self._gdino_normalize(req["canvas"][None],
                                                   req["hw"])
                det2d = self._detect(tensor, req["text"], trace)
            with span("lift"):
                det = self._lift(req["canvas"], req["hw"], req["ratio"],
                                 req["K"], det2d, req["box_scale"],
                                 req["depth"])
        return det

    def run_batch(self, canvases, hw, ratio, K, text: dict, tensors,
                  traces: list | None = None) -> Detections:
        """`run` over a batch of fused requests that share a prompt, as one
        batch through the detector and one through the cube model (spans
        "gdino", "postprocess", "lift"), with no host synchronisation:
        canvases [B, S, S, 3], hw [B, 2], ratio [B], K [B, 3, 3], the
        detector's tensors [B, S, S, 3]; Detections with the batch axis.
        `traces` as `_detect_batch` takes them."""
        with torch.inference_mode():
            det2d = self._detect_batch(tensors, text, traces)
            with span("lift"):
                return self._lift_batch(canvases, hw, ratio, K, det2d, 1.0)

    # -- streams --------------------------------------------------------------

    def _stream_canvas(self, image: torch.Tensor, side: int,
                       hw: tuple[int, int], out: torch.Tensor | None = None
                       ) -> torch.Tensor:
        """A stream's uint8 canvas [side, side, 3]: `image` (on the device)
        resized to hw = (nh, nw), rounded half to even and clipped to 0..255
        (the JAX streams' np.clip(np.rint(...))), top-left on zeros; written
        into `out` when given."""
        canvas = (torch.zeros(side, side, 3, dtype=torch.uint8,
                              device=image.device) if out is None
                  else out.zero_())
        resized = resize_bilinear(image.float(), hw).round().clamp(0, 255)
        canvas[:hw[0], :hw[1]] = resized.to(torch.uint8)
        return canvas

    @staticmethod
    def _stream_drive(items, prep, dispatch, emit, chunk: int):
        """The streams' chunk loop (JAX `_stream_drive`): prep(item) -> a
        row of host values; dispatch(rows) -> a handle on a chunk's work,
        enqueued on the device without waiting; emit(handle) -> its
        results, one per row. Exactly one chunk is in flight: while the
        device runs chunk i the host preps chunk i+1, dispatches it, and
        only then reads chunk i. A partial last chunk is dispatched with its
        own rows, unpadded."""
        rows: list = []
        pending = None
        for item in items:
            rows.append(prep(item))
            if len(rows) == chunk:
                done, pending = pending, dispatch(rows)
                rows = []
                if done is not None:
                    yield from emit(done)
        if rows:
            done, pending = pending, dispatch(rows)
            if done is not None:
                yield from emit(done)
        if pending is not None:
            yield from emit(pending)

    def detect_2d_stream(self, images, categories: list[str],
                         chunk: int = 8):
        """Open-vocabulary 2D detection over a sequence of images: yields
        `detect_2d`-shaped numpy dicts, boxes in original pixels. The
        prompt is tokenized once; each chunk's images are staged in
        page-locked memory, uploaded without waiting, resized on the card
        into uint8 canvases of the detector's side, normalized and detected
        together as one batch (`_detect_batch`) and read back behind an
        event. Serves `build_2d_only` pipelines. With no
        categories it is per-image `detect_2d`, as in the JAX package."""
        if not categories:
            for image in images:
                yield self.detect_2d(image, [])
            return
        text = self._text_device_inputs(categories)
        dev, side = self.device, self.gdino_size

        def prep(image):
            nh, nw, scale = self._gdino_content_geometry(*image.shape[:2])
            return staged(image), (nh, nw), scale

        def dispatch(rows):
            hws = to_device_async(staged(np.array(
                [hw for _, hw, _ in rows], np.int32)), dev)
            with torch.inference_mode():
                tensors = self._gdino_normalize(torch.stack([
                    self._stream_canvas(to_device_async(image, dev), side, hw)
                    for image, hw, _ in rows]).float(), hws)
                det = self._detect_batch(tensors, text)
            return HostCopy([det]), [r[2] for r in rows]

        def emit(handle):
            copied, scales = handle
            host = copied.wait()
            for i, scale in enumerate(scales):
                out = {k: v[i].numpy() for k, v in host.items()}
                out["boxes"] = out["boxes"] / scale
                yield out

        yield from self._stream_drive(images, prep, dispatch, emit, chunk)

    def predict_stream(self, items, categories: list[str], chunk: int = 8,
                       devices=None, capture=None):
        """Prompts -> 3D cuboids over a sequence of (image, K) pairs: yields
        one Detections in host memory per image (`detect_topk` slots, boxes
        in original pixels). The prompt is tokenized once; each chunk's
        images and K / content-size / ratio rows are staged in page-locked
        memory and uploaded without waiting; the card resizes each image
        into a uint8 canvas (as the JAX stream quantizes it, so the stream
        equals per-image `predict` only at resize scale 1), normalizes the
        chunk's canvases for the detector together and runs the chunk as
        one batch (`run_batch`: one detector, postprocess and cube-model
        batch; per image the same as `run`), so the host
        enqueues a chunk's operations once and not once an image; on a card
        every full chunk after the first replays CUDA graphs of that work
        (`make_lift_stream_fn`), freed when the stream ends or is closed;
        the chunk is read back behind an event. With
        `devices` (a list; `chunk` a multiple of its length) device d takes
        the chunk's d-th share, on its own copy of the models
        (`parallel.serve.make_lift_stream_fn`). `capture(i)`, when given,
        is asked for each item's index i in the stream and may return a
        dict, which that row's run fills on the device with its canvas,
        content size, K and ratio and what `run`'s trace keeps
        (`_detect_batch`:
        the detector's raw outputs, query_index, text_features, memory, hs
        and 2D slots), without changing what the stream computes. Non-fusable
        configurations and empty prompts are per-image `predict`, as in the
        JAX package (a capture there takes `predict`'s trace); depth prompts
        are not taken (use `predict`)."""
        if not (categories and self._fusable()):
            for i, (image, K) in enumerate(items):
                trace = None if capture is None else capture(i)
                det = self.predict(image, K, categories, trace=trace)
                yield Detections(**{k: v.cpu() for k, v in det.items()})
            return
        from ovmono3d_tpu_torch.parallel.serve import make_lift_stream_fn

        devices = [self.device] if devices is None else list(devices)
        if chunk % len(devices):
            raise ValueError(f"chunk {chunk} is not a multiple of the "
                             f"{len(devices)} devices")
        run = make_lift_stream_fn(self, devices, chunk // len(devices))
        text = self._text_device_inputs(categories)
        side = self.cfg.model.backbone.square_pad

        def prep(item):
            i, (image, K) = item
            nh, nw, scale = resize_shortest_edge(
                image.shape[:2], self.cfg.input.min_size_test,
                min(self.cfg.input.max_size_test, side))
            return (staged(image), np.asarray(K, np.float32), (nh, nw),
                    np.float32(1.0 / scale),
                    None if capture is None else capture(i))

        def emit(copied):
            host = copied.wait()
            for i in range(next(iter(host.values())).shape[0]):
                yield Detections(**{k: v[i] for k, v in host.items()})

        try:
            yield from self._stream_drive(enumerate(items), prep,
                                          lambda rows: run(rows, text), emit,
                                          chunk)
        finally:
            run.close()

    def predict(self, image, K, categories: list[str], depth=None,
                trace: dict | None = None) -> Detections:
        """Prompts -> 2D open-vocabulary boxes -> 3D cuboids for one image
        ([H, W, 3] uint8 or float, K [3, 3]): Detections of `detect_topk`
        slots on the device, boxes in original pixels. Given a dict
        `trace`, fills it with each stage's milliseconds (under "ms", from
        the stages' spans, device time on the card, after one wait for the
        card at the end) and the detector's raw pred_logits and
        pred_boxes."""
        with stages(trace, SERVE_STAGES):
            return self.run(self.prepare(image, K, categories, depth), trace)


def default_focal_K(h: int, w: int) -> np.ndarray:
    """The demo's intrinsics when none are given: f = 4 * h / 2
    (demo/demo.py:63-76)."""
    f = 4.0 * h / 2.0
    return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]],
                    np.float32)
