"""Closed-loop open-vocabulary stream traffic: OVMono3D-LIFT served through
`OVMono3DLift.predict_stream`, one chunk in flight, as the stream serves a
video or a photo set with a fixed category prompt.

Set-up builds the pipeline on the card with the benchmark's seeded weights
(the cube model from --seed, GroundingDINO from --seed + 1), tokenizes the
prompt (the traffic's categories), draws a host pool of uint8 frames at the
traffic's camera sizes with their K, and warms up by reading one chunk
back. A unit of the window is one chunk of Detections read from the
stream (the port runs a chunk as one batch: the traffic's `launches` are a
chunk's); `infer_img_per_s` counts the images whose Detections reached the
host in the window.

The check reads what the timed path produced: the stream captures each
row it runs (`predict_stream`'s `capture`: the canvas, content size, K and
ratio, the detector's raw outputs, its query indices, the encoded prompt,
the encoder's and the decoder's outputs and the 2D slots that entered the
lift), keeping the
newest chunks, and after the window every row of the last chunk whose
Detections came back in the window is held to the float32 reference
(benchmark/reference/gdino.py and the lift of reference/model.py), run on
the reference's own canvas of the host frame and following the program's
top-900 choice past the selection. Each number is pooled over the chunk's
rows (`Gaps`); a relative gap is the root mean square of the differences
over the reference's:

- `canvas_gap`: the program's canvas against the reference's resize and
  pad of the host frame (the stream's sizes, rounding, placement and the
  stacking of a chunk's rows);
- `memory_gap`: the encoder's output, every image token: it reads the
  bfloat16 layers' rounding through Swin, the fusion and the deformable
  encoder, before any discrete choice;
- `text_gap`: the encoded prompt (BERT and its map to the width, over the
  valid tokens), which the configuration computes in float32: whether the
  float32 island is kept;
- `topk_miss`: the share of the program's query indices not among the
  reference's own top 900;
- `hs_gap`: the decoder's normed output, every query: what the six
  decoder layers computed, read before the two heads;
- `logits_gap`: the pred_logits over the valid text tokens, and
  `boxes_gap`, the pred_boxes: the heads' outputs, whose gaps swing with
  the seeded weights (a logit is a product of two normed vectors, and
  where the weights leave it small its rounding is large beside it);
- `corners_rms_gap`: the reference's lift on the program's 2D slots against
  the program's Detections, the corners of every slot (the cube model lifts
  all of them, valid or not);
- `score_gap`: the largest gap of a valid slot's fused score.

A port without the capture (an older commit) stops the run at once.
"""
from __future__ import annotations

import gc
import inspect
import itertools
import statistics
import time

import torch

from benchmark import generator, harness, weights
from benchmark.reference import gdino as ref_gdino
from benchmark.reference import model as ref_model
from benchmark.reference.numerics import Ops

NO_CAPTURE = ("the port's OVMono3DLift.predict_stream takes no `capture`: "
              "this commit cannot run the stream cell's check")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def gdino_kwargs(g: dict) -> dict:
    """The port's GroundingDINO arguments of a configuration's `gdino`."""
    s, b, t = g["swin"], g["bert"], g["transformer"]
    return dict(
        hidden_dim=t["hidden"], nheads=t["heads"], enc_layers=t["enc_layers"],
        dec_layers=t["dec_layers"], num_queries=t["queries"],
        num_levels=t["levels"], enc_points=t["enc_points"],
        dec_points=t["dec_points"], max_text_len=g["max_text_len"],
        ffn_dim=t["ffn"], swin_embed_dim=s["embed_dim"],
        swin_depths=tuple(s["depths"]), swin_heads=tuple(s["heads"]),
        swin_window=s["window"], bert_layers=b["layers"],
        bert_hidden=b["hidden"], bert_heads=b["heads"],
        bert_intermediate=b["intermediate"], bert_vocab=b["vocab"],
        bert_max_position=b["max_position"])


def _filled(model: torch.nn.Module, seed: int, device, means) -> dict:
    """Seeded weights drawn on `device` and copied into `model` (built on
    the meta device); returns them."""
    model.to_empty(device=device)
    w = weights.draw(weights.specs_of(model), seed, device, means)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    model.requires_grad_(False)
    model.eval()
    return w


def build(run: harness.Run, device):
    """(the pipeline, the cube model's weights, GroundingDINO's)."""
    from ovmono3d_tpu_torch.eval.oracle2d import category_tokenizer
    from ovmono3d_tpu_torch.models.gdino.model import GroundingDINO
    from ovmono3d_tpu_torch.models.ovmono3d import OVMono3DLift
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from ovmono3d_tpu_torch.utils.device import disable_tf32

    if "capture" not in inspect.signature(
            OVMono3DLift.predict_stream).parameters:
        raise SystemExit(NO_CAPTURE)
    cfg = run.port()
    g = run.cfg["gdino"]
    rcnn = build_model(cfg.model, device="meta")
    w_cube = _filled(rcnn, run.seed, device, run.cfg.get("weight_means"))
    gdino = GroundingDINO(**gdino_kwargs(g), device="meta")
    w_gdino = _filled(gdino, run.seed + 1, device,
                      run.cfg.get("gdino_weight_means"))
    disable_tf32(torch.device(device))
    pipe = OVMono3DLift(cfg, rcnn, gdino,
                        category_tokenizer(run.traffic["categories"]),
                        gdino_size=cfg.model.backbone.square_pad,
                        gdino_min_size=cfg.input.min_size_test,
                        gdino_max_size=cfg.input.max_size_test,
                        detect_topk=g["detect_topk"])
    return pipe, w_cube, w_gdino


def frames(run: harness.Run, device) -> list[tuple]:
    """The host pool: (uint8 [h, w, 3] noise, K [3, 3]) at camera sizes
    drawn from the seed."""
    g = torch.Generator(device=device).manual_seed(run.seed)
    side = run.cfg["model"]["backbone"]["square_pad"]
    _, _, K, _ = generator.cameras(g, run.traffic, run.traffic["pool"], side,
                                   device)
    out = []
    for k in K:
        w0, h0 = int(round(2 * float(k[0, 2]))), int(round(2 * float(k[1, 2])))
        img = torch.randint(0, 256, (h0, w0, 3), generator=g, device=device,
                            dtype=torch.uint8)
        out.append((img.cpu().numpy(), k.cpu().numpy()))
    return out


def text_inputs(pipe, categories: list[str]) -> dict:
    """The prompt as the stream runs it (the port's tokenizer and cut to
    T), on the pipeline's device, with the tokenizer's special ids."""
    tok = pipe.tokenizer
    text = pipe._text_device_inputs(categories)
    text["special_ids"] = (tok.cls_id, tok.sep_id, tok.period_id,
                           tok.question_id)
    return text


class Gaps:
    """The check's numbers pooled over rows: each relative gap is the root
    of the summed squared differences over the summed squares of the
    reference, over every row read."""

    RMS = ("canvas_gap", "memory_gap", "text_gap", "hs_gap", "logits_gap",
           "boxes_gap", "corners_rms_gap")

    def __init__(self):
        self.sums = {k: [0.0, 0.0] for k in self.RMS}
        self.miss = [0, 0]
        self.score = 0.0
        self.valid = 0

    def add(self, name: str, prog: torch.Tensor, ref: torch.Tensor) -> None:
        ref = ref.float()
        d = prog.float().to(ref.device) - ref
        self.sums[name][0] += float(d.square().sum())
        self.sums[name][1] += float(ref.square().sum())

    def numbers(self) -> dict:
        out = {k: (n / d) ** 0.5 if d > 0 else 0.0
               for k, (n, d) in self.sums.items()}
        out["topk_miss"] = self.miss[0] / max(self.miss[1], 1)
        out["score_gap"] = self.score
        return out


def ref_canvas(run: harness.Run, frame) -> tuple:
    """The reference's canvas of a host pool frame (reference.gdino.
    stream_canvas at the configuration's test sizes): (canvas, hw [1, 2],
    ratio [1])."""
    inp = run.cfg["input"]
    canvas, (nh, nw), ratio = ref_gdino.stream_canvas(
        frame, run.cfg["model"]["backbone"]["square_pad"],
        inp["min_size_test"], inp["max_size_test"])
    return (canvas, torch.tensor([[nh, nw]], device=canvas.device),
            torch.tensor([ratio], device=canvas.device))


def add_detector(gaps: Gaps, prog: dict, ref: dict, text_mask) -> None:
    """prog: pred_logits [Q, >= T], pred_boxes [Q, 4], query_index [Q],
    text_features [T, C], memory [S, C], hs [Q, C] of one row; ref:
    reference.gdino.encode's output for it, given the program's
    indices."""
    own = set(ref["own_index"][0].tolist())
    idx = prog["query_index"].tolist()
    gaps.miss[0] += sum(i not in own for i in idx)
    gaps.miss[1] += len(idx)
    T = text_mask.shape[-1]
    m = text_mask.reshape(-1).to(ref["pred_logits"].device)
    gaps.add("logits_gap", prog["pred_logits"][:, :T].to(m.device)[:, m],
             ref["pred_logits"][0][:, m])
    gaps.add("boxes_gap", prog["pred_boxes"], ref["pred_boxes"][0])
    gaps.add("text_gap", prog["text_features"].to(m.device)[m],
             ref["text_features"][0][m])
    gaps.add("memory_gap", prog["memory"], ref["memory"][0])
    gaps.add("hs_gap", prog["hs"], ref["hs"][0])


def lift_batch(canvas, hw, ratio, K, slots: dict) -> dict:
    """The reference lift's batch of one row: the reference's canvas and
    the 2D slots that entered the program's lift."""
    return {"image": canvas[None].float(), "K": K.float(), "im_hw": hw,
            "im_scale_ratio": ratio.float(),
            "oracle_boxes": slots["boxes"][None].float(),
            "oracle_scores": slots["scores"][None].float(),
            "oracle_valid": slots["valid"][None]}


def add_lift(gaps: Gaps, prog: dict, ref: dict, valid) -> None:
    """prog / ref: corners3d [N, 8, 3] and scores [N] of one row. The cube
    model lifts every slot, valid or not, so the corners of all are
    compared; the fused scores of the valid ones."""
    gaps.add("corners_rms_gap", prog["corners3d"], ref["corners3d"][0])
    v = valid.to(ref["scores"].device)
    if bool(v.any()):
        sp = prog["scores"].float().to(v.device)[v]
        gaps.score = max(gaps.score,
                         float((sp - ref["scores"][0][v]).abs().max()))
        gaps.valid += int(v.sum())


def reference(run: harness.Run, w_gdino: dict, canvas, hw, text: dict,
              precision=None, index=None) -> dict:
    """The reference detector on a canvas: float32 (or `precision`),
    following the query indices `index` [Q] given, else its own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = run.cfg["gdino"]
    with torch.no_grad():
        image = ref_gdino.normalize_canvas(canvas[None], hw, g["pixel_mean"],
                                           g["pixel_std"])
        return ref_gdino.encode(
            precision or ref_gdino.Precision(), w_gdino, g, image,
            text["input_ids"].long(), text["text_mask"], text["special_ids"],
            index=None if index is None else index[None])


def reference_lift(run: harness.Run, w_cube: dict, batch: dict,
                   mode: str = "f32") -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        return ref_model.oracle_forward(Ops(mode), w_cube, run.cfg, batch)


def check_rows(run, w_cube, w_gdino, rows: list, text: dict) -> Gaps:
    """The numbers of a chunk's rows, each (host frame, K, capture,
    {"corners3d", "scores"} of its Detections): the program's canvas
    against the reference's from the frame, and the program's outputs
    against the reference's on the reference's canvas."""
    gaps = Gaps()
    for frame, K, cap, det in rows:
        dev = cap["memory"].device
        canvas, hw, ratio = ref_canvas(run, torch.as_tensor(frame).to(dev))
        gaps.add("canvas_gap", cap["canvas"], canvas)
        add_detector(gaps, cap, reference(run, w_gdino, canvas, hw, text,
                                          index=cap["query_index"]),
                     text["text_mask"])
        K = torch.as_tensor(K).to(dev)[None]
        ref = reference_lift(run, w_cube, lift_batch(canvas, hw, ratio, K,
                                                     cap["slots"]))
        add_lift(gaps, det, ref, cap["slots"]["valid"])
    return gaps


def run(run: harness.Run) -> None:
    device = torch.device(run.device)
    pipe, w_cube, w_gdino = build(run, device)
    pool = frames(run, device)
    chunk, n = run.traffic["chunk"], len(pool)
    captures: dict = {}
    items = (pool[i % n] for i in itertools.count())
    stream = pipe.predict_stream(items, run.traffic["categories"],
                                 chunk=chunk,
                                 capture=lambda i: captures.setdefault(i, {}))
    emitted = 0
    last: tuple = ()           # (stream index, Detections) of a chunk

    def pull():
        nonlocal emitted, last
        last = (emitted, [next(stream) for _ in range(chunk)])
        emitted += chunk
        for i in [i for i in captures if i < emitted - chunk]:
            del captures[i]

    pull()
    sync(device)
    run.e2e["setup_s"] = time.perf_counter() - run.started

    window = harness.Window(run, lambda: sync(device))
    unit_s = []
    while window.next():
        t0 = time.perf_counter()
        pull()
        unit_s.append(time.perf_counter() - t0)
    window_s = window.close()
    units = window.units
    run.e2e["infer_img_per_s"] = units * chunk / window_s
    run.attempted, run.failed = units, 0
    run.traced = window.traced
    text = text_inputs(pipe, run.traffic["categories"])
    run.work = {"requests": window.traced_units,
                "images": window.traced_units * chunk,
                "text_len": int(text["text_mask"].shape[-1])}
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    start, dets = last
    rows = [(*pool[(start + j) % n], captures[start + j],
             {"corners3d": d.corners3d, "scores": d.scores})
            for j, d in enumerate(dets)]
    stream.close()

    check_t0 = time.perf_counter()
    del window, pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = check_rows(run, w_cube, w_gdino, rows, text)
    nums = gaps.numbers()
    limits = run.traffic["limits"]
    run.checks.update((k, (v, limits[k])) for k, v in nums.items()
                      if k in limits)
    run.notes.append(f"checked the window's last chunk, stream rows "
                     f"{start}..{start + chunk - 1} (pool frames "
                     f"{[(start + j) % n for j in range(chunk)]}); valid 2D "
                     f"slots in it: {gaps.valid}"
                     + ("" if gaps.valid else
                        " (score_gap reads no slot; corners read every "
                        "slot)"))
    run.notes.append("readings " + " ".join(f"{k}={v!r}" for k, v in
                                              nums.items()))
    q = statistics.quantiles(unit_s, n=4) if len(unit_s) > 1 else unit_s * 3
    run.notes.append(f"chunk_s quartiles {q!r} max {max(unit_s)!r} over "
                     f"{len(unit_s)} chunks")
    run.notes.append(f"check_s={time.perf_counter() - check_t0!r}")
