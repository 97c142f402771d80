"""Readings that the limits of the stream cell's `correct` are set from, on
the card at the cell's own sizes:

    python3 benchmark/controls_stream.py --seeds 1 2 3 ...

For each seed, in one process, on one chunk of the seed's pool (the frames
of the chunk that `chunk_frames` draws from the seed), each reading held
to the float32 reference exactly as the benchmark's stream traffic holds
the program (traffic/stream.py `check_rows`, pooled over the chunk's rows):

- `program`: the port through `predict_stream`, its rows captured;
- `fault_skip_decoder_layer`: the same with one decoder layer left out
  (`--skip-layer`, the middle one by default);
- `fault_selection`: the same with the selection taking the 900 lowest
  encoder scores in place of the highest;
- `fault_stacking`: the same with each row of a chunk given the previous
  row's canvas (the first row its own);
- `control_fp8`: the reference with what the configuration keeps in
  bfloat16 computed in float8 e4m3 (reference.gdino.Precision("fp8"), the
  lift in numerics.Ops("fp8")), its own top-900 choice and its own 2D
  slots in the program's place;
- `control_bf16_islands`: the reference computing as the port does
  (bfloat16 where the configuration keeps it) and the configuration's
  float32 islands (BERT, the input projections, the encoder output's
  scoring, the two logit products) in bfloat16 too; the lift in float32;
- `reference_bf16`: the reference computing as the port does, islands in
  float32: how far the reference's own model of the program's precision
  reads (no limit is set from it).

Each line gives the reading's numbers, whether the traffic's `limits`
hold it correct, and the numbers over their limits. `--readings` takes
some of them.
"""
from __future__ import annotations

import argparse
import gc
import json
import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import gdino as ref_gdino  # noqa: E402
from benchmark.traffic import stream  # noqa: E402

WORKLOAD = "ov-stream-c8"
CONTROLS = {"control_fp8": (("fp8", "f32"), "fp8"),
            "control_bf16_islands": (("bf16", "bf16"), "f32"),
            "reference_bf16": (("bf16", "f32"), "f32")}
FAULTS = ("fault_skip_decoder_layer", "fault_selection", "fault_stacking")
READINGS = ("program", *FAULTS, *CONTROLS)


def chunk_frames(run) -> list[int]:
    """The pool frames of one of the pool's chunks, drawn from the seed:
    the frames that a chunk of the stream holds."""
    chunk, n = run.traffic["chunk"], run.traffic["pool"]
    k = random.Random(run.seed).randrange(n // chunk)
    return list(range(k * chunk, (k + 1) * chunk))


def program_rows(run, pipe, pool, frames: list[int]) -> list[tuple]:
    """The frames through `predict_stream` as one chunk, every row
    captured: [(frame, K, capture, {"corners3d", "scores"})]."""
    caps: dict = {}
    dets = list(pipe.predict_stream(
        [pool[i] for i in frames], run.traffic["categories"],
        chunk=len(frames), capture=lambda i: caps.setdefault(i, {})))
    return [(*pool[f], caps[j], {"corners3d": d.corners3d,
                                 "scores": d.scores})
            for j, (f, d) in enumerate(zip(frames, dets))]


class Fault:
    """A fault patched into the port for the rows computed inside."""

    def __init__(self, name: str, pipe, skip_layer: int):
        self.name, self.pipe, self.skip = name, pipe, skip_layer
        self.undo = []

    def _patch(self, obj, attr, value):
        self.undo.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, value)

    def __enter__(self):
        from ovmono3d_tpu_torch.models.gdino import model as port_model
        from ovmono3d_tpu_torch.models.ovmono3d import OVMono3DLift
        if self.name == "fault_skip_decoder_layer":
            layer = getattr(self.pipe.gdino, f"dec{self.skip}")
            self._patch(layer, "forward", lambda tgt, *args: tgt)
        elif self.name == "fault_selection":
            top = port_model.stable_topk
            self._patch(port_model, "stable_topk",
                        lambda x, k: top(-x, k))
        elif self.name == "fault_stacking":
            made = OVMono3DLift._stream_canvas
            prev = []

            def shifted(pipe, image, side, hw):
                canvas = made(pipe, image, side, hw)
                out = prev[-1] if prev else canvas
                prev.append(canvas)
                return out
            self._patch(OVMono3DLift, "_stream_canvas", shifted)
        return self

    def __exit__(self, *exc):
        for obj, attr, old in reversed(self.undo):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


def control_rows(run, wc, wg, rows: list, text: dict, precision,
                 lift_mode: str) -> list[tuple]:
    """A reference in another precision in the program's place on each
    row: its own selection, logits, boxes and 2D slots on the reference's
    canvas, and its lift on them."""
    g = run.cfg["gdino"]
    side = float(run.cfg["model"]["backbone"]["square_pad"])
    T = text["text_mask"].shape[-1]
    out = []
    for frame, K, cap, _ in rows:
        dev = cap["memory"].device
        canvas, hw, ratio = stream.ref_canvas(run,
                                              torch.as_tensor(frame).to(dev))
        ctl = stream.reference(run, wg, canvas, hw, text,
                               precision=precision)
        logits, boxes = ctl["pred_logits"][0], ctl["pred_boxes"][0]
        slots = ref_gdino.postprocess(
            logits, boxes, text["span_matrix"][:, :T].float(),
            text["span_valid"], side, g["detect_topk"], g["box_threshold"],
            g["nms_threshold"])
        lift = stream.reference_lift(run, wc, stream.lift_batch(
            canvas, hw, ratio, torch.as_tensor(K).to(dev)[None], slots),
            lift_mode)
        row = {"canvas": canvas, "pred_logits": logits, "pred_boxes": boxes,
               "query_index": ctl["query_index"][0],
               "text_features": ctl["text_features"][0],
               "memory": ctl["memory"][0], "hs": ctl["hs"][0],
               "slots": slots}
        out.append((frame, K, row, {"corners3d": lift["corners3d"][0],
                                    "scores": lift["scores"][0]}))
    return out


def verdict(run, nums: dict) -> dict:
    """The numbers, and how the traffic's limits judge them."""
    limits = run.traffic["limits"]
    over = sorted(k for k, v in nums.items() if k in limits
                  and v > limits[k])
    return {"values": nums, "correct": not over, "over_limit": over}


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def seed_readings(run, device, say, skip_layer: int,
                  readings=READINGS) -> None:
    pipe, wc, wg = stream.build(run, device)
    pool = stream.frames(run, device)
    frames = chunk_frames(run)
    text = stream.text_inputs(pipe, run.traffic["categories"])

    def judge(rows):
        return verdict(run, stream.check_rows(run, wc, wg, rows,
                                              text).numbers())
    rows = program_rows(run, pipe, pool, frames)
    if "program" in readings:
        say("program", judge(rows))
    for name in FAULTS:
        if name in readings:
            with Fault(name, pipe, skip_layer):
                faulty = program_rows(run, pipe, pool, frames)
            say(name, judge(faulty))
            del faulty
    del pipe
    free(device)
    for label, (modes, lift_mode) in CONTROLS.items():
        if label in readings:
            say(label, judge(control_rows(
                run, wc, wg, rows, text, ref_gdino.Precision(*modes),
                lift_mode)))
            free(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--skip-layer", type=int, default=None)
    ap.add_argument("--readings", nargs="+", choices=READINGS,
                    default=READINGS)
    args = ap.parse_args(argv)
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[WORKLOAD]
    cfg = harness.read_json("configs", cell["config"])
    traffic = harness.read_json("workloads", cell["traffic"])
    skip = (cfg["gdino"]["transformer"]["dec_layers"] // 2
            if args.skip_layer is None else args.skip_layer)
    device = torch.device("cuda")
    for seed in args.seeds:
        run = harness.Run(workload=WORKLOAD, cfg=cfg, traffic=traffic,
                          seed=seed, seconds=0, trace=False)

        def say(label, judged):
            print(json.dumps({"workload": WORKLOAD, "seed": seed,
                              "reading": label, **judged}), flush=True)
        seed_readings(run, device, say, skip, args.readings)
        free(device)


if __name__ == "__main__":
    main()
