"""Readings that the limits of `correct` are set from, on the card at a
cell's own sizes:

    python3 benchmark/controls.py --workload <name> --seeds 1 2 3 ...

For each seed, in one process: the program's readings against the float32
reference (the sound runs, the lower readings); the control against the
same reference (the upper readings): the reference computed with the
trunk's and pyramid's products in float8 (numerics.Ops("fp8")); and the
training fault that needs a run: the program with half of each batch left
out (the losses' means over the other half). With --control-only, the
control's readings alone (no program is built). Prints one JSON line a
seed and reading, the worst leaves of each gap, and for training each
side's per-leaf squared differences from the reference (`leaves`).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import compare, generator, harness, weights  # noqa: E402
from benchmark.traffic import infer as infer_driver  # noqa: E402
from benchmark.traffic import train as train_driver  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The program's losses over the first half of every batch only."""
    from ovmono3d_tpu_torch.models.rcnn3d import RCNN3D
    from ovmono3d_tpu_torch.structures import GroundTruth
    original = RCNN3D.compute_losses

    def halved(self, image, K, im_hw, ratio, gt, generator=None, draws=None,
               depth=None, count_reduce=None):
        h = image.shape[0] // 2
        gt = GroundTruth(boxes=gt.boxes[:h], classes=gt.classes[:h],
                         boxes3d=gt.boxes3d[:h], poses=gt.poses[:h],
                         valid=gt.valid[:h])
        draws = None if draws is None else {k: v[:h]
                                            for k, v in draws.items()}
        return original(self, image[:h], K[:h], im_hw[:h], ratio[:h], gt,
                        generator, draws, None if depth is None
                        else depth[:h], count_reduce)
    RCNN3D.compute_losses = halved
    try:
        yield
    finally:
        RCNN3D.compute_losses = original


def worst_leaves(prog: dict, ref: dict, key: str, n: int = 3) -> list:
    norms = {k: float(v.norm()) for k, v in ref[key].items()}
    med = statistics.median(norms.values())
    gaps = sorted(((abs(float(prog[key][k].norm()) - norms[k])
                    / max(norms[k], med), k) for k in norms), reverse=True)
    return [[k, g] for g, k in gaps[:n]]


def leaf_sums(side: dict, ref: dict) -> dict:
    """Per leaf, for the first gradient and the change after three steps:
    the squared norm of the side's difference from the reference and the
    reference's squared norm, from which any leaf group's relative
    difference follows."""
    return {key: {n: [float((side[key][n].float() - r.float()).square()
                            .sum()), float(r.float().square().sum())]
                  for n, r in ref[key].items()}
            for key in ("grad", "delta")}


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program_readings(run, device, pool, fault=None):
    with fault() if fault else contextlib.nullcontext():
        model, opt, state, step, w = train_driver.build(run, device)
        _, prog = train_driver.first_steps(opt, state, step, pool, w)
    del model, opt, state, step
    free(device)
    return prog, w


def seeded_weights(run, device) -> dict:
    """The cell's seeded weights, as the drivers draw them, without
    building the program."""
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    model = build_model(run.port().model, device="meta")
    return weights.draw(weights.specs_of(model), run.seed, device,
                        run.cfg.get("weight_means"))


def train_seed(run, device, say, control_only=False):
    g = torch.Generator(device=device).manual_seed(run.seed)
    pool = [generator.train_batch(g, run.cfg, run.traffic, device)
            for _ in range(train_driver.CHECKED_STEPS)]
    if control_only:
        w = seeded_weights(run, device)
    else:
        prog, w = program_readings(run, device, pool)
    t0 = time.perf_counter()
    ref = train_driver.reference(run, w, pool)
    ref_s = time.perf_counter() - t0
    if not control_only:
        say("program", {**compare.train_numbers(prog, ref),
                        **compare.train_diagnostics(prog, ref)},
            prog["loss"], ref["loss"], worst_leaves(prog, ref, "grad"),
            worst_leaves(prog, ref, "delta"), ref_s)
    ctl = train_driver.reference(run, w, pool, mode="fp8")
    say("control_fp8", {**compare.train_numbers(ctl, ref),
                        **compare.train_diagnostics(ctl, ref)}, ctl["loss"],
        ref["loss"], worst_leaves(ctl, ref, "grad"),
        worst_leaves(ctl, ref, "delta"))
    sides = {"control_fp8": leaf_sums(ctl, ref)}
    del ctl
    free(device)
    if control_only:
        say("leaves", sides)
        return
    half, _ = program_readings(run, device, pool, half_batch)
    sides.update(program=leaf_sums(prog, ref),
                 fault_half_batch=leaf_sums(half, ref))
    say("leaves", sides)
    say("fault_half_batch", {**compare.train_numbers(half, ref),
                             **compare.train_diagnostics(half, ref)},
        half["loss"],
        ref["loss"])


def infer_seed(run, device, say, control_only=False):
    pool = infer_driver.host_pool(run, device)
    if control_only:
        w = seeded_weights(run, device)
    else:
        fn, w = infer_driver.build(run, device)
        outs = [infer_driver.request(fn, b, device) for b in pool[:2]]
        del fn
        free(device)
        worst = {}
        for out, b in zip(outs, pool):
            ref = infer_driver.reference(run, w, b, device)
            nums = compare.infer_numbers(
                {k: torch.from_numpy(out[k]) for k in ("corners3d",
                                                        "scores")},
                ref, torch.from_numpy(b["oracle_valid"]).to(
                    ref["scores"].device))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
        say("program", worst)
    worst = {}
    for b in pool[:2]:
        ref = infer_driver.reference(run, w, b, device)
        ctl = infer_driver.reference(run, w, b, device, mode="fp8")
        nums = compare.infer_numbers(ctl, ref, torch.from_numpy(
            b["oracle_valid"]).to(ref["scores"].device))
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    say("control_fp8", worst)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[
        args.workload]
    cfg = harness.read_json("configs", cell["config"])
    traffic = harness.read_json("workloads", cell["traffic"])
    device = torch.device("cuda")
    for seed in args.seeds:
        run = harness.Run(workload=args.workload, cfg=cfg, traffic=traffic,
                          seed=seed, seconds=0, trace=False)

        def say(label, *values):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": label, "values": values}),
                  flush=True)
        if traffic["driver"] == "train":
            train_seed(run, device, say, args.control_only)
        else:
            infer_seed(run, device, say, args.control_only)
        free(device)


if __name__ == "__main__":
    main()
