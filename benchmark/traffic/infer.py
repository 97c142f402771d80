"""Closed-loop oracle-2D evaluation traffic: one batch in flight, as the
port's eval CLI runs the Omni3D protocol.

Set-up builds the model on the card with the benchmark's seeded weights
and a pool of mapped host batches (numpy, as the test iterator hands them
to `evaluate_dataset`), then warms the request up twice. A request is the
eval CLI's compute timer: the batch's upload, `make_run_fn`'s oracle route
(`RCNN3D.forward` on the oracle slots) and the detections copied back to
the host. After the window, a sample of the finished requests drawn from
the seed is held to the float32 reference on the same inputs.
"""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from benchmark import compare, generator, harness, weights
from benchmark.reference import model as ref_model
from benchmark.reference.numerics import Ops

WARMUP = 2


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(run: harness.Run, device):
    """(the model's run function, weights) at the config's sizes."""
    from ovmono3d_tpu_torch.eval.cli import make_run_fn
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from ovmono3d_tpu_torch.utils.device import disable_tf32

    cfg = run.port().model
    model = build_model(cfg, device="meta").to_empty(device=device)
    w = weights.draw(weights.specs_of(model), run.seed, device,
                     run.cfg.get("weight_means"))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    model.requires_grad_(False)
    model.eval()
    disable_tf32(torch.device(device))
    return make_run_fn(model), w


def host_pool(run: harness.Run, device) -> list[dict]:
    g = torch.Generator(device=device).manual_seed(run.seed)
    return [{k: v.cpu().numpy() for k, v in
             generator.oracle_batch(g, run.cfg, run.traffic, device).items()}
            for _ in range(run.traffic["pool"])]


def request(fn, batch: dict, device) -> dict:
    """evaluate_dataset's compute timer: upload, model, copy back."""
    dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    det = fn(dev, None)
    return {k: v.cpu().numpy() for k, v in det.items()}


def reference(run: harness.Run, w: dict, batch: dict, device,
              mode: str = "f32") -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with torch.no_grad():
        return ref_model.oracle_forward(Ops(mode), w, run.cfg, dev)


def run(run: harness.Run) -> None:
    device = torch.device(run.device)
    fn, w = build(run, device)
    pool = host_pool(run, device)
    for i in range(WARMUP):
        request(fn, pool[i % len(pool)], device)
    sync(device)
    run.e2e["setup_s"] = time.perf_counter() - run.started

    lat, outputs = [], []
    window = harness.Window(run, lambda: sync(device))
    while window.next():
        r0 = time.perf_counter()
        outputs.append(request(fn, pool[len(lat) % len(pool)], device))
        lat.append(time.perf_counter() - r0)
    window_s = window.close()
    b = run.traffic["batch"]
    run.e2e["infer_img_per_s"] = len(lat) * b / window_s
    run.e2e["request_ms_p95"] = float(np.percentile(lat, 95)) * 1e3
    run.attempted, run.failed = len(lat), 0
    run.traced = window.traced
    run.work = {"requests": window.traced_units,
                "images": window.traced_units * b}
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    check_t0 = time.perf_counter()
    del fn, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = random.Random(run.seed)
    sample = rng.sample(range(len(outputs)),
                        min(run.traffic["checked_requests"], len(outputs)))
    refs, worst = {}, {}
    for i in sample:
        k = i % len(pool)
        if k not in refs:
            refs[k] = reference(run, w, pool[k], device)
        nums = compare.infer_numbers(
            {n: torch.from_numpy(outputs[i][n]) for n in ("corners3d",
                                                           "scores")},
            refs[k], torch.from_numpy(pool[k]["oracle_valid"]).to(
                refs[k]["scores"].device))
        for n, v in nums.items():
            worst[n] = max(worst.get(n, 0.0), v)
    limits = run.traffic["limits"]
    run.checks.update((k, (v, limits[k])) for k, v in worst.items()
                      if k in limits)
    run.notes.append("readings " + " ".join(f"{k}={v!r}" for k, v in
                                              worst.items()))
    run.notes.append(f"check_s={time.perf_counter() - check_t0!r}")
