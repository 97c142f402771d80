"""Tiny configurations and traffic of the benchmark's cells for the CPU
tests, and the port's model switched to float32 so that a sound program
reads the reference to rounding."""
from __future__ import annotations

import copy

import torch

from benchmark import harness

CELLS = {"dinov2-train-b8": "lift-dinov2-vitb14",
         "sam-finetune-b8": "lift-sam-vitb16",
         "dinov2-eval-b8": "lift-dinov2-vitb14"}


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.read_json("configs", name))
    m, t = cfg["model"], cfg["trunk"]
    b = m["backbone"]
    if b["name"] == "dinov2":
        b.update(embed_dim=64, depth=2, num_heads=2, pretrain_grid=8,
                 square_pad=112)
        t.update(embed_dim=64, depth=2, heads=2, pretrain_grid=8)
    else:                       # the SAM preset keeps its window and neck
        b.update(embed_dim=64, depth=3, num_heads=2, square_pad=256)
        t.update(embed_dim=64, depth=3, heads=2)
    b["out_channels"] = 32
    m["num_classes"] = 5
    m["roi_box"].update(fc_dim=32, batch_size_per_image=64)
    m["cube"]["fc_dim"] = 32
    m["rpn"].update(pre_nms_topk_train=200, post_nms_topk_train=100)
    m["exact_roi_pool"] = True
    return cfg


def traffic(workload: str, cfg: dict) -> dict:
    t = copy.deepcopy(harness.read_json("workloads", workload))
    side = cfg["model"]["backbone"]["square_pad"]
    t.update(batch=2, max_long=side, short_sides=[side * 3 // 4])
    if "oracle_slots" in t:
        t.update(oracle_slots=10, oracle_valid=[1, 10])
    return t


def run(workload: str, seed: int = 7, seconds: float = 0.5,
        trace: bool = False) -> harness.Run:
    cfg = config(CELLS[workload])
    return harness.Run(workload=workload, cfg=cfg,
                       traffic=traffic(workload, cfg), seed=seed,
                       seconds=seconds, trace=trace, device="cpu")


def to_f32(model: torch.nn.Module) -> None:
    """Every module of the port that computes in a `dtype` computes in
    float32."""
    for mod in model.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float32
