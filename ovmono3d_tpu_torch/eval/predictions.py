"""Offline Omni3D evaluation of a saved predictions file (counterpart of
tools/eval_predictions.py, the reference's evaluate_predictions_from_file,
eval.py:1839).

    python -m ovmono3d_tpu_torch.eval.predictions --predictions preds.json \
        --dataset-json datasets/Omni3D/Objectron_test.json \
        --categories "bicycle,books,..." [--device cpu]

The predictions JSON is a list of per-image dicts
  {"image_id": ..., "instances": [{"category_id", "score", "bbox" (XYWH),
    "center_cam", "dimensions", "pose"}, ...]}
the schema `eval.cli --dump-predictions` writes. The dataset drives the
loop: an image absent from the file counts its ground truth as missed, and a
second entry for an image is ignored. The ground truth is filtered with the
test protocol's visibility and truncation thresholds (0.5), as `eval.cli`
filters it. The 3D IoU runs on the card unless `--device` names another
device.
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from ovmono3d_tpu_torch.data.datasets import FilterSettings, load_omni3d_json
from ovmono3d_tpu_torch.eval.cli import _np_cuboid_corners, _record_gt
from ovmono3d_tpu_torch.evaluation.helper import Omni3DEvaluationHelper
from ovmono3d_tpu_torch.utils.device import resolve_device
from ovmono3d_tpu_torch.vis.logperf import (print_ap_per_category,
                                            print_ap_summary)

logger = logging.getLogger("ovmono3d.eval")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--predictions", required=True)
    ap.add_argument("--dataset-json", required=True)
    ap.add_argument("--categories", required=True,
                    help="comma-separated category names (model order)")
    ap.add_argument("--visibility-thres", type=float, default=0.5)
    ap.add_argument("--truncation-thres", type=float, default=0.5)
    ap.add_argument("--eval-prox", choices=["auto", "on", "off"],
                    default="auto",
                    help="proximity evaluation for non-exhaustive datasets "
                         "(auto: on for Objectron and SUNRGBD, as eval.cli)")
    ap.add_argument("--device", default=None,
                    help="torch device of the 3D IoU; CUDA unless given")
    return ap.parse_args(argv)


def instances_to_pred(instances: list[dict]) -> dict:
    """A file's instances as the evaluator's prediction dict; fields an
    instance lacks take tools/eval_predictions.py's defaults (score 1, an
    empty box, a unit cube 1 m ahead, the identity pose)."""
    classes, scores, boxes2d = [], [], []
    centers, dims, poses = [], [], []
    for inst in instances:
        classes.append(inst["category_id"])
        scores.append(inst.get("score", 1.0))
        b = inst.get("bbox", [0, 0, 0, 0])
        boxes2d.append([b[0], b[1], b[0] + b[2], b[1] + b[3]])
        centers.append(inst.get("center_cam", [0, 0, 1]))
        dims.append(inst.get("dimensions", [1, 1, 1]))
        poses.append(inst.get("pose", np.eye(3).tolist()))
    n = len(classes)
    center = np.asarray(centers, np.float32).reshape(n, 3)
    dim = np.asarray(dims, np.float32).reshape(n, 3)
    pose = np.asarray(poses, np.float32).reshape(n, 3, 3)
    return {
        "classes": np.asarray(classes, np.int64),
        "scores": np.asarray(scores, float),
        "boxes2d": np.asarray(boxes2d, float).reshape(n, 4),
        "corners3d": (_np_cuboid_corners(center, dim, pose) if n
                      else np.zeros((0, 8, 3), np.float32)),
        "center": center, "dims": dim, "pose": pose,
    }


def main(argv=None) -> dict:
    """Evaluate the file; prints the AP tables and returns the helper's
    `summarize_all()`."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    categories = [c.strip() for c in args.categories.split(",")]
    fs = FilterSettings(category_names=tuple(categories),
                        visibility_thres=args.visibility_thres,
                        truncation_thres=args.truncation_thres)
    records = load_omni3d_json(args.dataset_json, fs,
                               {n: i for i, n in enumerate(categories)})
    with open(args.predictions) as f:
        entries = json.load(f)
    by_img: dict = {}
    for entry in entries:
        if entry["image_id"] in by_img:
            logger.warning("duplicate predictions for image %s: keeping the "
                           "first entry", entry["image_id"])
            continue
        by_img[entry["image_id"]] = entry["instances"]
    name = Path(args.dataset_json).stem
    eval_prox = args.eval_prox == "on" or (
        args.eval_prox == "auto"
        and ("Objectron" in name or "SUNRGBD" in name))
    helper = Omni3DEvaluationHelper(len(categories), categories,
                                    device=device)
    missing = 0
    for rec in records:
        instances = by_img.get(rec["image_id"])
        if instances is None:
            instances = []
            missing += 1
        helper.add_image("offline", _record_gt(rec),
                         instances_to_pred(instances), eval_prox=eval_prox)
    logger.info("evaluated %d images (%d without predictions), eval_prox=%s",
                len(records), missing, eval_prox)
    summary = helper.summarize_all()
    print_ap_summary(summary["overall"], title="offline predictions")
    print_ap_per_category(summary["per_category_AP3D"])
    return summary


if __name__ == "__main__":
    main()
