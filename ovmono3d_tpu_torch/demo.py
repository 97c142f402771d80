"""Open-vocabulary demo: images and text labels -> rendered 3D cuboids
(counterpart of tools/demo.py, the reference's demo/demo.py).

    python -m ovmono3d_tpu_torch.demo --input-folder imgs/ \
        --labels "chair,table,lamp" [--labels-file labels.json] \
        [--config-file configs/OVMono3D_dinov2_SFP.yaml] \
        [--focal-length F] [--principal-point X Y] [--vocab vocab.txt] \
        [--rcnn-ckpt ovmono3d_lift.pth] [--gdino-ckpt groundingdino.pth] \
        [--output-dir out/] [--threshold 0.2] [--device cpu] [key=value ...]

Every image of the folder (by extension, sorted) goes through
`OVMono3DLift.predict` with the labels as the prompt (or, with
--labels-file, a JSON of image stem -> labels, where an image mapped to []
or absent is skipped); detections scored below --threshold are dropped and
`vis/draw.py` `scene_panel` is written as <stem>_3d.png. Without intrinsics
K is f = 4 h / 2 at the image centre (`default_focal_K`). Without --vocab
the tokenizer's vocabulary is the prompt's words. The weights are drawn
from the config's seed unless --rcnn-ckpt / --gdino-ckpt name the released
files; the released LIFT file's priors reach the build. PNG needs nothing;
JPEG and other formats are read through PIL. Runs on CUDA unless --device
names another device.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ovmono3d_tpu_torch.config import load_config
from ovmono3d_tpu_torch.eval.oracle2d import category_tokenizer
from ovmono3d_tpu_torch.models.gdino.tokenizer import BertTokenizer
from ovmono3d_tpu_torch.models.ovmono3d import OVMono3DLift, default_focal_K
from ovmono3d_tpu_torch.utils.device import resolve_device
from ovmono3d_tpu_torch.utils.lift_convert import extract_priors
from ovmono3d_tpu_torch.utils.load import (load_gdino_params,
                                           load_rcnn_params,
                                           load_torch_state)
from ovmono3d_tpu_torch.utils.util import imread_rgb, imwrite_rgb, list_images
from ovmono3d_tpu_torch.vis.draw import scene_panel

logger = logging.getLogger("ovmono3d.demo")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input-folder", required=True)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--labels",
                   help="comma-separated category prompts (the same for "
                        "every image)")
    g.add_argument("--labels-file",
                   help="JSON of image stem -> list of prompts; an image "
                        "mapped to [] (or absent) is skipped")
    ap.add_argument("--config-file",
                    default="configs/OVMono3D_dinov2_SFP.yaml")
    ap.add_argument("--focal-length", type=float, default=0.0)
    ap.add_argument("--principal-point", type=float, nargs=2, default=None)
    ap.add_argument("--vocab", default=None, help="BERT's vocab.txt")
    ap.add_argument("--rcnn-ckpt", default=None,
                    help="the released ovmono3d_lift.pth (detectron2 "
                         "format), loaded into the cube model")
    ap.add_argument("--gdino-ckpt", default=None,
                    help="the released GroundingDINO SwinB .pth")
    ap.add_argument("--output-dir", default="output/demo")
    ap.add_argument("--threshold", type=float, default=0.2)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (e.g. cpu)")
    ap.add_argument("opts", nargs="*", default=[])
    return ap.parse_args(argv)


def prompts(args) -> tuple[list[str], dict | None]:
    """(every category, {image stem: its categories} or None)."""
    if args.labels_file:
        per_image = json.loads(Path(args.labels_file).read_text())
        return sorted({c for v in per_image.values() for c in v}), per_image
    return [c.strip() for c in args.labels.split(",") if c.strip()], None


def build_pipeline(args, cfg, categories: list[str],
                   device=None) -> OVMono3DLift:
    """The tokenizer (--vocab, else the prompt's words), the priors of
    --rcnn-ckpt, both models from the config's seed on `device`, and the
    released weights loaded into them."""
    if args.vocab:
        tok = BertTokenizer(args.vocab)
    else:
        tok = category_tokenizer(categories)
        logger.warning("no --vocab given; using a prompt-local vocab")
    released = load_torch_state(args.rcnn_ckpt) if args.rcnn_ckpt else None
    priors = None
    if released is not None:
        priors = extract_priors(released)
        if priors is not None:
            dev = resolve_device(device)
            priors = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                         device=dev)
                      for k, v in priors.items()}
            logger.info("priors from %s", args.rcnn_ckpt)
    pipe = OVMono3DLift.build(cfg, tok, priors=priors, device=device,
                              seed=cfg.seed)
    if released is not None:
        load_rcnn_params(pipe.rcnn, released, cfg.model)
        logger.info("loaded %s", args.rcnn_ckpt)
    if args.gdino_ckpt:
        load_gdino_params(pipe.gdino, args.gdino_ckpt)
        logger.info("loaded %s", args.gdino_ckpt)
    logger.info("pipeline built (%d categories)", len(categories))
    return pipe


def intrinsics(h: int, w: int, focal_length: float = 0.0,
               principal_point=None) -> np.ndarray:
    """K of the flags, else `default_focal_K`."""
    if focal_length <= 0:
        return default_focal_K(h, w)
    px, py = principal_point or (w / 2, h / 2)
    return np.array([[focal_length, 0, px], [0, focal_length, py],
                     [0, 0, 1]], np.float32)


def demo_image(pipe: OVMono3DLift, image: np.ndarray,
               categories: list[str], K: np.ndarray,
               threshold: float = 0.2) -> tuple[np.ndarray, dict, dict]:
    """One image through a built pipeline: (the panel [H, W + H, 3] uint8,
    the detections as numpy arrays with `valid` and-ed with score >=
    threshold, {"predict_ms", "draw_ms"} on the host clock, the prediction
    ending with its copy to the host)."""
    t0 = time.perf_counter()
    det = pipe.predict(image, K, categories)
    det = {k: v.cpu().numpy() for k, v in det.items()}
    t1 = time.perf_counter()
    det["valid"] = det["valid"] & (det["scores"] >= threshold)
    panel = scene_panel(image, SimpleNamespace(**det), K,
                        class_names=categories)
    t2 = time.perf_counter()
    return panel, det, {"predict_ms": (t1 - t0) * 1e3,
                        "draw_ms": (t2 - t1) * 1e3}


def run(pipe: OVMono3DLift, folder, categories: list[str],
        per_image: dict | None, out_dir, threshold: float = 0.2,
        focal_length: float = 0.0, principal_point=None) -> list[dict]:
    """Every image of `folder` through `demo_image`, panels written to
    `out_dir`; returns, per image served, {"image", "panel", "detections",
    "predict_ms", "draw_ms"}."""
    out_dir = Path(out_dir)
    served = []
    for path in list_images(folder):
        cats = categories
        if per_image is not None:
            cats = per_image.get(path.stem, [])
            if not cats:          # the reference's demo.py:53-55
                continue
        image = imread_rgb(path)
        K = intrinsics(*image.shape[:2], focal_length, principal_point)
        panel, det, ms = demo_image(pipe, image, cats, K, threshold)
        out_path = out_dir / f"{path.stem}_3d.png"
        imwrite_rgb(out_path, panel)
        n = int(det["valid"].sum())
        logger.info("%s: %d detections -> %s", path.name, n, out_path)
        served.append({"image": str(path), "panel": str(out_path),
                       "detections": n, **ms})
    return served


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config_file, overrides=args.opts)
    categories, per_image = prompts(args)
    pipe = build_pipeline(args, cfg, categories, device=args.device)
    return run(pipe, args.input_folder, categories, per_image,
               args.output_dir, args.threshold, args.focal_length,
               args.principal_point)


if __name__ == "__main__":
    main()
