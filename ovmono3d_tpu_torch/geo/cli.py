"""OVMono3D-GEO in PyTorch: zero-shot 3D boxes from SAM masks and Depth-Pro
metric depth, one per 2D box.

Counterpart of tools/ovmono3d_geo.py and tools/eval_ovmono3d_geo.py. Per
image: Depth-Pro metric depth at 1536^2 resized back to the image; the SAM
image embedding of the image placed top-left on a 1024^2 canvas; for every
2D box scoring at least 0.30 (the highest-scoring `--max-instances`), SAM's
largest mask (index 2), cropped to the canvas's content and resized to the
image; then the GEO box fit (geo/pipeline.py). Fits with no usable pixel are
dropped.

    python -m ovmono3d_tpu_torch.geo.cli --synthetic [--device cpu] \
        [--gelu tanh]
    python -m ovmono3d_tpu_torch.geo.cli --config-file configs/... --eval \
        [--max-instances 16] [--output-dir output/geo] [key=value ...]
    python -m ovmono3d_tpu_torch.geo.eval_cli --config-file configs/... \
        [key=value ...]          # --eval-only: the written predictions

`--synthetic` checks the geometry end to end without models: exact masks
and depth maps of known boxes must give back their front faces. With
`--config-file`, GEO runs over each dataset of `datasets.test_novel` (else
`datasets.test`) on its oracle 2D boxes (`datasets.oracle2d_files`'s novel
entry, merged by `data.datasets.merge_oracle2d`) and writes
`geo_predictions_<dataset>.pkl` ({image_id: [box, ...]}) to `--output-dir`;
`--eval` evaluates them against the ground truth with every category novel,
and `--eval-only` evaluates pickles written before without running the
models. Entry points run on the card unless given a CPU device. Depth-Pro
runs in f32 unless `--depth-bf16` is given, as in the JAX CLI; on the card
its f32 attention is kernel 1's f32 instance, and SAM's is kernel 7.
Weights are drawn from a seed unless `--sam-ckpt` names an official
sam_vit_*.pth (of `--sam-arch`'s size: encoder and segmenter) and
`--depth-ckpt` Depth-Pro's weights: a flat flax-path .npz, or a HF-format
(apple/DepthPro-hf) torch checkpoint (`utils/load.py`).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import pickle
from pathlib import Path

import numpy as np
import torch

from ovmono3d_tpu_torch.config import load_config, oracle2d_file
from ovmono3d_tpu_torch.data.build import default_image_loader
from ovmono3d_tpu_torch.data.datasets import (filter_settings_from_cfg,
                                              get_dataset, merge_oracle2d,
                                              simple_register)
from ovmono3d_tpu_torch.eval.cli import _np_cuboid_corners, _record_gt
from ovmono3d_tpu_torch.evaluation.helper import Omni3DEvaluationHelper
from ovmono3d_tpu_torch.geo.pipeline import fit_box_from_mask_depth
from ovmono3d_tpu_torch.models.backbones import SAM_ARCHS, VIT_PRESETS
from ovmono3d_tpu_torch.models.depth import DepthPro, metric_depth
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils.device import (device_constant, disable_tf32,
                                             resolve_device)
from ovmono3d_tpu_torch.utils.image import resize_bilinear
from ovmono3d_tpu_torch.utils.load import load_depth_params, load_sam_params
from ovmono3d_tpu_torch.utils.trace import span, stages
from ovmono3d_tpu_torch.vis.logperf import print_ap_summary

logger = logging.getLogger("ovmono3d.geo")

SCORE_THRESHOLD = 0.30          # reference ovmono3d_geo.py:274
S_SAM, S_DEPTH = 1024, 1536     # SAM's canvas; Depth-Pro's fixed input
PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)
MASK_INDEX = 2                  # SAM's largest candidate (reference L309)
# `predict_image`'s stages, the spans its trace reports.
GEO_STAGES = ("depth", "sam_encoder", "segment", "fit")


@dataclasses.dataclass
class GeoModels:
    sam_encoder: VisionTransformer
    segmenter: SamSegmenter
    depth: DepthPro
    sam_size: int = S_SAM
    depth_size: int = S_DEPTH
    max_instances: int = 16

    @property
    def device(self) -> torch.device:
        return self.segmenter.mask_decoder.iou_token.device


def build_geo_models(sam_arch: str = "vit_b", depth_bf16: bool = False,
                     device=None, seed: int = 0, quant: str = "none",
                     gelu: str = "erf") -> GeoModels:
    """SAM's image encoder (`sam_arch` over the sam preset, bf16), SAM's
    prompt encoder and mask decoder (f32) and Depth-Pro (bf16 with
    `depth_bf16`, else f32, the JAX CLI's default), in eval mode, with
    weights drawn from a generator seeded with `seed` on `device` (so a
    seed's weights differ between devices). `quant` ("int8": W8A8,
    SERVING-only) and `gelu` ("tanh") are the serving options of SAM's and
    Depth-Pro's ViT trunks, as tools/bench_geo_models.py passes them. On
    CUDA it turns TF32 off for matmuls and cuDNN
    (`utils.device.disable_tf32`): the decoder, the fit and an f32 Depth-Pro
    are f32 math."""
    device = resolve_device(device)
    disable_tf32(device)
    sam = VisionTransformer(
        use_depth_fusion=False, pos_interp_offset=0.0, device=device,
        quant=quant, gelu=gelu,
        **{**VIT_PRESETS["sam"], **SAM_ARCHS[sam_arch]})
    seg = SamSegmenter(device=device)
    depth = DepthPro(dtype=torch.bfloat16 if depth_bf16 else torch.float32,
                     quant=quant, gelu=gelu, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for model in (sam, seg, depth):
            model.init_weights(g)
    return GeoModels(sam.eval(), seg.eval(), depth.eval())


def _normalize(img: torch.Tensor) -> torch.Tensor:
    return ((img - device_constant(PIXEL_MEAN, img.device))
            / device_constant(PIXEL_STD, img.device))


def kept_detections(dets: list[dict], max_instances: int) -> list[dict]:
    """The boxes GEO fits: those scoring at least SCORE_THRESHOLD, best
    first, at most `max_instances` (the threshold comes first, as the
    reference's ovmono3d_geo.py:274 filters every box)."""
    return sorted((d for d in dets if d["score"] >= SCORE_THRESHOLD),
                  key=lambda d: -d["score"])[:max_instances]


def predict_image(models: GeoModels, image, K, dets: list[dict],
                  trace: dict | None = None) -> list[dict]:
    """GEO boxes for one image (tools/ovmono3d_geo.py:340-400).

    image: [H, W, 3] uint8 (numpy or tensor); K: [3, 3]; dets: dicts with
    `bbox2d` (xyxy pixels), `score` and `category_id`, of which the
    `models.max_instances` best at or above SCORE_THRESHOLD run. Returns
    one dict per kept box with a valid fit (category_id, score, bbox2d,
    center_cam, dimensions, pose).
    Given a dict `trace`, fills it with each stage's milliseconds (under
    "ms", from the spans of GEO_STAGES, device time on the card, after one
    wait for the card at the end) and the intermediate tensors:
    canonical_inverse_depth, depth_map, embed, mask_logits."""
    with stages(trace, GEO_STAGES):
        return _predict_image(models, image, K, dets, trace)


def _predict_image(models: GeoModels, image, K, dets: list[dict],
                   trace: dict | None) -> list[dict]:
    trace = {} if trace is None else trace
    dev = models.device
    img = torch.as_tensor(image, device=dev).float() / 255.0
    H, W = img.shape[:2]
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    Sd, Ss = models.depth_size, models.sam_size
    kept = kept_detections(dets, models.max_instances)
    with torch.inference_mode():
        # Depth-Pro metric depth, with the known focal length, back at the
        # image's resolution.
        with span("depth"):
            cid = models.depth(_normalize(resize_bilinear(
                img, (Sd, Sd)))[None])["canonical_inverse_depth"]
            f_px = (Kt[0, 0] * Sd / W).reshape(1)
            depth_map = resize_bilinear(
                metric_depth(cid, f_px, Sd)[..., None], (H, W))[0, ..., 0]
        trace.update(canonical_inverse_depth=cid, depth_map=depth_map)
        # SAM's embedding of the image, scaled to the canvas and placed
        # top-left.
        with span("sam_encoder"):
            scale = Ss / max(H, W)
            sh, sw = int(H * scale), int(W * scale)
            canvas = torch.zeros(Ss, Ss, 3, device=dev)
            canvas[:sh, :sw] = _normalize(resize_bilinear(img, (sh, sw)))
            embed = models.sam_encoder(canvas[None])["last_feat"]
        trace.update(embed=embed)
        if not kept:
            return []
        with span("segment"):
            boxes = torch.tensor([d["bbox2d"] for d in kept],
                                 dtype=torch.float32, device=dev) * scale
            masks, _ = models.segmenter(embed, boxes, float(Ss))
            logits = masks[:, MASK_INDEX]
            # The masks cover the padded canvas: crop its content region
            # before the resize to the image (segment_anything's
            # postprocess_masks).
            mh, mw = logits.shape[-2:]
            ch = max(1, int(round(mh * (H * scale) / Ss)))
            cw = max(1, int(round(mw * (W * scale) / Ss)))
            mask_img = resize_bilinear(logits[:, :ch, :cw, None],
                                       (H, W))[..., 0] > 0
        trace.update(mask_logits=logits)
        with span("fit"):
            fit = fit_box_from_mask_depth(mask_img.float(), depth_map, Kt)
            fit = {k: v.cpu() for k, v in fit.items()}
    return [{
        "category_id": det["category_id"], "score": det["score"],
        "bbox2d": det["bbox2d"],
        "center_cam": fit["center"][i].tolist(),
        "dimensions": fit["dims"][i].tolist(),
        "pose": fit["pose"][i].tolist(),
    } for i, det in enumerate(kept) if bool(fit["valid"][i])]


def synthetic_scene(rng: np.random.RandomState, num_boxes: int = 3,
                    H: int = 192, W: int = 256, f: float = 300.0):
    """Disjoint boxes with exact front-face depth maps and masks (what a
    perfect SAM and Depth-Pro would give): K, depth [H, W], masks (a list
    of [H, W]) and the boxes (center, dims, front_z). The same draws and
    values as tools/ovmono3d_geo.py's per-pixel loops."""
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    depth = np.zeros((H, W), np.float32)
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    masks, gts = [], []
    xs = np.linspace(-0.8, 0.8, num_boxes)
    for i in range(num_boxes):
        z = rng.uniform(2.5, 4.0)
        dims = rng.uniform(0.3, 0.6, 3)
        cx, cy = xs[i] * z * 0.4, rng.uniform(-0.2, 0.2)
        z_front = z - dims[0] / 2
        x3 = z_front * (u - K[0, 2]) / f
        y3 = z_front * (v - K[1, 2]) / f
        inside = ((np.abs(x3 - cx) <= dims[2] / 2)
                  & (np.abs(y3 - cy) <= dims[1] / 2))
        depth[inside] = z_front
        masks.append(inside.astype(np.float32))
        gts.append({"center": np.array([cx, cy, z]), "dims": dims,
                    "front_z": z_front})
    return K, depth, masks, gts


def synthetic_check(device=None) -> tuple[bool, float, float, list[dict]]:
    """The `--synthetic` self-check on `device`: fit the synthetic scene's
    masks on its exact depth map. Returns (passed, max center error, max
    dims error, predictions); it passes with center errors under 0.1 m and
    errors of the two in-plane dims under 0.15 m, as the JAX tool asks."""
    dev = resolve_device(device)
    K, depth, masks, gts = synthetic_scene(np.random.RandomState(0))
    fit = fit_box_from_mask_depth(
        torch.as_tensor(np.stack(masks), device=dev),
        torch.as_tensor(depth, device=dev), torch.as_tensor(K, device=dev))
    fit = {k: v.cpu().numpy() for k, v in fit.items()}
    errs_c, errs_d, preds = [], [], []
    for i, gt in enumerate(gts):
        want_c = np.array([gt["center"][0], gt["center"][1], gt["front_z"]])
        errs_c.append(float(np.abs(fit["center"][i] - want_c).max()))
        errs_d.append(float(np.abs(np.sort(fit["dims"][i])[1:]
                                   - np.sort(gt["dims"][1:])).max()))
        preds.append({"center_cam": fit["center"][i].tolist(),
                      "dimensions": fit["dims"][i].tolist(),
                      "pose": fit["pose"][i].tolist(), "score": 1.0})
    ok = max(errs_c) < 0.1 and max(errs_d) < 0.15
    return ok, max(errs_c), max(errs_d), preds


def predict_dataset(models: GeoModels, records: list[dict], image_loader,
                    stage_ms: dict | None = None) -> dict:
    """GEO boxes of every record whose image loads, on its oracle 2D boxes
    (`oracle2d`): {image_id: predict_image's list}. Given a dict
    `stage_ms`, adds each stage span's milliseconds (device ms on the
    card) to it."""
    preds_all = {}
    for rec in records:
        image = image_loader(rec)
        if image is None:
            continue
        trace: dict | None = {} if stage_ms is not None else None
        preds_all[rec["image_id"]] = predict_image(
            models, image, np.asarray(rec["K"], np.float32),
            rec.get("oracle2d", []), trace=trace)
        for stage, ms in (trace or {}).get("ms", {}).items():
            stage_ms[stage] = stage_ms.get(stage, 0.0) + ms
    return preds_all


def evaluate_geo_predictions(records: list[dict], preds_all: dict,
                             class_names: list[str], device=None) -> dict:
    """Omni3D evaluation of GEO boxes with every category novel
    (tools/ovmono3d_geo.py `evaluate_geo_predictions`, the reference's
    eval_ovmono3d_geo.py:62-134); prints the overall table and returns the
    helper's `summarize_all()`. The 3D IoU runs on `device` (CUDA unless
    given)."""
    helper = Omni3DEvaluationHelper(
        len(class_names), class_names, novel_categories=set(class_names),
        device=resolve_device(device))
    for rec in records:
        preds = preds_all.get(rec["image_id"], [])
        n = len(preds)
        center = np.asarray([p["center_cam"] for p in preds],
                            np.float32).reshape(n, 3)
        dims = np.asarray([p["dimensions"] for p in preds],
                          np.float32).reshape(n, 3)
        pose = np.asarray([p["pose"] for p in preds],
                          np.float32).reshape(n, 3, 3)
        helper.add_image("geo", _record_gt(rec), {
            "classes": np.asarray([p["category_id"] for p in preds],
                                  np.int64),
            "scores": np.asarray([p["score"] for p in preds], float),
            "boxes2d": np.asarray([p["bbox2d"] for p in preds],
                                  float).reshape(n, 4),
            "corners3d": (_np_cuboid_corners(center, dims, pose) if n
                          else np.zeros((0, 8, 3), np.float32)),
            "center": center, "dims": dims, "pose": pose})
    res = helper.summarize_all()
    print_ap_summary(res["overall"], title="OVMono3D-GEO")
    return res


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--output-dir", default="output/geo")
    ap.add_argument("--max-instances", type=int, default=16,
                    help="at most this many boxes an image, best first")
    ap.add_argument("--sam-arch", default="vit_b", choices=tuple(SAM_ARCHS),
                    help="SAM encoder size (the reference uses vit_h)")
    ap.add_argument("--depth-bf16", action="store_true",
                    help="run Depth-Pro in bf16 (default f32, as the JAX "
                         "CLI)")
    ap.add_argument("--gelu", default="erf", choices=("erf", "tanh"),
                    help="the GELU of SAM's and Depth-Pro's ViT MLPs: exact "
                         "erf (the released models' op) or the approximate "
                         "tanh serving epilogue (not bit-identical)")
    ap.add_argument("--eval", action="store_true",
                    help="evaluate the written predictions against the "
                         "ground truth")
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate geo_predictions_<dataset>.pkl written "
                         "before, without running the models")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (e.g. cpu)")
    ap.add_argument("--sam-ckpt", default=None,
                    help="an official sam_vit_*.pth of --sam-arch's size")
    ap.add_argument("--depth-ckpt", default=None,
                    help="Depth-Pro weights: a flat flax-path .npz or a "
                         "HF-format (apple/DepthPro-hf) torch checkpoint")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    if args.eval_only and args.synthetic:
        ap.error("--eval-only evaluates written predictions; it cannot be "
                 "combined with --synthetic")
    return args


def main(argv=None) -> dict | None:
    """Run the CLI. Over datasets it returns {dataset: {"images": n,
    "stage_ms": mean ms an image by stage span, device ms on the card
    (none with --eval-only), "eval": the evaluation (None without
    --eval)}}."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out_dir = Path(args.output_dir)
    if args.synthetic:
        ok, err_c, err_d, preds = synthetic_check(args.device)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / "geo_predictions_synthetic.pkl"
        with open(path, "wb") as fh:
            pickle.dump(preds, fh)
        print(f"synthetic GEO: {len(preds)} boxes fitted; max center err "
              f"{err_c:.3f} m, max dims err {err_d:.3f} m -> {path}")
        print(f"GEO synthetic self-check: {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)
        return None
    cfg = load_config(args.config_file, overrides=args.opts)
    class_names = list(cfg.datasets.category_names)
    fs = filter_settings_from_cfg(cfg)
    cat_map = {n: i for i, n in enumerate(class_names)}
    models = None
    if not args.eval_only:
        models = build_geo_models(args.sam_arch, args.depth_bf16,
                                  args.device, gelu=args.gelu)
        # Released weights, as tools/ovmono3d_geo.py:295-309 loads them.
        if args.sam_ckpt:
            load_sam_params(models.sam_encoder, models.segmenter,
                            args.sam_ckpt,
                            depth=SAM_ARCHS[args.sam_arch]["depth"])
        if args.depth_ckpt:
            load_depth_params(models.depth, args.depth_ckpt)
        models.max_instances = args.max_instances
        out_dir.mkdir(parents=True, exist_ok=True)
    image_loader = default_image_loader(cfg.datasets.data_root)
    results = {}
    for name in cfg.datasets.test_novel or cfg.datasets.test:
        simple_register(name, Path(cfg.datasets.data_root) / "Omni3D"
                        / f"{name}.json", fs, cat_map)
        records = get_dataset(name)
        path = out_dir / f"geo_predictions_{name}.pkl"
        stage_ms: dict = {}
        if args.eval_only:
            with open(path, "rb") as fh:
                preds_all = pickle.load(fh)
            logger.info("evaluating %s (%d images)", path, len(preds_all))
        else:
            # GEO runs on the novel split (reference ovmono3d_geo.py:261-264).
            oracle_path = oracle2d_file(cfg.datasets, name, "novel")
            if oracle_path:
                records = merge_oracle2d(records, oracle_path)
            preds_all = predict_dataset(models, records, image_loader,
                                        stage_ms)
            with open(path, "wb") as fh:
                pickle.dump(preds_all, fh)
            logger.info("%s: %d images -> %s", name, len(preds_all), path)
        n = len(preds_all)
        results[name] = {
            "images": n,
            "stage_ms": {k: v / n for k, v in stage_ms.items()} if n else {},
            "eval": (evaluate_geo_predictions(records, preds_all, class_names,
                                              args.device)
                     if args.eval or args.eval_only else None)}
    return results


if __name__ == "__main__":
    main()
