"""OVMono3D-GEO in PyTorch: zero-shot 3D boxes from SAM masks and Depth-Pro
metric depth, one per 2D box.

Counterpart of tools/ovmono3d_geo.py. Per image: Depth-Pro metric depth at
1536^2 resized back to the image; the SAM image embedding of the image
placed top-left on a 1024^2 canvas; for every 2D box scoring at least 0.30
(the highest-scoring `max_instances`), SAM's largest mask (index 2), cropped
to the canvas's content and resized to the image; then the GEO box fit
(geo/pipeline.py). Fits with no usable pixel are dropped.

    python -m ovmono3d_tpu_torch.geo.cli --synthetic [--device cpu] \
        [--gelu tanh]

`--synthetic` checks the geometry end to end without models: exact masks
and depth maps of known boxes must give back their front faces. The
dataset and evaluation flags (`--config-file`, `--eval`, `--eval-only`)
wait for the data pipeline and the Omni3D evaluator (ROADMAP queue 1
items 3-5). Entry points run on the card unless given a CPU device.
Depth-Pro runs in f32 unless `--depth-bf16` is given, as in the JAX CLI;
on the card its f32 attention is kernel 1's f32 instance. Released SAM and
Depth-Pro weights are not loaded yet (ROADMAP queue 1 item 8): weights are
drawn from a seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

from ovmono3d_tpu_torch.geo.pipeline import fit_box_from_mask_depth
from ovmono3d_tpu_torch.models.backbones import SAM_ARCHS, VIT_PRESETS
from ovmono3d_tpu_torch.models.depth import DepthPro, metric_depth
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils.device import (device_constant, disable_tf32,
                                             resolve_device)
from ovmono3d_tpu_torch.utils.image import resize_bilinear
from ovmono3d_tpu_torch.utils.stages import Stages

SCORE_THRESHOLD = 0.30          # reference ovmono3d_geo.py:274
S_SAM, S_DEPTH = 1024, 1536     # SAM's canvas; Depth-Pro's fixed input
PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)
MASK_INDEX = 2                  # SAM's largest candidate (reference L309)


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


def predict_image(models: GeoModels, image, K, dets: list[dict],
                  trace: dict | None = None) -> list[dict]:
    """GEO boxes for one image (tools/ovmono3d_geo.py:340-400).

    image: [H, W, 3] uint8 (numpy or tensor); K: [3, 3]; dets: dicts with
    `bbox2d` (xyxy pixels), `score` and `category_id`, of which the
    `models.max_instances` best at or above SCORE_THRESHOLD run. Returns
    one dict per kept box with a valid fit (category_id, score, bbox2d,
    center_cam, dimensions, pose).
    Given a dict `trace`, fills it with each stage's milliseconds (under
    "ms", synchronising the device between stages) and the intermediate
    tensors: canonical_inverse_depth, depth_map, embed, mask_logits."""
    dev = models.device
    stages = Stages(trace, dev)
    img = torch.as_tensor(image, device=dev).float() / 255.0
    H, W = img.shape[:2]
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    Sd, Ss = models.depth_size, models.sam_size
    kept = sorted((d for d in dets if d["score"] >= SCORE_THRESHOLD),
                  key=lambda d: -d["score"])[:models.max_instances]
    with torch.inference_mode():
        # Depth-Pro metric depth, with the known focal length, back at the
        # image's resolution.
        cid = models.depth(_normalize(resize_bilinear(img, (Sd, Sd)))[None])[
            "canonical_inverse_depth"]
        f_px = (Kt[0, 0] * Sd / W).reshape(1)
        depth_map = resize_bilinear(metric_depth(cid, f_px, Sd)[..., None],
                                    (H, W))[0, ..., 0]
        stages.mark("depth", canonical_inverse_depth=cid, depth_map=depth_map)
        # SAM's embedding of the image, scaled to the canvas and placed
        # top-left.
        scale = Ss / max(H, W)
        sh, sw = int(H * scale), int(W * scale)
        canvas = torch.zeros(Ss, Ss, 3, device=dev)
        canvas[:sh, :sw] = _normalize(resize_bilinear(img, (sh, sw)))
        embed = models.sam_encoder(canvas[None])["last_feat"]
        stages.mark("sam_encoder", embed=embed)
        if not kept:
            return []
        boxes = torch.tensor([d["bbox2d"] for d in kept], dtype=torch.float32,
                             device=dev) * scale
        masks, _ = models.segmenter(embed, boxes, float(Ss))
        logits = masks[:, MASK_INDEX]
        # The masks cover the padded canvas: crop its content region before
        # the resize to the image (segment_anything's postprocess_masks).
        mh, mw = logits.shape[-2:]
        ch = max(1, int(round(mh * (H * scale) / Ss)))
        cw = max(1, int(round(mw * (W * scale) / Ss)))
        mask_img = resize_bilinear(logits[:, :ch, :cw, None],
                                   (H, W))[..., 0] > 0
        stages.mark("segment", mask_logits=logits)
        fit = fit_box_from_mask_depth(mask_img.float(), depth_map, Kt)
        fit = {k: v.cpu() for k, v in fit.items()}
        stages.mark("fit")
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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--output-dir", default="output/geo")
    ap.add_argument("--sam-arch", default="vit_b", choices=tuple(SAM_ARCHS),
                    help="SAM encoder size (the reference uses vit_h)")
    ap.add_argument("--depth-bf16", action="store_true",
                    help="run Depth-Pro in bf16 (default f32, as the JAX "
                         "CLI)")
    ap.add_argument("--gelu", default="erf", choices=("erf", "tanh"),
                    help="the GELU of SAM's and Depth-Pro's ViT MLPs: exact "
                         "erf (the released models' op) or the approximate "
                         "tanh serving epilogue (not bit-identical)")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    if args.eval_only and args.synthetic:
        ap.error("--eval-only evaluates written predictions; it cannot be "
                 "combined with --synthetic")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
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
        return
    raise NotImplementedError(
        "GEO over a dataset (--config-file, --eval, --eval-only): the Omni3D "
        "data pipeline and evaluator are ROADMAP queue 1 items 3-5; "
        "predict_image runs one image")


if __name__ == "__main__":
    main()
