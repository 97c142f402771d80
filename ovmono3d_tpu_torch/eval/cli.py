"""Omni3D evaluation of OVMono3D-LIFT: AP2D / AP3D / NHD over test datasets
(counterpart of tools/eval_net.py).

    python -m ovmono3d_tpu_torch.eval.cli --synthetic [--device cpu]
    python -m ovmono3d_tpu_torch.eval.cli --config-file \
        configs/OVMono3D_dinov2_SFP.yaml [--checkpoint out/model_recent.pt] \
        [key=value ...]

Per test dataset (`datasets.test_base` or `datasets.test_novel` by
`test.cat_mode`): load the Omni3D JSON under `datasets.data_root`, merge the
oracle 2D JSON (`datasets.oracle2d_files[eval_mode][cat_mode][name]`) when
`test.oracle2d` is set, batch the images (`data/build.py`), run the model on
the oracle boxes or, for batches without oracle slots, on its own 2D
detections, and accumulate every dataset into one
`Omni3DEvaluationHelper`, whose exact 3D IoU runs on the same device.
`--synthetic` evaluates two generated datasets instead (GT boxes as the
oracle, half the classes novel; with `test.oracle2d=false` they have no
oracle slots and the model detects its own 2D boxes).
Weights are the seeded init (`seed`) unless `--checkpoint` names a training
checkpoint of the port (`train/checkpoint.py`) or `--rcnn-ckpt` the released
ovmono3d_lift.pth (detectron2 format, converted by `utils/lift_convert.py`
and loaded after --checkpoint, as tools/eval_net.py does). The priors of
the prior decodes come from --priors, else priors.npz beside --checkpoint,
else the released file's (`extract_priors`), else, with --synthetic,
generated records; the JAX tool takes generated records' priors over the
file's, the port the file's, which its weights were trained with.

`--data-parallel` joins the process group that torchrun (or any launcher
setting MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE) describes: each
process evaluates its share of every dataset's images (`process_shard`) on
the card of its LOCAL_RANK, and the predictions are gathered back into the
records' order on every process (`gather_objects`), so the tables are those
of one process; rank 0 prints them and writes the dumps. Without a group it
is one process, as without the flag.

`--vis-dir DIR` writes the 3 x 2 pred-vs-GT panel (`vis/draw.py`
`pred_vs_gt_panels`) of every `--vis-period`-th image of each dataset to
DIR as <dataset>_p<rank>_<index>.png (the JAX tool writes .jpg through
cv2).

Runs on CUDA unless `--device` names another device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from ovmono3d_tpu_torch.config import load_config, oracle2d_file
from ovmono3d_tpu_torch.data.build import (build_test_iterator,
                                           default_image_loader)
from ovmono3d_tpu_torch.data.datasets import (attach_depth_files,
                                              filter_settings_from_cfg,
                                              get_dataset, load_category_meta,
                                              merge_oracle2d, simple_register)
from ovmono3d_tpu_torch.data.synthetic import (synthetic_datasets,
                                               synthetic_records)
from ovmono3d_tpu_torch.evaluation.helper import Omni3DEvaluationHelper
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.parallel.mesh import (gather_objects, init_multihost,
                                              process_shard, rank)
from ovmono3d_tpu_torch.utils.device import resolve_device
from ovmono3d_tpu_torch.utils.geometry import CORNER_SIGNS
from ovmono3d_tpu_torch.utils.lift_convert import extract_priors
from ovmono3d_tpu_torch.utils.load import load_rcnn_params, load_torch_state
from ovmono3d_tpu_torch.utils.priors import compute_priors
from ovmono3d_tpu_torch.utils.trace import span
from ovmono3d_tpu_torch.utils.util import imwrite_rgb
from ovmono3d_tpu_torch.vis.draw import pred_vs_gt_panels
from ovmono3d_tpu_torch.vis.logperf import (print_ap_analysis,
                                            print_ap_per_category,
                                            print_ap_summary)

logger = logging.getLogger("ovmono3d.eval")

_ORACLE_KEYS = ("oracle_boxes", "oracle_classes", "oracle_scores",
                "oracle_valid")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="a training checkpoint of the port (model_*.pt)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--priors", default=None,
                    help="priors.npz (dims / z_scales / z_stats) for "
                         "dims_priors_enabled / cluster_bins configs; "
                         "defaults to priors.npz beside --checkpoint")
    ap.add_argument("--category-meta", default=None,
                    help="category-meta JSON (configs/category_meta*.json) "
                         "giving the model's class names")
    ap.add_argument("--dump-predictions", default=None,
                    help="write per-image predictions JSON "
                         "(<prefix>_<dataset>.json)")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (e.g. cpu)")
    ap.add_argument("--rcnn-ckpt", default=None,
                    help="the released ovmono3d_lift.pth (detectron2 "
                         "format); its priors serve when --priors is absent")
    ap.add_argument("--data-parallel", action="store_true",
                    help="evaluate over the processes of a torchrun group")
    ap.add_argument("--vis-dir", default=None,
                    help="write a pred-vs-GT panel (PNG) every --vis-period "
                         "images here")
    ap.add_argument("--vis-period", type=int, default=50,
                    help="the image period of the --vis-dir panels")
    ap.add_argument("opts", nargs="*", default=[])
    return ap.parse_args(argv)


def make_run_fn(model):
    """One inference function, built once and shared across datasets: a
    batch with oracle slots runs the oracle path, one without runs the
    model's own 2D detections. Takes the batch's tensors on the model's
    device and returns the Detections there; each call is a unit span,
    eval.batch."""

    def run(batch: dict, depth: torch.Tensor | None = None):
        oracle = {k: batch[k] for k in _ORACLE_KEYS if k in batch}
        with span("eval.batch", unit=True), torch.inference_mode():
            return model(batch["image"], batch["K"], batch["im_hw"],
                         batch["im_scale_ratio"], depth, **oracle)

    return run


def evaluate_dataset(cfg, model, records, image_loader, batch_size, helper,
                     dataset_name, dump_path=None, run=None, vis_dir=None,
                     vis_period: int = 50) -> dict:
    """Inference over `records`, accumulated into the shared `helper`. The
    data timer covers loading and mapping a batch on the host, the compute
    timer its upload, the model and the copy of the detections back.
    Under a process group each process runs its share of the records
    (`process_shard`), and every process's helper receives all of them in
    the records' order (`gather_objects`); rank 0 writes the dump. With
    `vis_dir`, every `vis_period`-th image of this process gets a
    `pred_vs_gt_panels` panel, <dataset>_p<rank>_<index>.png (the image, or
    white where the loader has none). Returns
    {"images" (this process's), "data_s", "compute_s", "batch_ms": [...]}.
    """
    device = next(model.parameters()).device
    eval_prox = "Objectron" in dataset_name or "SUNRGBD" in dataset_name
    if run is None:
        run = make_run_fn(model)
    stats = {"images": 0, "data_s": 0.0, "compute_s": 0.0, "batch_ms": []}
    collected, dumped = [], []
    # Each record's place in `records`, to restore the order after the
    # gather.
    order = process_shard(list(range(len(records))))
    # Oracle slots hold the whole 100-detection protocol.
    it = iter(build_test_iterator(
        cfg, process_shard(records), batch_size, image_loader,
        max_oracle=max(64, cfg.test.detections_per_image)))
    while True:
        t0 = time.perf_counter()
        nxt = next(it, None)
        stats["data_s"] += time.perf_counter() - t0
        if nxt is None:
            break
        chunk, batch = nxt
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        depth = batch.pop("depth", None)
        det = run(batch, depth)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        dt = time.perf_counter() - t0
        stats["compute_s"] += dt
        stats["batch_ms"].append(dt * 1e3)
        for bi, rec in enumerate(chunk):
            valid = det["valid"][bi]
            pred = {
                "classes": det["classes"][bi][valid],
                "scores": det["scores"][bi][valid],
                "boxes2d": det["boxes"][bi][valid],
                "corners3d": det["corners3d"][bi][valid],
                "center": det["center_cam"][bi][valid],
                "dims": det["dimensions"][bi][valid],
                "pose": det["pose"][bi][valid],
                "center_2d": det["center_2d"][bi][valid],
            }
            place = order[stats["images"] + bi]
            gt = _record_gt(rec)
            collected.append((place, gt, pred))
            n = stats["images"] + bi
            if vis_dir is not None and vis_period > 0 and n % vis_period == 0:
                write_panel(Path(vis_dir) / f"{dataset_name}_p{rank()}_"
                                            f"{n:06d}.png",
                            rec, image_loader, gt, pred, helper.class_names)
            if dump_path is not None:
                dumped.append((place, _dump_entry(rec, pred)))
        stats["images"] += len(chunk)
    if stats["images"]:
        logger.info("%s: %d images; compute %.3f s (%.4f s/img); data "
                    "%.3f s", dataset_name, stats["images"],
                    stats["compute_s"], stats["compute_s"] / stats["images"],
                    stats["data_s"])
    for _, gt, pred in sorted(gather_objects(collected), key=lambda x: x[0]):
        helper.add_image(dataset_name, gt, pred, eval_prox=eval_prox)
    if dump_path is not None:
        dumped = [d for _, d in sorted(gather_objects(dumped),
                                       key=lambda x: x[0])]
        if rank() == 0:
            Path(dump_path).parent.mkdir(parents=True, exist_ok=True)
            with open(dump_path, "w") as fh:
                json.dump(dumped, fh)
    return stats


def write_panel(path: Path, rec: dict, image_loader, gt: dict, pred: dict,
                class_names) -> None:
    """The 3 x 2 pred-vs-GT panel of one record (tools/eval_net.py's, the
    reference's visualize_from_instances) as a PNG."""
    img = image_loader(rec) if image_loader else None
    if img is None:
        img = np.full((rec["height"], rec["width"], 3), 255, np.uint8)
    imwrite_rgb(path, pred_vs_gt_panels(
        img, np.asarray(rec["K"], np.float64), gt, pred,
        class_names=class_names))


def _dump_entry(rec: dict, pred: dict) -> dict:
    b = pred["boxes2d"]
    return {"image_id": rec["image_id"], "instances": [
        {"category_id": int(pred["classes"][j]),
         "score": float(pred["scores"][j]),
         "bbox": [float(b[j][0]), float(b[j][1]), float(b[j][2] - b[j][0]),
                  float(b[j][3] - b[j][1])],
         "center_cam": np.asarray(pred["center"][j]).tolist(),
         "dimensions": np.asarray(pred["dims"][j]).tolist(),
         "pose": np.asarray(pred["pose"][j]).tolist()}
        for j in range(len(b))]}


def _np_cuboid_corners(centers, dims, poses):
    """Cuboid corners of (center, (W, H, L), pose) in numpy, the model's
    vertex order (utils.geometry.cuboid_corners)."""
    signs = np.asarray(CORNER_SIGNS, np.float64)          # [8, 3]
    whl = np.asarray(dims, np.float64)
    scale = np.stack([whl[:, 2], whl[:, 1], whl[:, 0]], -1)
    local = signs[None] * scale[:, None, :]               # [N, 8, 3]
    local = np.einsum("nij,nkj->nki", np.asarray(poses, np.float64), local)
    return (local + np.asarray(centers, np.float64)[:, None, :]).astype(
        np.float32)


def _record_gt(rec: dict) -> dict:
    """A record's annotations as the evaluator's GT dict (tools/eval_net.py
    `_record_gt`): in-vocabulary ignores keep their category, unknown ones
    are class-agnostic (-1); annotations without 3D get zero corners."""
    classes, boxes2d, depths = [], [], []
    centers, dims, poses, ignores, has3d = [], [], [], [], []
    for anno in rec.get("annotations", []):
        cid = anno["category_id"]
        ig = bool(anno.get("ignore", cid < 0))
        if ig:
            cid = anno.get("category_id_eval", cid)
        classes.append(cid)
        ignores.append(ig)
        boxes2d.append(anno["bbox2d"])
        if anno.get("center_cam") is not None:
            has3d.append(True)
            depths.append(anno["center_cam"][2])
            centers.append(np.asarray(anno["center_cam"], np.float32))
            dims.append(np.asarray(anno["dimensions"], np.float32))
            poses.append(np.asarray(anno["pose"], np.float32))
        else:
            has3d.append(False)
            depths.append(0.0)
            centers.append(np.zeros(3, np.float32))
            dims.append(np.ones(3, np.float32))
            poses.append(np.eye(3, dtype=np.float32))
    n = len(classes)
    center = np.asarray(centers, np.float32).reshape(n, 3)
    corners = (_np_cuboid_corners(
        center, np.asarray(dims, np.float32).reshape(n, 3),
        np.asarray(poses, np.float32).reshape(n, 3, 3))
        if n else np.zeros((0, 8, 3), np.float32))
    corners[~np.asarray(has3d, bool)] = 0.0
    K = np.asarray(rec.get("K", np.eye(3)), np.float32)
    z = np.maximum(center[:, 2:3], 1e-6)
    center_2d = (center / z) @ K.T
    return {
        "classes": np.asarray(classes, np.int64),
        "ignore": np.asarray(ignores, bool),
        "boxes2d": np.asarray(boxes2d, np.float64).reshape(-1, 4),
        "corners3d": np.asarray(corners).reshape(-1, 8, 3),
        "depths": np.asarray(depths),
        "center": center,
        "dims": np.asarray(dims, np.float32).reshape(n, 3),
        "pose": np.asarray(poses, np.float32).reshape(n, 3, 3),
        "center_2d": center_2d[:, :2],
    }


def load_datasets(cfg) -> tuple[dict[str, list[dict]], object, set[str]]:
    """The configured test datasets with their oracle 2D merged (and prompt
    depth attached for depth-fusion trunks): ({name: records}, image
    loader, novel category names)."""
    from ovmono3d_tpu_torch.data.builtin import get_omni3d_categories

    # The GT ignore decision uses the TEST thresholds.
    fs = dataclasses.replace(filter_settings_from_cfg(cfg),
                             visibility_thres=cfg.test.visibility_thres,
                             truncation_thres=cfg.test.truncation_thres)
    cat_map = {n: i for i, n in enumerate(cfg.datasets.category_names)}
    mode = cfg.test.cat_mode
    names = (cfg.datasets.test_novel if mode == "novel"
             else cfg.datasets.test_base)
    datasets = {}
    for name in names:
        json_path = Path(cfg.datasets.data_root) / "Omni3D" / f"{name}.json"
        simple_register(name, json_path, fs, cat_map)
        recs = get_dataset(name)
        if cfg.test.oracle2d:
            oracle_path = oracle2d_file(cfg.datasets, name, mode)
            if not oracle_path:
                raise ValueError(
                    f"test.oracle2d is set but datasets.oracle2d_files"
                    f"[{cfg.datasets.oracle2d_eval_mode!r}][{mode!r}] has no "
                    f"entry for dataset {name!r}")
            recs = merge_oracle2d(recs, oracle_path)
        if cfg.datasets.depth_dir and cfg.model.backbone.use_depth_fusion:
            attach_depth_files(recs, cfg.datasets.depth_dir)
        datasets[name] = recs
    novel: set[str] = set()
    if mode == "novel":
        for name in names:
            try:
                novel |= set(get_omni3d_categories(name))
            except ValueError:
                pass
    return datasets, default_image_loader(cfg.datasets.data_root), novel


def _priors(args, cfg, device, released: dict | None = None) -> dict | None:
    """dims / z_scales / z_stats for the prior decodes, as f32 tensors on
    `device`: from --priors (or priors.npz beside --checkpoint), else from
    the released checkpoint's state dict `released` (--rcnn-ckpt), else,
    with --synthetic, computed from generated records."""
    path = args.priors
    if path is None and args.checkpoint:
        cand = Path(args.checkpoint).parent / "priors.npz"
        path = str(cand) if cand.exists() else None
    cube = cfg.model.cube
    from_file = extract_priors(released) if released is not None else None
    if path:
        npz = np.load(path)
        priors = {k: npz[k] for k in npz.files}
        logger.info("loaded priors from %s", path)
    elif from_file is not None:
        priors = from_file
        logger.info("priors from %s", args.rcnn_ckpt)
    elif args.synthetic and (cube.dims_priors_enabled
                             or cube.cluster_bins > 0):
        priors = compute_priors(
            synthetic_records(256, cfg.model.num_classes),
            cfg.model.num_classes, cube.cluster_bins,
            virtual_depth=cube.virtual_depth,
            virtual_focal=cube.virtual_focal,
            test_min=cfg.input.min_size_test,
            test_max=cfg.input.max_size_test,
            anchor_min=cfg.model.anchors.sizes[0][0],
            anchor_max=cfg.model.anchors.sizes[-1][-1])
    else:
        return None
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=device) for k, v in priors.items()}


def main(argv=None) -> dict:
    """Run the evaluation; prints the AP tables and returns the helper's
    `summarize_all()`."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    if (args.data_parallel and init_multihost(device=device)
            and device.type == "cuda"):
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank() % torch.cuda.device_count())))
        torch.cuda.set_device(device)
    cfg = load_config(args.config_file, overrides=args.opts)
    if args.category_meta:
        class_names = load_category_meta(args.category_meta)["thing_classes"]
    else:
        class_names = list(cfg.datasets.category_names) or [
            str(i) for i in range(cfg.model.num_classes)]

    released = load_torch_state(args.rcnn_ckpt) if args.rcnn_ckpt else None
    model = build_model(cfg.model, priors=_priors(args, cfg, device,
                                                  released),
                        device=device, seed=cfg.seed)
    if args.checkpoint:
        state = torch.load(args.checkpoint, map_location=device,
                           weights_only=True)
        model.load_state_dict(state["model"])
        logger.info("loaded checkpoint %s", args.checkpoint)
    if released is not None:
        load_rcnn_params(model, released, cfg.model)
        logger.info("loaded %s", args.rcnn_ckpt)
    del released
    model.eval()

    if args.synthetic:
        datasets, novel = synthetic_datasets(
            cfg.model.num_classes, class_names, oracle=cfg.test.oracle2d)
        image_loader = None
    else:
        datasets, image_loader, novel = load_datasets(cfg)

    helper = Omni3DEvaluationHelper(cfg.model.num_classes, class_names,
                                    novel_categories=novel, device=device)
    run = make_run_fn(model)
    for name, records in datasets.items():
        logger.info("evaluating %s (%d images)", name, len(records))
        evaluate_dataset(
            cfg, model, records, image_loader, args.batch_size, helper, name,
            dump_path=(f"{args.dump_predictions}_{name}.json"
                       if args.dump_predictions else None),
            run=run, vis_dir=args.vis_dir, vis_period=args.vis_period)

    summary = helper.summarize_all()
    if rank() != 0:
        return summary
    for name, res in summary["datasets"].items():
        print_ap_summary(res, title=name)
        print_ap_per_category(helper.ev3d[name].per_category_ap(),
                              title=f"{name} per-category AP3D")
    overall = dict(summary["overall"])
    overall.update({k: v for k, v in summary.items()
                    if k.startswith(("NHD_disentangled", "mean_err",
                                     "novel_", "AP3D_omni", "general_"))})
    print_ap_summary(overall, title="overall (all test datasets merged)")
    print_ap_per_category(summary["per_category_AP3D"],
                          title="merged per-category AP3D")
    print_ap_analysis(summary["datasets"])
    return summary


if __name__ == "__main__":
    main()
