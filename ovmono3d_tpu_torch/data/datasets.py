"""Omni3D dataset registry, JSON loading and annotation filtering.

Host-side re-design of cubercnn/data/datasets.py (SURVEY.md §2.1 #15):
plain-json loading (no pycocotools dependency), the multi-criterion
`is_ignore` filter, contiguous category-ID mapping, and 2D-box source
selection (truncated projection / tight projection / modal).

Records are plain dicts; the fixed-shape batcher in `mapper.py` turns them
into model inputs.

A copy of ovmono3d_tpu/data/datasets.py: the port imports nothing of the JAX package, and a test
holds the copy to it.
"""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np

logger = logging.getLogger(__name__)

_DATASET_REGISTRY: dict[str, Callable[[], list[dict]]] = {}
_METADATA: dict[str, Any] = {}


@dataclass
class FilterSettings:
    """Annotation filter thresholds (get_filter_settings_from_cfg,
    datasets.py:52-79)."""

    category_names: tuple[str, ...] = ()
    ignore_names: tuple[str, ...] = ()
    truncation_thres: float = 0.99
    visibility_thres: float = 0.01
    min_height_thres: float = 0.0
    max_height_thres: float = 1.50
    max_depth: float = 1e8
    modal_2d_boxes: bool = False
    trunc_2d_boxes: bool = True


def filter_settings_from_cfg(cfg) -> FilterSettings:
    d = cfg.datasets
    return FilterSettings(
        category_names=tuple(d.category_names),
        ignore_names=tuple(d.ignore_names),
        truncation_thres=d.truncation_thres,
        visibility_thres=d.visibility_thres,
        min_height_thres=d.min_height_thres,
        max_depth=d.max_depth,
        modal_2d_boxes=d.modal_2d_boxes,
        trunc_2d_boxes=d.trunc_2d_boxes,
    )


def is_ignore(anno: dict, fs: FilterSettings, image_height: float) -> bool:
    """Multi-criterion ignore filter (reference datasets.py:82-122)."""
    ignore = anno.get("behind_camera", False)
    ignore |= not bool(anno.get("valid3D", True))
    if ignore:
        return True
    ignore |= anno.get("dimensions", [1, 1, 1])[0] <= 0
    ignore |= anno.get("dimensions", [1, 1, 1])[1] <= 0
    ignore |= anno.get("dimensions", [1, 1, 1])[2] <= 0
    ignore |= anno.get("center_cam", [0, 0, 1])[2] > fs.max_depth
    lidar = anno.get("lidar_pts")
    if lidar is not None:
        ignore |= lidar == 0
    seg_pts = anno.get("segmentation_pts")
    if seg_pts is not None:
        ignore |= seg_pts == 0
    depth_error = anno.get("depth_error")
    if depth_error is not None:
        ignore |= depth_error > 0.5
    bbox2d = _choose_bbox2d(anno, fs)
    if bbox2d is not None:
        height = bbox2d[3]
        ignore |= height <= fs.min_height_thres * image_height
        ignore |= height >= fs.max_height_thres * image_height
    truncation = anno.get("truncation", 0.0)
    if truncation is not None and truncation >= 0:
        ignore |= truncation >= fs.truncation_thres
    visibility = anno.get("visibility", 1.0)
    if visibility is not None and visibility >= 0:
        ignore |= visibility <= fs.visibility_thres
    return bool(ignore)


def _xyxy_to_xywh(box):
    x1, y1, x2, y2 = box
    return [x1, y1, x2 - x1, y2 - y1]


def _choose_bbox2d(anno: dict, fs: FilterSettings):
    """2D box source selection in XYWH (datasets.py:99-122, 418-428).

    The Omni3D JSON stores bbox2D_tight/trunc/proj as XYXY_ABS — the
    reference converts each to XYWH via BoxMode.convert; the COCO-style
    `bbox` fallback is already XYWH. A truncated box is usable when not
    ALL of its coordinates are -1 (reference's np.all check)."""
    tight = anno.get("bbox2D_tight")
    if fs.modal_2d_boxes and tight is not None and tight[0] != -1:
        return _xyxy_to_xywh(tight)
    trunc = anno.get("bbox2D_trunc")
    if (fs.trunc_2d_boxes and trunc is not None
            and not all(v == -1 for v in trunc)):
        return _xyxy_to_xywh(trunc)
    proj = anno.get("bbox2D_proj")
    if proj is not None:
        # Used UNCONDITIONALLY when present (reference datasets.py:425-426
        # has no -1 validity check on proj): an all -1 proj yields a
        # degenerate XYWH box that the height filter marks ignore; our
        # loader's w/h <= 0 drop removes it instead (a zero-area ignore
        # region matches nothing in RPN IoA or eval, so behavior is
        # unchanged).
        return _xyxy_to_xywh(proj)
    if anno.get("bbox") is not None:
        # Synthetic-data convenience ONLY (plain COCO-style fixtures):
        # real Omni3D annotations always carry bbox2D_proj, and the
        # reference drops annotations without it (datasets.py:428-429).
        return anno["bbox"]
    return None


def load_omni3d_json(
    json_path: str | Path,
    fs: FilterSettings,
    category_to_contiguous: dict[str, int] | None = None,
) -> list[dict]:
    """Load one Omni3D-format JSON into per-image records.

    Record fields: file_name, image_id, width, height, K (3x3 list),
    dataset_id, annotations: list of dicts with category (name),
    category_id (contiguous, -1 = ignore), bbox2d (XYXY), center_cam,
    dimensions (w, h, l), pose (3x3 R_cam), center_2d (projected).
    """
    with open(json_path) as f:
        data = json.load(f)

    cats = {c["id"]: c["name"] for c in data.get("categories", [])}
    if category_to_contiguous is None:
        names = sorted(
            set(fs.category_names) if fs.category_names else set(cats.values())
        )
        category_to_contiguous = {n: i for i, n in enumerate(names)}

    annos_by_image: dict[int, list[dict]] = {}
    for anno in data.get("annotations", []):
        annos_by_image.setdefault(anno["image_id"], []).append(anno)

    # Dataset SOURCE (info['source'] in Omni3D jsons): pools multiple
    # splits of one origin for dataset-balancing weights, exactly like the
    # reference's dataset_id_to_src (train_net.py:534-539).
    source = data.get("info", {}).get("source")

    records = []
    for img in data.get("images", []):
        K = np.asarray(img["K"], np.float64).reshape(3, 3)
        rec = {
            "file_name": img.get("file_path", img.get("file_name", "")),
            "image_id": img["id"],
            "width": img["width"],
            "height": img["height"],
            "K": K.tolist(),
            "dataset_id": img.get("dataset_id", 0),
            "source": (source if source is not None
                       else img.get("dataset_id", 0)),
            "annotations": [],
        }
        for anno in annos_by_image.get(img["id"], []):
            name = cats.get(anno["category_id"], str(anno["category_id"]))
            ignore = name.lower() in fs.ignore_names
            known = name in category_to_contiguous
            if not known and not ignore:
                # Category neither in the vocabulary nor an ignore name:
                # the reference DROPS the annotation entirely
                # (datasets.py:409-411 `continue`), it does NOT become an
                # ignore region.
                continue
            ignore = ignore or is_ignore(anno, fs, img["height"])

            bbox2d = _choose_bbox2d(anno, fs)
            if bbox2d is None:
                continue
            x, y, w, h = bbox2d
            if w <= 0 or h <= 0:
                continue
            rec["annotations"].append(
                {
                    "category": name,
                    "category_id": (
                        -1 if ignore else category_to_contiguous[name]
                    ),
                    # True contiguous id regardless of the ignore flag: the
                    # evaluator keeps in-vocab ignores under their own
                    # category (reference ignore2D/3D flags keep
                    # category_name, data/datasets.py:258-260).
                    "category_id_eval": category_to_contiguous.get(name, -1),
                    "bbox2d": [x, y, x + w, y + h],
                    "center_cam": anno.get("center_cam"),
                    "dimensions": anno.get("dimensions"),
                    "pose": anno.get("R_cam", anno.get("pose")),
                    "ignore": ignore,
                    "truncation": anno.get("truncation", 0.0),
                    "visibility": anno.get("visibility", 1.0),
                }
            )
        records.append(rec)
    logger.info(
        "loaded %d images from %s", len(records), json_path
    )
    return records


def simple_register(
    name: str, json_path: str | Path, fs: FilterSettings,
    category_to_contiguous: dict[str, int] | None = None,
):
    """Register a dataset factory under a name (datasets.py:125-138)."""
    _DATASET_REGISTRY[name] = lambda: load_omni3d_json(
        json_path, fs, category_to_contiguous
    )
    _METADATA[name] = {
        "json_path": str(json_path),
        "category_to_contiguous": category_to_contiguous,
    }


def attach_depth_files(records: list[dict], depth_dir: str | Path) -> None:
    """Point each record at its prompt-depth .npz (datasets.depth_dir).

    Mirrors the reference's depth-path rule — depth_dir + image basename +
    '.npz', key 'depth' (dataset_mapper.py:38-45) — as a record field the
    mapper consumes (mapper.py:129-137). Records whose file is absent get
    no depth, matching the reference's read-error fallback
    (dataset_mapper.py:57-58)."""
    depth_dir = Path(depth_dir)
    for rec in records:
        p = depth_dir / (Path(rec["file_name"]).stem + ".npz")
        if p.exists():
            rec["depth_file"] = str(p)


def get_dataset(name: str) -> list[dict]:
    if name not in _DATASET_REGISTRY:
        raise KeyError(
            f"dataset '{name}' not registered; have {sorted(_DATASET_REGISTRY)}"
        )
    return _DATASET_REGISTRY[name]()


def get_metadata(name: str) -> dict:
    return _METADATA[name]


def register_model_categories(
    name: str, category_names: Iterable[str]
) -> dict[str, int]:
    """Contiguous ID map for the model's category universe
    (register_and_store_model_metadata, datasets.py:294-318)."""
    thing_classes = list(category_names)
    mapping = {n: i for i, n in enumerate(thing_classes)}
    _METADATA[name] = {
        "thing_classes": thing_classes,
        "thing_dataset_id_to_contiguous_id": mapping,
    }
    return mapping


def load_category_meta(path: str | Path) -> dict:
    """Load a category-meta JSON ID map (reference configs/category_meta*.json
    consumed by train_net.py:404-416): thing_classes plus the
    dataset-ID -> contiguous-ID mapping with integer keys."""
    with open(path) as f:
        meta = json.load(f)
    id_map = {
        int(k): int(v)
        for k, v in meta["thing_dataset_id_to_contiguous_id"].items()
    }
    return {
        "thing_classes": list(meta["thing_classes"]),
        "thing_dataset_id_to_contiguous_id": id_map,
    }


def merge_oracle2d(
    records: list[dict], oracle_json: str | Path, score_key: str = "score"
) -> list[dict]:
    """Attach oracle/GDINO 2D detections to records by image_id
    (build.py:45-54 merge_oracle2d_to_detection_dicts)."""
    with open(oracle_json) as f:
        oracle = json.load(f)
    by_image: dict[Any, list] = {}
    items = oracle if isinstance(oracle, list) else oracle.get(
        "annotations", []
    )
    for det in items:
        by_image.setdefault(det["image_id"], []).append(det)
    for rec in records:
        dets = by_image.get(rec["image_id"], [])
        rec["oracle2d"] = [
            {
                "bbox2d": _xywh_to_xyxy(d["bbox"]) if "bbox" in d else d["bbox2d"],
                "category_id": d["category_id"],
                "score": d.get(score_key, 1.0),
            }
            for d in dets
        ]
    return records


def _xywh_to_xyxy(b):
    return [b[0], b[1], b[0] + b[2], b[1] + b[3]]
