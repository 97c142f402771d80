"""Per-image mapping to fixed-shape model inputs (counterpart of
ovmono3d_tpu/data/mapper.py): shortest-edge resize (and, for training, a
horizontal flip) of the image and of the prompt depth, K-aware 3D targets,
then padding to the static square input.

A copy of the JAX mapper whose resize is torch's bilinear `F.interpolate`
(`utils/image.py` `resize_bilinear`, half-pixel centres, no antialiasing:
cv2's INTER_LINEAR filter) on the CPU, since the machine with the card has
no cv2. Every other field (K, im_hw, im_scale_ratio, boxes, targets, oracle
slots) is the JAX mapper's, value for value. Outputs numpy arrays;
`batch_examples` stacks them into the model's batch contract.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ovmono3d_tpu_torch.config import Config
from ovmono3d_tpu_torch.utils.image import resize_bilinear, resize_shortest_edge

# Mirror fix-up of flipped poses, F @ R @ F with F = diag(-1, 1, 1) (the JAX
# mapper's convention; a cuboid is symmetric under the difference from the
# reference's, so every corner-set target is the same).
_M1 = np.diag([-1.0, 1.0, 1.0])
_M2 = np.diag([-1.0, 1.0, 1.0])


@dataclass
class MappedExample:
    image: np.ndarray          # [S, S, 3] f32, padded
    K: np.ndarray              # [3, 3] original intrinsics
    im_hw: np.ndarray          # [2] valid region in network coords
    im_scale_ratio: float      # original / network scale
    depth: np.ndarray | None = None  # [S, S, 1] prompt depth
    # training targets (padded to max_gt):
    gt_boxes: np.ndarray | None = None      # [M, 4]
    gt_classes: np.ndarray | None = None    # [M]
    gt_boxes3d: np.ndarray | None = None    # [M, 9]
    gt_poses: np.ndarray | None = None      # [M, 3, 3]
    gt_valid: np.ndarray | None = None      # [M]
    # oracle 2D (eval):
    oracle_boxes: np.ndarray | None = None   # [N, 4]
    oracle_classes: np.ndarray | None = None
    oracle_scores: np.ndarray | None = None
    oracle_valid: np.ndarray | None = None
    image_id: int = -1
    height: int = 0
    width: int = 0


def _resize_image(image: np.ndarray, new_hw: tuple[int, int]) -> np.ndarray:
    """[H, W] or [H, W, C] f32 -> the same at new_hw, bilinear."""
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    flat = x.ndim == 2
    y = resize_bilinear(x[..., None] if flat else x, new_hw)
    return (y[..., 0] if flat else y).numpy()


def map_example(record: dict, cfg: Config, image: np.ndarray | None = None,
                is_train: bool = False, max_gt: int = 64,
                max_oracle: int = 64,
                rng: np.random.RandomState | None = None) -> MappedExample:
    """Map one dataset record to fixed-shape arrays. `image`: [H, W, 3]
    uint8/float RGB, or None for a zero image of the record's size."""
    H, W = record["height"], record["width"]
    if image is None:
        image = np.zeros((H, W, 3), np.float32)
    S = cfg.model.backbone.square_pad
    short = (int(rng.choice(cfg.input.min_size_train))
             if (is_train and rng is not None) else cfg.input.min_size_test)
    max_size = (cfg.input.max_size_test if not is_train
                else cfg.input.max_size_train)
    nh, nw, scale = resize_shortest_edge((H, W), short, min(max_size, S))
    flip = bool(is_train and cfg.input.random_flip and rng is not None
                and rng.rand() < 0.5)
    padded = np.zeros((S, S, 3), np.float32)
    resized = _resize_image(image.astype(np.float32), (nh, nw))
    if flip:
        resized = resized[:, ::-1]
    padded[:nh, :nw] = resized

    K = np.asarray(record["K"], np.float64)
    ratio = 1.0 / scale  # original / network

    ex = MappedExample(
        image=padded,
        K=K.astype(np.float32),
        im_hw=np.array([nh, nw], np.int32),
        im_scale_ratio=np.float32(ratio),
        image_id=record.get("image_id", -1),
        height=H,
        width=W,
    )

    # Prompt depth: the image's geometry (resize, flip, top-left on the
    # square canvas).
    depth = record.get("depth")
    if depth is None and record.get("depth_file"):
        try:
            loaded = np.load(record["depth_file"])
            depth = loaded[loaded.files[0]] if hasattr(loaded, "files") \
                else loaded
        except (OSError, ValueError):
            depth = None
    if depth is not None:
        d = _resize_image(np.asarray(depth, np.float32), (nh, nw))
        if flip:
            d = d[:, ::-1]
        d_canvas = np.zeros((S, S), np.float32)
        d_canvas[:nh, :nw] = d
        ex.depth = d_canvas[..., None]

    # Network-resolution K for projecting 3D centers to input coords.
    K_net = K / ratio
    K_net[2, 2] = 1.0

    if is_train:
        annos = record.get("annotations", [])
        boxes = np.zeros((max_gt, 4), np.float32)
        classes = np.zeros((max_gt,), np.int32)
        boxes3d = np.zeros((max_gt, 9), np.float32)
        boxes3d[:, 2:6] = 1.0
        poses = np.tile(np.eye(3, dtype=np.float32), (max_gt, 1, 1))
        valid = np.zeros((max_gt,), bool)
        for i, anno in enumerate(annos[:max_gt]):
            x1, y1, x2, y2 = np.asarray(anno["bbox2d"], np.float64) * scale
            if flip:
                x1, x2 = nw - x2, nw - x1
            boxes[i] = [x1, y1, x2, y2]
            classes[i] = anno["category_id"]
            valid[i] = True
            if anno["category_id"] < 0 or anno.get("center_cam") is None:
                continue
            center = np.asarray(anno["center_cam"], np.float64)
            dims = np.asarray(anno["dimensions"], np.float64)
            pose = np.asarray(anno["pose"], np.float64)
            # Project the original center, then apply the image's 2D
            # transforms.
            proj = K_net @ center
            u, v = proj[0] / proj[2], proj[1] / proj[2]
            if flip:
                u = nw - u
                pose = _M1 @ pose @ _M2
                center = center * np.array([-1.0, 1.0, 1.0])
            boxes3d[i] = [u, v, center[2], dims[0], dims[1], dims[2],
                          center[0], center[1], center[2]]
            poses[i] = pose
        ex.gt_boxes, ex.gt_classes = boxes, classes
        ex.gt_boxes3d, ex.gt_poses, ex.gt_valid = boxes3d, poses, valid

    oracle = record.get("oracle2d")
    if oracle is not None:
        ob = np.zeros((max_oracle, 4), np.float32)
        oc = np.zeros((max_oracle,), np.int32)
        osc = np.zeros((max_oracle,), np.float32)
        ov = np.zeros((max_oracle,), bool)
        for i, det in enumerate(oracle[:max_oracle]):
            ob[i] = np.asarray(det["bbox2d"], np.float64) * scale
            oc[i] = det["category_id"]
            osc[i] = det["score"]
            ov[i] = True
        ex.oracle_boxes, ex.oracle_classes = ob, oc
        ex.oracle_scores, ex.oracle_valid = osc, ov
    return ex


def batch_examples(examples: list[MappedExample]) -> dict[str, np.ndarray]:
    """Stack mapped examples into the model batch dict."""
    out = {
        "image": np.stack([e.image for e in examples]),
        "K": np.stack([e.K for e in examples]),
        "im_hw": np.stack([e.im_hw for e in examples]),
        "im_scale_ratio": np.array([e.im_scale_ratio for e in examples],
                                   np.float32),
    }
    if examples[0].gt_boxes is not None:
        out["gt_boxes"] = np.stack([e.gt_boxes for e in examples])
        out["gt_classes"] = np.stack([e.gt_classes for e in examples])
        out["gt_boxes3d"] = np.stack([e.gt_boxes3d for e in examples])
        out["gt_poses"] = np.stack([e.gt_poses for e in examples])
        out["gt_valid"] = np.stack([e.gt_valid for e in examples])
    if examples[0].oracle_boxes is not None:
        out["oracle_boxes"] = np.stack([e.oracle_boxes for e in examples])
        out["oracle_classes"] = np.stack([e.oracle_classes
                                          for e in examples])
        out["oracle_scores"] = np.stack([e.oracle_scores for e in examples])
        out["oracle_valid"] = np.stack([e.oracle_valid for e in examples])
    if all(e.depth is not None for e in examples):
        out["depth"] = np.stack([e.depth for e in examples])
    return out
