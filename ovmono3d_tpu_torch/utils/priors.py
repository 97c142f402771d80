"""Category statistics priors from training annotations.

Reference-exact port of compute_priors (math_util.py:292-496): per category,
mean/std of dimensions and of depth, plus optional 1-D K-means cluster bins
of depth conditioned on 2D box scale (consumed by the cube decode when
cube.dims_priors_enabled / cube.cluster_bins > 1, roi_heads.py:117-143).

Protocol details replicated from the reference:
  - 2D box w/h are rescaled to the TEST resolution the image would run at
    (approx_eval_resolution with INPUT.MIN/MAX_SIZE_TEST) before the 2D
    scale sqrt(h^2+w^2) is formed — so the stored cluster centers live in
    the same space as the network-resolution proposal scales used for bin
    assignment at decode time (roi_heads.py:436-443).
  - With VIRTUAL_DEPTH on, z3d is converted to the virtual-focal space
    (z * real_to_virtual) before statistics — decode produces virtual z and
    multiplies by virtual_to_real afterwards (roi_heads.py:402-411, 546).
  - Cluster centers start geometric (min * base^i, base=(max/min)^(1/(B-1)))
    and iterate best-of k-means with a top-k fill rule for bins holding
    fewer than min_points_for_std members; iteration stops when the rounded
    mean match quality stops improving (math_util.py:404-480).
  - Unseen categories get the reference's dummy stats (dims (1,1,1)/(1,1,1),
    z (50,50)); categories with < min_points_for_std samples get geometric
    anchor-range cluster scales and [100..1]-spaced dummy bin depths with
    std 15 (math_util.py:395-441).
  - Stds are sample stds (pandas ddof=1). Single-sample categories would
    bake NaN stds in the reference; we substitute the dummy stds instead
    (documented deviation — NaN parameters would poison the decode).

A copy of ovmono3d_tpu/utils/priors.py (with approx_eval_resolution of its
utils/geometry.py): the port imports nothing of the JAX package, and a test
holds the copy to it.
"""
from __future__ import annotations

import numpy as np


def approx_eval_resolution(h, w, scale_min: float = 0,
                           scale_max: float = 1e10):
    """Resolution an (h, w) image runs through the model at given a min/max
    scale constraint (math_util.py:262-289; a copy of the JAX package's
    utils/geometry.py function). Host-side helper."""
    orig_h = h
    if scale_min > 0:
        sf = scale_min / min(h, w)
        h, w = h * sf, w * sf
    sf = min(scale_max / max(h, w), 1.0)
    h, w = h * sf, w * sf
    return h, w, h / orig_h


def _std(x: np.ndarray, dummy: float) -> np.ndarray | float:
    """Sample std (ddof=1, pandas semantics); dummy when undefined."""
    x = np.asarray(x, np.float64)
    if x.shape[0] < 2:
        return dummy
    return x.std(axis=0, ddof=1)


def _cluster_scale_means(
    scales: np.ndarray, assignments: np.ndarray, n_bins: int,
    match_quality: np.ndarray, min_points: int,
) -> np.ndarray:
    """compute_cluster_scale_mean (math_util.py:404-420): per-bin mean of
    member scales, bins with < min_points members first filled with the
    top-k best-matching points."""
    out = np.empty(n_bins, np.float32)
    for b in range(n_bins):
        in_cluster = assignments == b
        if in_cluster.sum() < min_points:
            top = np.argsort(-match_quality[:, b], kind="stable")[:min_points]
            in_cluster = in_cluster.copy()
            in_cluster[top] = True
        out[b] = scales[in_cluster].mean()
    return out


def _cluster_bins_for_category(
    scales: np.ndarray, z3d: np.ndarray, n_bins: int,
    min_points: int, max_rounds: int,
) -> tuple[np.ndarray, np.ndarray]:
    """The reference's custom 1-D K-means over 2D scales + per-bin depth
    stats (math_util.py:443-496). Returns (centers [B], z_stats [B, 2])."""
    scales = np.asarray(scales, np.float32)
    max_scale, min_scale = scales.max(), scales.min()
    base = (max_scale / min_scale) ** (1.0 / (n_bins - 1))
    centers = np.asarray(
        [min_scale * base**i for i in range(n_bins)], np.float32
    )

    best_score = -np.inf
    assignments = np.zeros(len(scales), np.int64)
    match_quality = -np.abs(centers[None, :] - scales[:, None])
    for _ in range(max_rounds):
        match_quality = -np.abs(centers[None, :] - scales[:, None])
        scores = match_quality.max(1)
        assignments_round = match_quality.argmax(1)
        round_score = float(scores.mean())
        if np.round(round_score, 5) > best_score:
            best_score = round_score
            assignments = assignments_round
            centers = _cluster_scale_means(
                scales, assignments, n_bins, match_quality, min_points
            )
        else:
            break

    # the quality matrix matching the accepted assignments (for the fill
    # rule below the reference reuses the loop-final match_quality)
    z_stats = np.empty((n_bins, 2), np.float64)
    for b in range(n_bins):
        in_cluster = assignments == b
        if in_cluster.sum() < min_points:
            top = np.argsort(-match_quality[:, b], kind="stable")[:min_points]
            in_cluster = in_cluster.copy()
            in_cluster[top] = True
        zb = z3d[in_cluster]
        z_stats[b, 0] = zb.mean()
        z_stats[b, 1] = _std(zb, 15.0)
    return centers, z_stats


def compute_priors(
    records: list[dict],
    num_classes: int,
    cluster_bins: int = 1,
    min_points_for_std: int = 5,
    max_rounds: int = 1000,
    *,
    virtual_depth: bool = True,
    virtual_focal: float = 512.0,
    test_min: float = 532,
    test_max: float = 896,
    anchor_min: float = 64.0,
    anchor_max: float = 512.0,
):
    """Returns dict with
      dims: [C, 2, 3]   (mean, std) of (w, h, l)
      z:    [C, 2]      (mean, std) of depth (virtual space if virtual_depth)
      z_scales: [C, B]  cluster centers of test-resolution 2D scale
      z_stats:  [C, B, 2] per-cluster depth (mean, std)
    Matches the reference's compute_priors semantics (see module docstring);
    `records` use the loader schema (data/datasets.py): per-record height,
    width, K, annotations with bbox2d XYXY / center_cam / dimensions.
    """
    n_bins = max(cluster_bins, 1)
    dims_per_cat: list[list] = [[] for _ in range(num_classes)]
    z_per_cat: list[list] = [[] for _ in range(num_classes)]
    scale_per_cat: list[list] = [[] for _ in range(num_classes)]

    for rec in records:
        im_h = float(rec.get("height", 0) or 0)
        im_w = float(rec.get("width", 0) or 0)
        K = rec.get("K")
        fy = float(K[1][1]) if K is not None else 0.0
        if im_h <= 0 or im_w <= 0 or fy <= 0:
            continue
        test_h, _, sf = approx_eval_resolution(im_h, im_w, test_min, test_max)
        if virtual_depth:
            # real_to_virtual = 1 / compute_virtual_scale_from_focal_spaces
            # (math_util.py:581-592) with f=fy, H=im_h, f0=virtual_focal,
            # H0=test_h
            real_to_virtual = (virtual_focal * im_h) / (test_h * fy)
        else:
            real_to_virtual = 1.0
        for anno in rec.get("annotations", []):
            cid = anno.get("category_id", -1)
            if cid is None or cid < 0 or cid >= num_classes:
                continue
            if anno.get("ignore", False):
                continue
            if anno.get("dimensions") is None or anno.get("center_cam") is None:
                continue
            x1, y1, x2, y2 = anno["bbox2d"]
            w, h = (x2 - x1) * sf, (y2 - y1) * sf
            dims_per_cat[cid].append(anno["dimensions"])
            z_per_cat[cid].append(anno["center_cam"][2] * real_to_virtual)
            scale_per_cat[cid].append(float(np.hypot(h, w)))

    dims = np.zeros((num_classes, 2, 3), np.float32)
    z = np.zeros((num_classes, 2), np.float32)
    z_scales = np.zeros((num_classes, n_bins), np.float32)
    z_stats = np.zeros((num_classes, n_bins, 2), np.float32)

    for c in range(num_classes):
        n = len(dims_per_cat[c])
        if n > 0:
            d = np.asarray(dims_per_cat[c], np.float64)
            zs = np.asarray(z_per_cat[c], np.float64)
            dims[c, 0] = d.mean(0)
            dims[c, 1] = _std(d, 1.0)
            z[c] = (zs.mean(), _std(zs, 50.0))
        else:
            # reference dummy stats (math_util.py:395-399)
            dims[c, 0] = dims[c, 1] = 1.0
            z[c] = (50.0, 50.0)

        if n_bins > 1:
            if n < min_points_for_std:
                # dummy geometric anchor-range scales + linear depth bins
                # (math_util.py:424-441)
                base = (anchor_max / anchor_min) ** (1.0 / (n_bins - 1))
                z_scales[c] = [anchor_min * base**i for i in range(n_bins)]
                z_stats[c, :, 0] = np.arange(
                    100, 1, -(100 - 1) / n_bins
                )[:n_bins]
                z_stats[c, :, 1] = 15.0
            else:
                centers, stats = _cluster_bins_for_category(
                    np.asarray(scale_per_cat[c], np.float32),
                    np.asarray(z_per_cat[c], np.float64),
                    n_bins, min_points_for_std, max_rounds,
                )
                z_scales[c] = centers
                z_stats[c] = stats
        else:
            z_scales[c] = (
                float(np.mean(scale_per_cat[c])) if n > 0 else 1.0
            )
            z_stats[c, 0] = z[c]

    return {
        "dims": dims,
        "z": z,
        "z_scales": z_scales,
        "z_stats": z_stats,
    }
