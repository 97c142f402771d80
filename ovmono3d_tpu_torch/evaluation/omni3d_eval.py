"""Omni3D-protocol evaluator: COCO-style AP over 2D IoU and exact 3D IoU,
depth-band breakdowns, and the NHD metric.

A copy of ovmono3d_tpu/evaluation/omni3d_eval.py (a test holds the two to
the same results) whose IoU matrices come from the port: ops/iou2d.py
`pairwise_iou` and ops/iou3d.py `pairwise_iou3d`, in f32 on the evaluator's
`device` (CUDA unless the caller asks for the CPU), one call per image. The
JAX copy imports its IoU lazily and pads to power-of-two buckets to reuse
compiled shapes; eager PyTorch needs neither.

Self-contained re-design of cubercnn/evaluation/omni3d_evaluation.py
(SURVEY.md §2.1 #19, ~2.5k lines around pycocotools): the matching /
accumulation protocol is reimplemented in numpy, and — unlike the reference
fork, whose 3D mode is broken because the `computeIoU` override is missing
(SURVEY.md §5.1) — 3D mode here explicitly computes exact oriented 3D IoU via
the polytope-clipping kernel (ops/iou3d.py) on device.

Protocol constants (Omni3DParams, omni3d_evaluation.py:1394-1461):
  2D IoU thresholds: 0.50 : 0.05 : 0.95
  3D IoU thresholds: 0.05 : 0.05 : 0.50
  recall thresholds: 0 : 0.01 : 1 (101 points)
  3D "area" bands = GT depth: all / near (<10 m) / medium (10-35 m) / far
  2D "area" bands = GT pixel area: all / small / medium / large (32^2, 96^2)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ovmono3d_tpu_torch.ops.iou2d import pairwise_iou
from ovmono3d_tpu_torch.ops.iou3d import pairwise_iou3d
from ovmono3d_tpu_torch.utils.device import resolve_device
from ovmono3d_tpu_torch.utils.geometry import CORNER_SIGNS

# Exact linspace construction as Omni3DParams (omni3d_evaluation.py:1404-1435
# "np.arange causes trouble"), so threshold/recall grid floats are
# bit-identical to the reference's.
IOU_THRS_2D = np.linspace(0.5, 0.95, 10, endpoint=True)
IOU_THRS_3D = np.linspace(0.05, 0.5, 10, endpoint=True)
REC_THRS = np.linspace(0.0, 1.00, 101, endpoint=True)
# Band intervals are CLOSED on both ends (pycocotools evaluateImg keeps a box
# when aRng[0] <= measure <= aRng[1]) — a boundary value (depth exactly 10,
# area exactly 32^2) counts in BOTH adjacent bands, like the reference.
DEPTH_BANDS = {
    # Upper bounds are the reference's FINITE caps (Omni3DParams
    # setDet3DParams areaRng [[0,1e5],[0,10],[10,35],[35,1e5]]): a
    # degenerate measure beyond the cap (garbage predicted depth from
    # random/early-training weights) is band-ignored there, not an FP.
    "all": (0.0, 1e5),
    "near": (0.0, 10.0),
    "medium": (10.0, 35.0),
    "far": (35.0, 1e5),
}
# 2D mode buckets by GT pixel area, the COCO convention the reference's 2D
# params keep (Omni3DParams.setDet2DParams: 32^2 / 96^2 boundaries,
# 1e5^2 cap).
AREA_BANDS_2D = {
    "all": (0.0, 1e5**2),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e5**2),
}
MAX_DETS = 100  # per-(image, category) cap applied BEFORE matching
# Matched-pair IoU gate for NHD / disentangled-NHD / error stats
# (Omni3DevalWithNHD iou_threshold_for_disentangled_metrics default,
# omni3d_evaluation.py:2294-2296).
NHD_IOU_THRESH = 0.5
                # (COCOeval.evaluateImg dt[0:maxDet], maxDets[-1])


@dataclass
class ImageEval:
    """Per-(image, category) matching results for all IoU thresholds."""

    det_scores: np.ndarray      # [D]
    det_matched: np.ndarray     # [T, D] matched gt index or -1
    det_ignored: np.ndarray     # [T, D] bool (matched to ignore gt)
    num_gt: int                 # countable (non-ignore) gt
    det_far: np.ndarray | None = None  # [D] bool: outside every GT's
                                       # proximity (eval_prox mode)
    nhd: dict | None = None     # NHD values for matched pairs (3D mode)


def _greedy_match(
    iou: np.ndarray,        # [D, G] det x gt, dets sorted by descending score
    gt_ignore: np.ndarray,  # [G] bool
    thresholds: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """COCOeval evaluateImg greedy matching for every threshold.

    Vectorized over thresholds: per detection, the candidate-gt scan keeps
    [T]-wide running state (best IoU / best gt / gt-used bookkeeping per
    threshold), so the Python work is O(D x candidates) instead of the naive
    O(T x D x G) triple loop (reference semantics:
    omni3d_evaluation.py:1467-1688, COCOeval.evaluateImg).

    Scan rules (pycocotools evaluateImg exactly; parity-tested against a
    direct transcription of its loop in tests/test_evaluator.py):
      - gts are scanned IGNORES-LAST (gtind = argsort(_ignore, mergesort)),
        so a det holding any real-gt match never takes an ignore gt — even
        one with higher IoU (the `break` on reaching the ignore section)
      - every matched gt is consumed per threshold, ignores included
        (iscrowd is always False in this protocol, datasets.py:257)
      - equal IoU prefers the later gt in scan order (>= comparison)

    Returns (matched [T, D] ORIGINAL gt idx or -1, ignored [T, D]).
    """
    D, G = iou.shape
    T = len(thresholds)
    matched = -np.ones((T, D), np.int64)
    ignored = np.zeros((T, D), bool)
    if D == 0 or G == 0:
        return matched, ignored
    # ignores-last stable scan order (COCOeval gtind)
    order = np.argsort(gt_ignore.astype(np.int8), kind="stable")
    iou_s = iou[:, order]
    ign_s = np.asarray(gt_ignore, bool)[order]
    base = np.minimum(thresholds.astype(np.float64), 1 - 1e-10)
    min_thr = base.min()
    gt_used = np.zeros((T, G), bool)
    t_idx = np.arange(T)
    for d in range(D):
        iou_d = iou_s[d]
        cand = np.nonzero(iou_d >= min_thr)[0]
        if cand.size == 0:
            continue
        best_iou = base.copy()                  # [T]
        best_g = np.full(T, -1, np.int64)
        best_ign = np.zeros(T, bool)
        for g in cand:
            v = iou_d[g]
            ok = (v >= best_iou) & ~gt_used[:, g]
            if ign_s[g]:
                # the `break`: a held real match blocks the ignore section
                ok &= ~((best_g >= 0) & ~best_ign)
            if not ok.any():
                continue
            best_iou = np.where(ok, v, best_iou)
            best_g = np.where(ok, g, best_g)
            best_ign = np.where(ok, ign_s[g], best_ign)
        sel = best_g >= 0
        if sel.any():
            matched[sel, d] = order[best_g[sel]]
            ignored[sel, d] = best_ign[sel]
            gt_used[t_idx[sel], best_g[sel]] = True
    return matched, ignored


def corners_diag(corners: np.ndarray) -> np.ndarray:
    """GT normalization diagonal per box: the AXIS-ALIGNED bounding diagonal
    of the (rotated) corner set — `gt_vertices.max(0) - gt_vertices.min(0)`
    in the reference (calculate_nhd, omni3d_evaluation.py:2244), NOT the
    rigid box diagonal."""
    return np.linalg.norm(
        corners.max(axis=-2) - corners.min(axis=-2), axis=-1
    )


def hungarian_corner_distance(
    pred: np.ndarray, gt: np.ndarray
) -> np.ndarray:
    """SUM of Hungarian-matched L2 distances between 8-corner sets
    (reference NHD core, omni3d_evaluation.py:2227-2247 sums the matched
    costs before dividing by the diagonal). pred/gt: [N, 8, 3]."""
    from scipy.optimize import linear_sum_assignment

    out = np.zeros(pred.shape[0])
    for i in range(pred.shape[0]):
        cost = np.linalg.norm(
            pred[i][:, None, :] - gt[i][None, :, :], axis=-1
        )
        r, c = linear_sum_assignment(cost)
        out[i] = cost[r, c].sum()
    return out


def disentangled_nhd(pred: dict, gt: dict) -> dict[str, np.ndarray]:
    """Per-pair disentangled NHDs (omni3d_evaluation.py:2250-2290).

    pred/gt: dicts with center [N, 3], dims [N, 3] (w,h,l), pose [N, 3, 3],
    index-aligned matched pairs. For each component, build the cuboid from GT
    with ONLY that component replaced by the prediction, then
    Hungarian-corner distance / GT diagonal.
    """
    signs = np.asarray(CORNER_SIGNS, np.float64)

    def corners(center, dims, pose):
        # Pure numpy mirror of utils.geometry.cuboid_corners (x scaled by
        # L, y by H, z by W): this runs per matched pair per image in the
        # eval loop, on numpy.
        dims = np.asarray(dims, np.float64)
        scale = np.stack([dims[:, 2], dims[:, 1], dims[:, 0]], axis=-1)
        local = signs[None] * scale[:, None, :]
        local = np.einsum("nij,nkj->nki", np.asarray(pose, np.float64),
                          local)
        return local + np.asarray(center, np.float64)[:, None, :]

    gt_corners = corners(gt["center"], gt["dims"], gt["pose"])
    diag = np.maximum(corners_diag(gt_corners), 1e-8)

    out = {}
    # xy: predicted x/y at GT depth.
    c_xy = np.concatenate(
        [pred["center"][:, :2], gt["center"][:, 2:3]], axis=1
    )
    out["xy"] = hungarian_corner_distance(
        corners(c_xy, gt["dims"], gt["pose"]), gt_corners
    ) / diag
    # z: predicted depth at GT x/y.
    c_z = np.concatenate(
        [gt["center"][:, :2], pred["center"][:, 2:3]], axis=1
    )
    out["z"] = hungarian_corner_distance(
        corners(c_z, gt["dims"], gt["pose"]), gt_corners
    ) / diag
    out["dims"] = hungarian_corner_distance(
        corners(gt["center"], pred["dims"], gt["pose"]), gt_corners
    ) / diag
    out["pose"] = hungarian_corner_distance(
        corners(gt["center"], gt["dims"], pred["pose"]), gt_corners
    ) / diag
    return out


class Omni3DEvaluator:
    """Accumulates per-image predictions and computes AP2D / AP3D / NHD.

    Usage:
      ev = Omni3DEvaluator(num_classes, mode="3D", device="cpu")
      ev.add_image(gt=..., pred=...)   # numpy dicts, see add_image
      results = ev.summarize()
    """

    def __init__(self, num_classes: int, mode: str = "3D",
                 class_names: list[str] | None = None,
                 eval_prox: bool = False, proximity_thresh: float = 0.3,
                 device=None):
        assert mode in ("2D", "3D")
        # The IoU matrices are computed here: CUDA unless the caller asks
        # for another device.
        self.device = resolve_device(device)
        self.mode = mode
        self.num_classes = num_classes
        self.class_names = class_names or [str(i) for i in range(num_classes)]
        # "Proximity evaluation" for non-exhaustively annotated datasets
        # (Omni3DParams.proximity_thresh; reference enables it for
        # Objectron/SUNRGBD, omni3d_evaluation.py:263, 1459-1461):
        # detections farther than proximity_thresh IoU from EVERY GT are
        # ignored instead of counted as false positives.
        self.eval_prox = eval_prox
        self.proximity_thresh = proximity_thresh
        self.iou_thrs = IOU_THRS_3D if mode == "3D" else IOU_THRS_2D
        # 3D buckets by GT depth, 2D by GT pixel area (Omni3DParams).
        self.bands = DEPTH_BANDS if mode == "3D" else AREA_BANDS_2D
        # evals[band][cat] -> list of ImageEval
        self.evals: dict[str, dict[int, list[ImageEval]]] = {
            band: {c: [] for c in range(num_classes)} for band in self.bands
        }
        self._nhd_values: list[float] = []
        self._nhd_dis: dict[str, list[float]] = {
            "xy": [], "z": [], "dims": [], "pose": []
        }
        # Mean prediction errors over matched pairs
        # (reference vis.py:289-294 log line).
        self._errors: dict[str, list[float]] = {
            "xy_px": [], "z_m": [], "whl_m": [], "ry_rad": []
        }

    # -- IoU ---------------------------------------------------------------

    def _iou_2d(self, det_boxes, gt_boxes):
        D, G = len(det_boxes), len(gt_boxes)
        if D == 0 or G == 0:
            return np.zeros((D, G))
        db, gb = (torch.as_tensor(np.asarray(b), dtype=torch.float32)
                  .to(self.device) for b in (det_boxes, gt_boxes))
        return pairwise_iou(db, gb).cpu().numpy()

    def _iou_3d(self, det_corners, gt_corners):
        D, G = len(det_corners), len(gt_corners)
        if D == 0 or G == 0:
            return np.zeros((D, G))
        dc, gc = (torch.as_tensor(np.asarray(c), dtype=torch.float32)
                  .to(self.device) for c in (det_corners, gt_corners))
        return pairwise_iou3d(dc, gc)[1].cpu().numpy()

    # -- accumulation --------------------------------------------------------

    def add_image(self, gt: dict, pred: dict):
        """Add one image.

        gt: dict with
          classes [G] int (-1 = class-agnostic ignore region),
          ignore [G] bool optional (per-category ignore: the gt keeps its
          true class and absorbs only same-class detections, the reference's
          ignore2D/ignore3D flag semantics — omni3d_evaluation.py:1531-1534,
          data/datasets.py:258-260), boxes2d [G, 4] xyxy,
          corners3d [G, 8, 3] (3D mode), depths [G] (gt z; for bands).
        pred: dict with
          classes [D], scores [D], boxes2d [D, 4],
          corners3d [D, 8, 3] (3D mode).
        """
        g_classes = np.asarray(gt.get("classes", np.zeros(0, np.int64)))
        d_classes = np.asarray(pred.get("classes", np.zeros(0, np.int64)))
        d_scores = np.asarray(pred.get("scores", np.zeros(0)))
        g_ignore_flags = np.asarray(
            gt.get("ignore", np.zeros(len(g_classes), bool)), bool
        )

        # One device IoU launch per image over the FULL det x gt matrix,
        # sliced per category below (vs one launch per (image, category) —
        # the per-image matching math is unchanged).
        if len(d_classes) and len(g_classes):
            if self.mode == "3D":
                full_iou = self._iou_3d(
                    np.asarray(pred["corners3d"]), np.asarray(gt["corners3d"])
                )
            else:
                full_iou = self._iou_2d(
                    np.asarray(pred["boxes2d"]), np.asarray(gt["boxes2d"])
                )
        else:
            full_iou = np.zeros((len(d_classes), len(g_classes)))

        # Proximity evaluation is defined on the GT *2D* boxes in BOTH
        # modes ("evaluates detections in the proximity of the ground
        # truth 2D boxes", omni3d_evaluation.py:1483-84): gating 3D mode
        # on 3D IoU < 0.3 would ignore nearly every unmatched detection
        # (3D IoU collapses with any depth error) and silently delete the
        # FP stream from AP3D.
        full_iou_prox = None
        if self.eval_prox and len(d_classes) and len(g_classes):
            full_iou_prox = (
                full_iou if self.mode == "2D"
                else self._iou_2d(
                    np.asarray(pred["boxes2d"]), np.asarray(gt["boxes2d"])
                )
            )

        for c in range(self.num_classes):
            d_sel = np.where(d_classes == c)[0]
            g_sel = np.where((g_classes == c) | (g_classes == -1))[0]
            if len(d_sel) == 0 and len(g_sel) == 0:
                continue
            order = np.argsort(-d_scores[d_sel], kind="mergesort")
            d_sel = d_sel[order][:MAX_DETS]
            gt_ignore_base = (g_classes[g_sel] == -1) | g_ignore_flags[g_sel]
            iou = full_iou[np.ix_(d_sel, g_sel)]

            det_far = None
            if self.eval_prox:
                if full_iou_prox is not None and len(g_sel):
                    iou_prox = full_iou_prox[np.ix_(d_sel, g_sel)]
                    det_far = iou_prox.max(axis=1) < self.proximity_thresh
                else:
                    det_far = np.ones(len(d_sel), bool)
            # Band measure: GT depth / det predicted depth in 3D mode,
            # GT / det box pixel areas in 2D mode (COCOeval 'area').
            if self.mode == "3D":
                gt_metric = np.asarray(
                    gt.get("depths", np.zeros(len(g_classes)))
                )[g_sel]
                if "center" in pred and len(d_sel):
                    det_metric = np.asarray(pred["center"])[d_sel, 2]
                elif len(d_sel):
                    det_metric = np.asarray(
                        pred["corners3d"]
                    )[d_sel][:, :, 2].mean(axis=1)
                else:
                    det_metric = np.zeros(0)
            else:
                def _areas(boxes, sel):
                    b = np.asarray(boxes, float)[sel]
                    if not len(b):
                        return np.zeros(0)
                    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

                gt_metric = _areas(gt["boxes2d"], g_sel)
                det_metric = _areas(pred["boxes2d"], d_sel)
            for band, (lo, hi) in self.bands.items():
                in_band = (gt_metric >= lo) & (gt_metric <= hi)
                gt_ignore = gt_ignore_base | ~in_band
                matched, ignored = _greedy_match(
                    iou, gt_ignore, self.iou_thrs
                )
                # COCOeval evaluateImg: UNMATCHED detections whose own
                # area/depth lies outside the band are ignored rather than
                # counted as false positives (dtIg |= dtm==0 & aout).
                det_out = ~((det_metric >= lo) & (det_metric <= hi))
                ignored = ignored | ((matched < 0) & det_out[None, :])
                self.evals[band][c].append(
                    ImageEval(
                        det_scores=d_scores[d_sel],
                        det_matched=matched,
                        det_ignored=ignored,
                        num_gt=int((~gt_ignore).sum()),
                        det_far=det_far,
                    )
                )

            # NHD pairs (Omni3DevalWithNHD.evaluateImg intent,
            # omni3d_evaluation.py:2380-2399): per detection (score order,
            # maxDet-capped), the single best-IoU GT of the SAME category
            # (the reference's gt list is _gts[imgId, catId] — out-of-vocab
            # class -1 anns never appear there; its ignored in-vocab GTs
            # do, scanned ignore-last so a non-ignored GT wins exact ties)
            # — paired when IoU >= 0.5; one GT may pair with multiple
            # detections (no one-to-one constraint). The reference
            # re-collects the identical pairs once per area band, which
            # leaves every reported MEAN unchanged; we collect once.
            # NOTE: the reference AS SHIPPED collects zero pairs — a
            # documented defect we do not replicate (PARITY.md, defect #4:
            # its `ious[...][0]` row-slice makes every lookup raise and
            # the blanket except skips all pairs).
            g_cmask = g_classes[g_sel] == c
            if self.mode == "3D" and len(d_sel) and g_cmask.any():
                g_c = g_sel[g_cmask]
                g_order = np.argsort(g_ignore_flags[g_c], kind="mergesort")
                iou_o = iou[:, g_cmask][:, g_order]
                best = iou_o.argmax(axis=1)
                best_iou = iou_o[np.arange(len(d_sel)), best]
                ok = best_iou >= NHD_IOU_THRESH
                if ok.any():
                    d_idx = d_sel[ok]
                    g_idx = g_c[g_order[best[ok]]]
                    pc = np.asarray(pred["corners3d"])[d_idx]
                    gc = np.asarray(gt["corners3d"])[g_idx]
                    nhd = hungarian_corner_distance(pc, gc) / np.maximum(
                        corners_diag(gc), 1e-8
                    )
                    self._nhd_values.extend(nhd.tolist())
                    self._matched_pair_metrics(pred, gt, d_idx, g_idx)

    def _matched_pair_metrics(self, pred, gt, d_idx, g_idx):
        """Disentangled NHD + mean prediction errors over the SAME IoU-matched
        pairs the plain NHD uses (reference computes NHD on matched pairs
        inside the evaluator, omni3d_evaluation.py:2370-2426; the error line
        is vis.py:289-294). Correct for RPN/GDINO predictions, not just the
        index-aligned oracle protocol."""
        keys = ("center", "dims", "pose")
        if not (all(k in pred for k in keys) and all(k in gt for k in keys)):
            return
        p = {k: np.asarray(pred[k], np.float64)[d_idx] for k in keys}
        g = {k: np.asarray(gt[k], np.float64)[g_idx] for k in keys}
        for k, v in disentangled_nhd(p, g).items():
            self._nhd_dis[k].extend(v.tolist())
        if "center_2d" in pred and "center_2d" in gt:
            dxy = np.linalg.norm(
                np.asarray(pred["center_2d"])[d_idx]
                - np.asarray(gt["center_2d"])[g_idx], axis=-1,
            )
            self._errors["xy_px"].extend(dxy.tolist())
        self._errors["z_m"].extend(
            np.abs(p["center"][:, 2] - g["center"][:, 2]).tolist()
        )
        self._errors["whl_m"].extend(
            np.abs(p["dims"] - g["dims"]).mean(-1).tolist()
        )
        rel = np.einsum("nij,nkj->nik", p["pose"], g["pose"])
        tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
        self._errors["ry_rad"].extend(np.arccos(tr).tolist())

    # -- summarization -------------------------------------------------------

    def _pr_curves(self, band: str, max_dets: int | None = None):
        """COCOeval.accumulate: precision [T, R, K] and recall [T, K].

        `max_dets` truncates each image's (score-sorted) detection list to
        its first k entries — the AR1/AR10/AR100 maxDets axis."""
        T = len(self.iou_thrs)
        K = self.num_classes
        precision = -np.ones((T, len(REC_THRS), K))
        recall = -np.ones((T, K))
        ap_valid = np.zeros(K, bool)
        k = max_dets if max_dets is not None else None
        for c in range(K):
            evs = self.evals[band][c]
            if not evs:
                continue
            scores = np.concatenate([e.det_scores[:k] for e in evs])
            matched = np.concatenate(
                [e.det_matched[:, :k] for e in evs], axis=1
            )
            ignored = np.concatenate(
                [e.det_ignored[:, :k] for e in evs], axis=1
            )
            far = np.concatenate([
                (e.det_far if e.det_far is not None
                 else np.zeros(len(e.det_scores), bool))[:k]
                for e in evs
            ])
            npig = sum(e.num_gt for e in evs)
            if npig == 0:
                continue
            ap_valid[c] = True
            order = np.argsort(-scores, kind="mergesort")
            matched = matched[:, order]
            ignored = ignored[:, order]
            far = far[order]
            tps = (matched >= 0) & ~ignored
            # Unmatched dets are FPs — except out-of-band ones (ignored is
            # set for matched-to-ignore-gt AND unmatched-out-of-band dets,
            # COCOeval dtIg) and, in proximity mode, dets outside every
            # GT's neighborhood.
            fps = (matched < 0) & ~ignored & ~far[None, :]
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            nd = tp_cum.shape[1]
            if nd == 0:
                recall[:, c] = 0
                precision[:, :, c] = 0
                continue
            rc = tp_cum / npig                                      # [T, N]
            pr = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
            recall[:, c] = rc[:, -1]
            # Monotone precision envelope (reversed running max).
            pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
            for t in range(T):
                inds = np.searchsorted(rc[t], REC_THRS, side="left")
                valid = inds < nd
                q = np.zeros(len(REC_THRS))
                q[valid] = pr[t, inds[valid]]
                precision[t, :, c] = q
        return precision, recall, ap_valid

    @staticmethod
    def _mean_valid(x: np.ndarray) -> float:
        v = x[x > -1]
        return float(v.mean()) if v.size else float("nan")

    def summarize(self) -> dict[str, float]:
        """13-stat summary in the spirit of Omni3Deval.summarize
        (omni3d_evaluation.py:2072-2224), scaled to percentages."""
        out: dict[str, float] = {}
        prec_all, rec_all, _ = self._pr_curves("all")
        tag = "AP3D" if self.mode == "3D" else "AP2D"
        out[tag] = 100 * self._mean_valid(prec_all)
        thr_list = (
            [(0.15, "15"), (0.25, "25"), (0.50, "50")]
            if self.mode == "3D"
            else [(0.50, "50"), (0.75, "75"), (0.95, "95")]
        )
        for thr, name in thr_list:
            ti = int(np.argmin(np.abs(self.iou_thrs - thr)))
            out[f"{tag}@{name}"] = 100 * self._mean_valid(prec_all[ti])
        sub_bands = (
            ("near", "medium", "far") if self.mode == "3D"
            else ("small", "medium", "large")
        )
        ar_tag = f"AR{'3D' if self.mode == '3D' else '2D'}"
        for band in sub_bands:
            p, r, _ = self._pr_curves(band)
            out[f"{tag}-{band[0].upper()}"] = 100 * self._mean_valid(p)
            # banded AR at maxDets=100 (reference stats[10:13]).
            out[f"{ar_tag}-{band[0].upper()}"] = 100 * self._mean_valid(r)
        out[ar_tag] = 100 * self._mean_valid(rec_all)
        # AR at the smaller maxDets caps (COCO AR1/AR10; the headline AR is
        # AR100 — per-image lists are never longer than 100 here).
        for cap in (1, 10):
            _, rec_k, _ = self._pr_curves("all", max_dets=cap)
            out[f"{ar_tag}@{cap}"] = 100 * self._mean_valid(rec_k)
        if self.mode == "3D" and self._nhd_values:
            out["NHD"] = float(np.mean(self._nhd_values))
        return out

    def per_category_ap(self) -> dict[str, float]:
        prec, _, valid = self._pr_curves("all")
        out = {}
        for c in range(self.num_classes):
            if valid[c]:
                out[self.class_names[c]] = 100 * self._mean_valid(
                    prec[:, :, c]
                )
        return out

    def per_category_ar(self) -> dict[str, float]:
        """Per-category AR over the 'all' band at maxDets=100 (the
        reference's "AR-{name}" rows, omni3d_evaluation.py:477-484)."""
        _, rec, valid = self._pr_curves("all")
        out = {}
        for c in range(self.num_classes):
            if valid[c]:
                out[self.class_names[c]] = 100 * self._mean_valid(rec[:, c])
        return out
