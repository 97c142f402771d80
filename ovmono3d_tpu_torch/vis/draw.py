"""2D boxes and projected 3D cuboids drawn on images, the bird's-eye view,
the evaluation's pred-vs-GT panels, the shaded scene view and the demo's
panel, in numpy (counterpart of ovmono3d_tpu/vis/draw.py, which draws with
cv2; the machine with the card has no OpenCV).

The rasterizer paints every pixel whose centre lies within half the
thickness of a segment (round ends, as cv2's thick lines), and for the
cuboids' edges (cv2's LINE_AA) a one-pixel fringe blended by coverage: it
lands within a pixel of cv2's `rectangle` and antialiased `line`.
Labels use a 3 x 5 bitmap font at twice its size (ASCII; lower case drawn
as upper case, characters it lacks as a box), not cv2's Hershey font.
Panels are joined with np.concatenate (cv2's hconcat / vconcat), and the
demo panel's bird's-eye view is resized by `utils/image.py`
`resize_bilinear` (cv2.resize's INTER_LINEAR filter), rounded to uint8.
"""
from __future__ import annotations

import numpy as np
import torch

from ovmono3d_tpu_torch.utils.image import resize_bilinear
from ovmono3d_tpu_torch.utils.util import get_color

# Wireframe edges of the reference's corner ordering (math_util diagram).
CUBOID_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),   # front face (z-)
    (4, 5), (5, 6), (6, 7), (7, 4),   # back face (z+)
    (0, 4), (1, 5), (2, 6), (3, 7),   # connections
]

# 3 x 5 glyphs, rows top to bottom, "#" painted.
_GLYPHS = {
    " ": "...............", "0": "####.##.##.####", "1": ".#.##..#..#.###",
    "2": "###..#####..###", "3": "###..#.##..####", "4": "#.##.####..#..#",
    "5": "####..###..####", "6": "####..####.####", "7": "###..#..#.#..#.",
    "8": "####.#####.####", "9": "####.####..####", "A": ".#.#.#####.##.#",
    "B": "##.#.###.#.###.", "C": ".###..#..#...##", "D": "##.#.##.##.###.",
    "E": "####..##.#..###", "F": "####..##.#..#..", "G": ".###..#.##.#.##",
    "H": "#.##.#####.##.#", "I": "###.#..#..#.###", "J": "..#..#..##.#.#.",
    "K": "#.##.###.#.##.#", "L": "#..#..#..#..###", "M": "#.########.##.#",
    "N": "##.#.##.##.##.#", "O": ".#.#.##.##.#.#.", "P": "##.#.###.#..#..",
    "Q": ".#.#.##.####.##", "R": "##.#.###.#.##.#", "S": ".###...#...###.",
    "T": "###.#..#..#..#.", "U": "#.##.##.##.####", "V": "#.##.##.##.#.#.",
    "W": "#.##.########.#", "X": "#.##.#.#.#.##.#", "Y": "#.##.#.#..#..#.",
    "Z": "###..#.#.#..###", ".": ".............#.", ",": "..........#.#..",
    "-": "......###......", "_": "............###", ":": "....#.....#....",
    "/": "..#..#.#.#..#..", "(": ".#.#..#..#...#.", ")": ".#...#..#..#.#.",
    "%": "#.#..#.#.#..#.#", "+": "....#.###.#....", "=": "...###...###...",
    "'": ".#..#..........", "!": ".#..#..#.....#.", "?": "##...#.#.....#.",
    "#": "#.####.####.#.#", "*": "#.#.#.#.#.#....",
}
_BOX = "####.##.##.####"
_SCALE = 2


def _glyph(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch.upper(), _BOX).ljust(15, ".")
    return np.array([c == "#" for c in rows[:15]]).reshape(5, 3)


def _paint(out: np.ndarray, mask: np.ndarray, y0: int, x0: int,
           color) -> None:
    """Paint `mask`'s true pixels at offset (y0, x0), clipped to `out`."""
    h, w = out.shape[:2]
    ys, xs = np.nonzero(mask)
    ys, xs = ys + y0, xs + x0
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    out[ys[keep], xs[keep]] = color


def draw_line(out: np.ndarray, p0, p1, color, thickness: int = 1,
              antialias: bool = False) -> None:
    """Paint the segment p0-p1 ((x, y) pixel centres) in place: every pixel
    within thickness / 2 of it; with `antialias`, also a one-pixel fringe
    blended by coverage (the footprint of cv2's LINE_AA)."""
    r = max(thickness, 1) / 2.0
    reach = r + 1.0 if antialias else r
    (x0, y0), (x1, y1) = (np.asarray(p, np.float64) for p in (p0, p1))
    h, w = out.shape[:2]
    lo_x = max(int(np.floor(min(x0, x1) - reach)), 0)
    lo_y = max(int(np.floor(min(y0, y1) - reach)), 0)
    hi_x = min(int(np.ceil(max(x0, x1) + reach)), w - 1)
    hi_y = min(int(np.ceil(max(y0, y1) + reach)), h - 1)
    if lo_x > hi_x or lo_y > hi_y:
        return
    ys, xs = np.mgrid[lo_y:hi_y + 1, lo_x:hi_x + 1].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    t = np.clip(((xs - x0) * dx + (ys - y0) * dy)
                / max(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
    d = np.hypot(xs - x0 - t * dx, ys - y0 - t * dy)
    if not antialias:
        _paint(out, d <= r, lo_y, lo_x, color)
        return
    alpha = np.clip(reach - d, 0.0, 1.0)[..., None]
    region = out[lo_y:hi_y + 1, lo_x:hi_x + 1]
    blended = region * (1.0 - alpha) + np.asarray(color, np.float64) * alpha
    region[...] = np.where(alpha > 0, np.rint(blended), region).astype(
        out.dtype)


def draw_rectangle(out: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                   color, thickness: int = 1) -> None:
    """The outline of the box (x1, y1)-(x2, y2) in place."""
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    for i in range(4):
        draw_line(out, corners[i], corners[(i + 1) % 4], color, thickness)


def draw_text(out: np.ndarray, text: str, org, color) -> None:
    """`text` with its baseline's left end at org = (x, y), in place."""
    x, y = org
    top = y - 5 * _SCALE + 1
    for ch in text:
        mask = np.kron(_glyph(ch), np.ones((_SCALE, _SCALE), bool))
        _paint(out, mask, top, x, color)
        x += 4 * _SCALE


def draw_boxes_2d(image: np.ndarray, boxes: np.ndarray,
                  labels: list[str] | None = None,
                  scores: np.ndarray | None = None,
                  color=None) -> np.ndarray:
    """A copy of `image` with each [x1, y1, x2, y2] box outlined (2 px) and
    its label and score above it."""
    out = np.ascontiguousarray(np.asarray(image).copy())
    for i, box in enumerate(np.asarray(boxes)):
        c = color or get_color(i)
        x1, y1, x2, y2 = [int(round(v)) for v in box]
        draw_rectangle(out, x1, y1, x2, y2, c, 2)
        text = labels[i] if labels is not None else ""
        if scores is not None:
            text += f" {scores[i]:.2f}"
        if text:
            draw_text(out, text, (x1, max(y1 - 4, 10)), c)
    return out


def draw_cuboid_3d(image: np.ndarray, corners3d: np.ndarray, K: np.ndarray,
                   color=None, min_z: float = 0.05,
                   thickness: int = 2) -> np.ndarray:
    """A copy of `image` with the wireframe of 8 camera-space corners
    projected by K; an edge with both ends at z <= min_z is dropped, one
    with one end there is clipped to the z = min_z plane (the reference's
    draw_3d_box_from_verts)."""
    out = np.ascontiguousarray(np.asarray(image).copy())
    corners3d = np.asarray(corners3d, np.float64)
    K = np.asarray(K, np.float64)
    z = corners3d[:, 2]
    proj = (K @ corners3d.T).T
    uv = proj[:, :2] / np.maximum(proj[:, 2:3], 1e-9)
    c = color or (40, 220, 100)
    for a, b in CUBOID_EDGES:
        if z[a] <= min_z and z[b] <= min_z:
            continue
        if z[a] <= min_z or z[b] <= min_z:
            pa, pb = corners3d[a], corners3d[b]
            if z[a] <= min_z:
                pa, pb = pb, pa                  # pa in front
            t = (min_z - pa[2]) / (pb[2] - pa[2] + 1e-12)
            pb = pa + t * (pb - pa)
            qa = (K @ pa)[:2] / max(pa[2], 1e-9)
            qb = (K @ pb)[:2] / max(pb[2], 1e-9)
        else:
            qa, qb = uv[a], uv[b]
        draw_line(out, [int(round(v)) for v in qa],
                  [int(round(v)) for v in qb], c, thickness, antialias=True)
    return out


def draw_bev(corners3d_list, extent: float = 10.0, size: int = 400,
             colors=None) -> np.ndarray:
    """Bird's-eye-view panel [size, size, 3] on white: each cuboid's xz
    footprint (corners 0, 1, 5, 4), `extent` metres across, the camera at
    the bottom centre (vis.py:26 BEV)."""
    canvas = np.full((size, size, 3), 255, np.uint8)

    def to_px(x, zz):
        return (int(round((x / extent + 0.5) * size)),
                int(round(size - zz / extent * size)))

    for i, corners in enumerate(corners3d_list):
        corners = np.asarray(corners)
        c = colors[i] if colors else get_color(i)
        pts = [to_px(p[0], p[2]) for p in corners[[0, 1, 5, 4]]]
        for j in range(4):
            draw_line(canvas, pts[j], pts[(j + 1) % 4], c, 2, antialias=True)
    return canvas


def pred_vs_gt_panels(image, K, gt: dict, pred: dict,
                      class_names: list[str] | None = None,
                      prompted_ids: set[int] | None = None,
                      score_thres: float | None = None) -> np.ndarray:
    """3 x 2 evaluation panel grid (the reference's visualize_from_instances,
    vis.py:76-296): columns GT of all classes | GT of the evaluated
    (prompted) classes | predictions; rows 2D boxes | 3D wireframes. A
    prediction's wireframe is drawn when its score passes `score_thres`,
    by default sqrt(1 / n_classes) * 1.2 (vis.py:103-104).

    gt / pred: evaluation dicts (classes [N], boxes2d [N, 4] xyxy,
    corners3d [N, 8, 3]; pred also scores [N])."""
    g_cls = np.asarray(gt.get("classes", np.zeros(0, np.int64)))
    p_cls = np.asarray(pred.get("classes", np.zeros(0, np.int64)))
    p_scores = np.asarray(pred.get("scores", np.ones(len(p_cls))))
    if score_thres is None:
        n_cats = max(len(class_names) if class_names else 1, 1)
        score_thres = float(np.sqrt(1.0 / n_cats) * 1.2)

    def name(c):
        return class_names[int(c)] if class_names else str(int(c))

    def column(classes, boxes2d, corners3d, keep, scores=None):
        im2d = np.ascontiguousarray(np.asarray(image).copy())
        im3d = np.ascontiguousarray(np.asarray(image).copy())
        for i in np.flatnonzero(keep):
            c = get_color(int(classes[i]))
            im2d = draw_boxes_2d(
                im2d, boxes2d[i:i + 1], [name(classes[i])],
                None if scores is None else scores[i:i + 1], color=c)
            if corners3d is not None and (scores is None
                                          or scores[i] > score_thres):
                im3d = draw_cuboid_3d(im3d, corners3d[i], K, color=c)
        return im2d, im3d

    g_boxes = np.asarray(gt.get("boxes2d", np.zeros((0, 4))))
    g_corners = np.asarray(gt["corners3d"]) if "corners3d" in gt else None
    p_boxes = np.asarray(pred.get("boxes2d", np.zeros((0, 4))))
    p_corners = (np.asarray(pred["corners3d"]) if "corners3d" in pred
                 else None)
    all_keep = g_cls >= 0
    eval_keep = (all_keep if prompted_ids is None
                 else all_keep & np.isin(g_cls, list(prompted_ids)))
    c1 = column(g_cls, g_boxes, g_corners, all_keep)
    c2 = column(g_cls, g_boxes, g_corners, eval_keep)
    c3 = column(p_cls, p_boxes, p_corners, np.ones(len(p_cls), bool),
                p_scores)
    top = np.concatenate([c1[0], c2[0], c3[0]], axis=1)
    bottom = np.concatenate([c1[1], c2[1], c3[1]], axis=1)
    return np.concatenate([top, bottom], axis=0)


def draw_scene_view(image, K, corners3d_list, colors=None,
                    novel_angle_deg: float = 45.0) -> np.ndarray:
    """The cuboids shaded on the image | shaded from a camera orbited
    `novel_angle_deg` upward about the scene centroid, on white with their
    wireframes (the reference's draw_scene_view, vis.py:309+, its
    pytorch3d render replaced by vis/rasterize.py's flat-shaded z-buffer)."""
    from ovmono3d_tpu_torch.vis.rasterize import render_mesh_view

    corners = np.asarray(corners3d_list, np.float64).reshape(-1, 8, 3)
    if colors is None:
        colors = np.array([get_color(i) for i in range(len(corners))],
                          np.float64)
    front = render_mesh_view(image, K, corners, colors)
    center = (corners.reshape(-1, 3).mean(0) if len(corners)
              else np.array([0.0, 0.0, 5.0]))
    a = np.deg2rad(novel_angle_deg)
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    moved = (corners - center) @ Rx.T + center
    blank = np.full_like(np.asarray(image), 255)
    novel = render_mesh_view(blank, K, moved, colors)
    for i in range(len(moved)):
        novel = draw_cuboid_3d(novel, moved[i], K,
                               color=tuple(int(v) for v in colors[i]))
    return np.concatenate([front, novel], axis=1)


def scene_panel(image, det, K, class_names=None) -> np.ndarray:
    """The demo's panel: the image with the valid detections' 2D boxes,
    labels and scores and their 3D wireframes | their bird's-eye view,
    resized to the image's height. `det`: Detections (or any object with
    those fields) of one image, tensors or arrays."""

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    valid = host(det.valid).astype(bool)
    boxes, corners = host(det.boxes)[valid], host(det.corners3d)[valid]
    classes, scores = host(det.classes)[valid], host(det.scores)[valid]
    labels = [class_names[c] if class_names else str(int(c))
              for c in classes]
    img = draw_boxes_2d(image, boxes, labels, scores)
    for i in range(len(corners)):
        img = draw_cuboid_3d(img, corners[i], K, color=get_color(i))
    side = img.shape[0]
    bev = resize_bilinear(torch.from_numpy(draw_bev(list(corners))).float(),
                          (side, side))
    bev = bev.round().clamp(0, 255).to(torch.uint8).numpy()
    return np.concatenate([img, bev], axis=1)
