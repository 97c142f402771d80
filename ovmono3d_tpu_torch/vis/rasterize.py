"""CPU z-buffer triangle rasterizer for cuboid meshes (counterpart of
ovmono3d_tpu/vis/rasterize.py, whose numpy it copies).

Replaces the reference's pytorch3d MeshRasterizer uses:
`render_depth_map` / `estimate_visibility` (math_util.py:707-743) for
dataset preprocessing and vis, `estimate_truncation` (math_util.py:745-758),
and a flat-shaded color render for `draw_scene_view`-style panels
(vis.py:309+). Pure numpy — these run off the training/inference hot path,
matching the reference (its rasterizer is also vis/preprocessing-only).

Interpolation is screen-space linear (the reference rasterizes with
`perspective_correct=False`, math_util.py:816).
"""
from __future__ import annotations

import numpy as np
import torch

from ovmono3d_tpu_torch.utils.geometry import cuboid_to_2d_box
from ovmono3d_tpu_torch.utils.util import get_color

# Triangulated cuboid faces (same table as utils.geometry.CUBOID_FACES).
CUBOID_FACES = np.array(
    [
        [0, 1, 2], [2, 3, 0],
        [1, 5, 6], [6, 2, 1],
        [4, 0, 3], [3, 7, 4],
        [5, 4, 7], [7, 6, 5],
        [4, 5, 1], [1, 0, 4],
        [3, 2, 6], [6, 7, 3],
    ], np.int64,
)


def _tri_tile(p, pz, height, width):
    """Rasterize ONE triangle onto its bbox tile.

    p: [3, 2] pixel coords; pz: [3] camera depth. Returns
    (y0, y1, x0, x1, zi, inside) with zi/inside shaped [y1-y0, x1-x0], or
    None if the triangle is skipped (behind camera / degenerate / off
    screen). Consumers update only the tile region — a full-frame buffer
    per triangle made scene renders O(F*H*W).
    """
    if (pz <= 0).any():                      # behind camera: skip triangle
        return None
    x0 = max(int(np.floor(p[:, 0].min())), 0)
    x1 = min(int(np.ceil(p[:, 0].max())) + 1, width)
    y0 = max(int(np.floor(p[:, 1].min())), 0)
    y1 = min(int(np.ceil(p[:, 1].max())) + 1, height)
    if x0 >= x1 or y0 >= y1:
        return None
    xs, ys = np.meshgrid(
        np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5
    )
    # Barycentric coordinates in screen space.
    d = (
        (p[1, 1] - p[2, 1]) * (p[0, 0] - p[2, 0])
        + (p[2, 0] - p[1, 0]) * (p[0, 1] - p[2, 1])
    )
    if abs(d) < 1e-12:
        return None
    w0 = ((p[1, 1] - p[2, 1]) * (xs - p[2, 0])
          + (p[2, 0] - p[1, 0]) * (ys - p[2, 1])) / d
    w1 = ((p[2, 1] - p[0, 1]) * (xs - p[2, 0])
          + (p[0, 0] - p[2, 0]) * (ys - p[2, 1])) / d
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    zi = w0 * pz[0] + w1 * pz[1] + w2 * pz[2]
    return y0, y1, x0, x1, zi, inside


_Z_NEAR = 1e-4


def _clip_tri_near(tri, z_near=_Z_NEAR):
    """Clip one CAMERA-SPACE triangle [3, 3] against the near plane
    z >= z_near (Sutherland–Hodgman), fanning the resulting polygon back
    into triangles. A cuboid straddling the camera plane must still
    rasterize its in-front portion (the reference's pytorch3d renderer
    clips at its camera near plane); dropping any triangle with a
    behind-camera vertex would zero the silhouette of substantially
    visible objects. Returns 0, 1, or 2 triangles."""
    res = []
    for i in range(3):
        a, b = tri[i], tri[(i + 1) % 3]
        a_in, b_in = a[2] >= z_near, b[2] >= z_near
        if a_in:
            res.append(a)
        if a_in != b_in:
            t = (z_near - a[2]) / (b[2] - a[2])
            res.append(a + t * (b - a))
    if len(res) < 3:
        return []
    return [
        np.stack([res[0], res[i], res[i + 1]])
        for i in range(1, len(res) - 1)
    ]


def _raster_triangles(verts3d, K, faces, height, width):
    """Rasterize camera-space triangles into one z-buffer.

    verts3d: [V, 3] camera space; faces: [F, 3]. Each face is near-plane
    clipped, projected, then rasterized. Returns zbuf [H, W] (inf = empty).
    """
    zbuf = np.full((height, width), np.inf, np.float64)
    for f in faces:
        for tri in _clip_tri_near(verts3d[f]):
            p2, z = _project(K, tri)
            tile = _tri_tile(p2, z, height, width)
            if tile is None:
                continue
            y0, y1, x0, x1, zi, inside = tile
            sub = zbuf[y0:y1, x0:x1]
            upd = inside & (zi < sub)
            sub[upd] = zi[upd]
    return zbuf


def _project(K, verts):
    """verts [*, 3] camera space -> pixel coords [*, 2] + depth [*]."""
    z = np.maximum(verts[..., 2], 1e-8)
    u = K[0, 0] * verts[..., 0] / z + K[0, 2]
    v = K[1, 1] * verts[..., 1] / z + K[1, 2]
    return np.stack([u, v], -1), verts[..., 2]


def render_depth_map(K, verts, height, width, faces=CUBOID_FACES):
    """Z-buffer depth render of N cuboids (math_util.py:708-726).

    K: [3, 3]; verts: [N, 8, 3] camera-space cuboid corners.
    Returns (silhouettes [N, H, W] bool, depth_map [H, W] (inf empty),
    depth_inds [H, W] nearest-instance index).
    """
    verts = np.asarray(verts, np.float64).reshape(-1, 8, 3)
    n = verts.shape[0]
    # Running min/argmin instead of stacking N float64 z-buffers — the
    # stacked form is O(N*H*W*8) bytes (~1 GB for 50 instances at 1080p)
    # on the dataset-preprocessing path. Only the bool silhouettes are
    # kept per instance (the API callers need them).
    silhouettes = np.zeros((n, height, width), bool)
    depth_map = np.full((height, width), np.inf)
    depth_inds = np.zeros((height, width), np.int64)
    for i in range(n):
        zbuf = _raster_triangles(
            verts[i], np.asarray(K, np.float64), faces, height, width
        )
        silhouettes[i] = np.isfinite(zbuf)
        nearer = zbuf < depth_map
        depth_map = np.where(nearer, zbuf, depth_map)
        depth_inds = np.where(nearer, i, depth_inds)
    return silhouettes, depth_map, depth_inds


def estimate_visibility(K, verts, height, width):
    """Per-instance visible fraction: pixels where the instance is the
    nearest surface / its silhouette area (math_util.py:729-743)."""
    silhouettes, _, depth_inds = render_depth_map(K, verts, height, width)
    out = []
    for i in range(silhouettes.shape[0]):
        area = silhouettes[i].sum()
        if area == 0:
            out.append(0.0)
            continue
        visible = (depth_inds[silhouettes[i]] == i).sum()
        out.append(float(visible / area))
    return out


def _f32(x) -> torch.Tensor:
    """An array as an f32 CPU tensor (the JAX package's f32 projection)."""
    return torch.as_tensor(np.asarray(x, np.float32))


def estimate_truncation(K, box3d, R, im_w, im_h):
    """Fraction of the projected 2D extent outside the image
    (math_util.py:745-758): 1 - IoU(proj box, image box) with the image
    box's own area ignored (ign_area_b)."""
    box2d, _, fully_behind = cuboid_to_2d_box(
        _f32(K), _f32(box3d), _f32(R), clip_w=im_w, clip_h=im_h, xywh=False)
    if bool(fully_behind):
        return 1.0
    x1, y1, x2, y2 = box2d.double().numpy()
    ix1, iy1 = max(x1, 0.0), max(y1, 0.0)
    ix2, iy2 = min(x2, im_w - 1.0), min(y2, im_h - 1.0)
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    area = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    if area <= 0:
        return 1.0
    # ign_area_b: union = area of the projected box only.
    return float(1.0 - inter / area)


def render_mesh_view(
    image, K, verts_list, colors=None, faces=CUBOID_FACES,
    light_dir=(0.0, 0.0, 1.0), alpha=0.66,
):
    """Flat-shaded cuboid render composited onto `image`
    (draw_scene_view's rendered mode, vis.py:309+; HardFlat-style shading).

    verts_list: [N, 8, 3] camera space. colors: [N, 3] uint8-ish (default
    palette). Returns uint8 [H, W, 3].
    """
    image = np.asarray(image)
    height, width = image.shape[:2]
    verts = np.asarray(verts_list, np.float64).reshape(-1, 8, 3)
    n = verts.shape[0]
    if colors is None:
        colors = np.array([get_color(i) for i in range(n)], np.float64)
    colors = np.asarray(colors, np.float64).reshape(-1, 3)
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)

    zbuf = np.full((height, width), np.inf)
    shade = np.zeros((height, width, 3))
    covered = np.zeros((height, width), bool)
    Kf = np.asarray(K, np.float64)
    for i in range(n):
        for f in faces:
            # Face normal for flat shading (from the UNCLIPPED face).
            a, b, c = verts[i][f]
            nrm = np.cross(b - a, c - a)
            ln = np.linalg.norm(nrm)
            if ln < 1e-12:
                continue
            intensity = 0.35 + 0.65 * abs(float(nrm @ light) / ln)
            for tri in _clip_tri_near(verts[i][f]):
                p2, z = _project(Kf, tri)
                tile = _tri_tile(p2, z, height, width)
                if tile is None:
                    continue
                y0, y1, x0, x1, zi, inside = tile
                sub = zbuf[y0:y1, x0:x1]
                upd = inside & (zi < sub)
                sub[upd] = zi[upd]
                shade[y0:y1, x0:x1][upd] = (
                    colors[i % len(colors)] * intensity
                )
                covered[y0:y1, x0:x1] |= upd
    out = image.astype(np.float64).copy()
    out[covered] = (
        alpha * shade[covered] + (1 - alpha) * out[covered]
    )
    return out.clip(0, 255).astype(np.uint8)
