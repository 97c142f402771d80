"""OVMono3D-GEO box fitting in PyTorch: masked metric depth -> oriented 3D
cuboid.

Counterpart of ovmono3d_tpu/geo/pipeline.py (the reference's
tools/ovmono3d_geo.py:40-258):

  mask + metric depth -> unproject -> PCA yaw (xz plane) -> density
  outlier filter -> min/max box in the yaw frame -> corners
  -> (center, dims, pose by SVD Procrustes)

Fixed shapes, as in the JAX package: every reduction (mean, covariance,
extrema, density) is a mask-weighted reduction over the whole [H, W] grid,
so nothing depends on the number of masked pixels and nothing syncs with
the host. Unlike the JAX function, `fit_box_from_mask_depth` fits every
mask of an image in one batch (masks [M, H, W] over one depth map): each
fit reads only its own row.

Outlier removal: the reference loops DBSCAN (eps 0.01, min_samples 100,
doubling eps until the clusters cover more than half the points); this
keeps its density-core criterion on a voxel grid at the same eps schedule
and acceptance rule, by a sort and searchsorted over packed voxel ids.

All in f32 on elementwise products or f32 matrix products: on the card,
TF32 must stay off (`torch.backends.cuda.matmul.allow_tf32` False, its
default), as `geo.cli.build_geo_models` keeps it (`utils.device.disable_tf32`).
"""
from __future__ import annotations

import torch

from ovmono3d_tpu_torch.utils.device import device_constant
from ovmono3d_tpu_torch.utils.geometry import cuboid_corners

# Corner order of the reference's gen_8corners (ovmono3d_geo.py:106-113).
_CORNER_FLAGS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                 (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
_FLIP = (1.0, -1.0, -1.0)          # open3d-frame flip, diag(1, -1, -1)
# The 27 voxel offsets of a 3x3x3 neighbourhood.
_NEIGHBOURS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1))
_GRID = 1024                       # voxel cells per axis, 10 bits each
_SENTINEL = torch.iinfo(torch.int64).max


def heading_to_rotmat(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about +y by `yaw` (ovmono3d_geo.py:115-124): [...] ->
    [..., 3, 3]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, z, -s, z, one, z, s, z, c],
                       dim=-1).reshape(*yaw.shape, 3, 3)


def unproject_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Per-pixel camera-space points in the reference's open3d frame,
    [x, -y, -z] (ovmono3d_geo.py:131-139). depth [H, W] -> [H, W, 3]."""
    H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    x3 = depth * (u - K[0, 2]) / K[0, 0]
    y3 = depth * (v - K[1, 2]) / K[1, 1]
    return torch.stack([x3, -y3, -depth], dim=-1)


def _masked_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the points axis: x [..., P, D], w [..., P] ->
    [..., D]."""
    tot = torch.clamp(w.sum(-1), min=1e-6)
    return (x * w[..., None]).sum(-2) / tot[..., None]


def _rot_points(points: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """points @ R^T per batch row: [M, P, 3] and [M, 3, 3] -> [M, P, 3]."""
    return torch.matmul(points, R.transpose(-1, -2))


def pca_yaw(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Yaw of the dominant direction of the masked points on the xz plane
    (ovmono3d_geo.py:144-150). points [M, P, 3], mask [M, P] -> [M]."""
    w = mask.to(points.dtype)
    xz = torch.stack([points[..., 0], points[..., 2]], dim=-1)
    mean = _masked_mean(xz, w)
    centered = (xz - mean[..., None, :]) * w[..., None]
    cov = torch.matmul(centered.transpose(-1, -2), centered) / torch.clamp(
        w.sum(-1), min=1e-6)[..., None, None]
    # Leading eigenvector of a symmetric 2x2 matrix, in closed form; arctan2
    # picks the larger eigenvalue's only when a >= d, so compare the
    # projected variances and take the perpendicular when it wins.
    a, b, d = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    theta = 0.5 * torch.atan2(2 * b, a - d)
    v = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    v_perp = torch.stack([-v[..., 1], v[..., 0]], dim=-1)

    def var(x):
        return ((x[..., :, None] * cov).sum(-2) * x).sum(-1)

    v = torch.where((var(v) >= var(v_perp))[..., None], v, v_perp)
    return torch.atan2(v[..., 1], v[..., 0])


def _pack(q: torch.Tensor) -> torch.Tensor:
    return q[..., 0] * (_GRID * _GRID) + q[..., 1] * _GRID + q[..., 2]


def _voxel_density_keep(points: torch.Tensor, mask: torch.Tensor,
                        eps: float, min_count: int) -> torch.Tensor:
    """Keep mask of the points with at least `min_count` masked points in
    their 3x3x3 eps-voxel neighbourhood (which covers DBSCAN's eps-ball).
    points [M, P, 3], mask [M, P].

    Voxel coordinates are offset by 512 and packed 10 bits per axis into
    int64 ids; the points are mean-centred upstream, so +-512 voxels is
    about +-5 m at the first eps. Points outside the grid are outliers:
    never kept, never counted. One sort per row, then each neighbour
    voxel's count is searchsorted(right) - searchsorted(left)."""
    eps_t = device_constant((eps,), points.device, points.dtype)
    q_raw = torch.floor(points / eps_t).to(torch.int64) + _GRID // 2
    in_range = ((q_raw >= 0) & (q_raw < _GRID)).all(-1)
    valid = mask & in_range
    q = q_raw.clamp(0, _GRID - 1)
    ids = torch.where(valid, _pack(q), torch.full_like(q[..., 0], _SENTINEL))
    sorted_ids = torch.sort(ids, dim=-1).values
    counts = torch.zeros_like(ids)
    offsets = device_constant(_NEIGHBOURS, points.device, torch.int64)
    for off in offsets:
        nq = q + off
        nok = ((nq >= 0) & (nq < _GRID)).all(-1)
        # A neighbour cell off the grid cannot alias a real cell: -1 is in
        # no table.
        nid = torch.where(nok, _pack(nq.clamp(0, _GRID - 1)),
                          torch.full_like(nq[..., 0], -1))
        counts += (torch.searchsorted(sorted_ids, nid, right=True)
                   - torch.searchsorted(sorted_ids, nid))
    return valid & (counts >= min_count)


def robust_extent_mask(points: torch.Tensor, mask: torch.Tensor,
                       eps0: float = 0.01, min_count: int = 100,
                       max_tries: int = 4) -> torch.Tensor:
    """The density filter at the reference's eps-doubling schedule: the
    first eps whose kept points are more than half the mask, else the whole
    mask (ovmono3d_geo.py:152-183). points [M, P, 3] in the yaw-aligned
    frame, mask [M, P] -> [M, P]."""
    total = torch.clamp(mask.sum(-1).to(points.dtype), min=1.0)
    keeps, eps = [], eps0
    for _ in range(max_tries):
        keeps.append(_voxel_density_keep(points, mask, eps, min_count))
        eps *= 2.0
    out = mask
    for keep in reversed(keeps):
        ok = keep.sum(-1) > 0.5 * total
        out = torch.where(ok[..., None], keep, out)
    return out


def fit_box_from_mask_depth(mask: torch.Tensor, depth: torch.Tensor,
                            K: torch.Tensor) -> dict[str, torch.Tensor]:
    """The GEO fit of run_one_2dbox_to_3d +
    build_pseudo_bbox3d_from_mask2d_outlier (ovmono3d_geo.py:127-258).

    mask: [H, W] or [M, H, W] instance masks (a value > 0.5 is inside);
    depth: [H, W] metric depth; K: [3, 3]. Returns, with the mask's leading
    dims: center [3], dims [3] (w, h, l), pose [3, 3], corners [8, 3],
    yaw, num_points and valid (False where no pixel is both inside the mask
    and at a positive depth; the other outputs are then zeros and the
    identity)."""
    lead = mask.shape[:-2]
    H, W = depth.shape
    m = ((mask > 0.5) & (depth > 0)).reshape(-1, H * W)          # [M, P]
    pts = unproject_depth(depth, K).reshape(1, H * W, 3)
    offset = _masked_mean(pts, m.to(pts.dtype))[:, None]         # [M, 1, 3]
    centered = pts - offset
    yaw = pca_yaw(centered, m)
    aligned = _rot_points(centered, heading_to_rotmat(-yaw)) + offset
    # The density filter runs on mean-centred coordinates: DBSCAN is
    # translation-invariant, and the voxel grid would otherwise saturate
    # for any object beyond ~5 m.
    keep = robust_extent_mask(aligned - offset, m)

    big = 1e9
    mins = torch.where(keep[..., None], aligned, big).amin(-2)
    maxs = torch.where(keep[..., None], aligned, -big).amax(-2)
    # Corner base and extents exactly as the reference builds them
    # (ovmono3d_geo.py:187-205): y and z SWAPPED (base at y_max / z_max,
    # negative extents), which puts corner 0 where the Procrustes template
    # has its vertex 0 after the open3d flip.
    base = torch.stack([mins[:, 0], maxs[:, 1], maxs[:, 2]], dim=-1)
    extent = torch.stack([maxs[:, 0] - mins[:, 0], mins[:, 1] - maxs[:, 1],
                          mins[:, 2] - maxs[:, 2]], dim=-1)
    flags = device_constant(_CORNER_FLAGS, depth.device)
    corners = base[:, None] + flags * extent[:, None] - offset
    corners = _rot_points(corners, heading_to_rotmat(yaw)) + offset
    corners_cam = corners * device_constant(_FLIP, depth.device)

    center = corners_cam.mean(-2)
    # dims in the reference's get_dims order: (w, h, l) = (|c0 - c4|,
    # |c0 - c3|, |c0 - c1|) (ovmono3d_geo.py:46-50).
    c0 = corners_cam[:, 0]
    dims = torch.stack([torch.linalg.norm(c0 - corners_cam[:, i], dim=-1)
                        for i in (4, 3, 1)], dim=-1)
    # Pose: Procrustes between the fitted corners and the axis-aligned
    # template with the same center and dims (ovmono3d_geo.py:51-63).
    box = torch.cat([center, dims], dim=-1)
    A = corners_cam - center[:, None]
    B = cuboid_corners(box) - center[:, None]
    U, _, Vt = torch.linalg.svd(torch.matmul(A.transpose(-1, -2), B))
    sign = torch.sign(torch.linalg.det(torch.matmul(U, Vt)))
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(sign), torch.ones_like(sign), sign], dim=-1))
    R = U @ D @ Vt

    ok = keep.sum(-1) > 0
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    out = {
        "center": torch.where(ok[:, None], center, 0.0),
        "dims": torch.where(ok[:, None], dims, 0.0),
        "pose": torch.where(ok[:, None, None], R, eye),
        "corners": torch.where(ok[:, None, None], cuboid_corners(box, R), 0.0),
        "yaw": torch.where(ok, yaw, 0.0),
        "num_points": keep.sum(-1),
        "valid": ok,
    }
    return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}
