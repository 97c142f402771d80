"""3D cuboid geometry on the decode path, in f32 PyTorch.

Counterpart of ovmono3d_tpu/utils/geometry.py (reference
cubercnn/util/math_util.py). The JAX code pins Precision.HIGHEST for its
small products; here they are written out as elementwise multiply-adds, which
are full f32 on any device. The model's other f32 products (the cube head,
exact ROI pooling) need TF32 off on the card: `build_model` turns it off
when it places the model on CUDA (`utils.device.disable_tf32`).

Cuboid convention: box3d = [X, Y, Z, W, H, L]; the local corner template
places L along x, H along y and W along z.
"""
from __future__ import annotations

import torch

from ovmono3d_tpu_torch.ops.rotation import axis_angle_to_matrix, matmul3
from ovmono3d_tpu_torch.utils.device import device_constant

_EPS = 1e-8

# Local unit-cuboid corners, [8, 3] (math_util.py:151-167).
CORNER_SIGNS = (
    (-0.5, -0.5, -0.5),
    (+0.5, -0.5, -0.5),
    (+0.5, +0.5, -0.5),
    (-0.5, +0.5, -0.5),
    (-0.5, -0.5, +0.5),
    (+0.5, -0.5, +0.5),
    (+0.5, +0.5, +0.5),
    (-0.5, +0.5, +0.5),
)


# 12 triangles over the 8 corners (math_util.py:195-213), and the 6 quad
# faces in winding order with outward normals (ops/iou3d.py's planes):
# copies of the JAX package's CUBOID_FACES and CUBOID_QUAD_FACES.
CUBOID_FACES = (
    (0, 1, 2), (2, 3, 0),  # front
    (1, 5, 6), (6, 2, 1),  # right
    (4, 0, 3), (3, 7, 4),  # left
    (5, 4, 7), (7, 6, 5),  # back
    (4, 5, 1), (1, 0, 4),  # top
    (3, 2, 6), (6, 7, 3),  # bottom
)
CUBOID_QUAD_FACES = (
    (0, 1, 2, 3),  # front  (z = -W/2)
    (4, 7, 6, 5),  # back   (z = +W/2)
    (0, 4, 5, 1),  # top    (y = -H/2)
    (3, 2, 6, 7),  # bottom (y = +H/2)
    (0, 3, 7, 4),  # left   (x = -L/2)
    (1, 5, 6, 2),  # right  (x = +L/2)
)

def cuboid_corners(box3d: torch.Tensor,
                   R: torch.Tensor | None = None) -> torch.Tensor:
    """[..., 6] boxes ([X, Y, Z, W, H, L]) and optional [..., 3, 3]
    rotations -> [..., 8, 3] camera-space corners."""
    center = box3d[..., :3]
    whl = box3d[..., 3:6]
    scale = torch.stack([whl[..., 2], whl[..., 1], whl[..., 0]], dim=-1)
    signs = device_constant(CORNER_SIGNS, box3d.device, box3d.dtype)
    local = signs * scale[..., None, :]                       # [..., 8, 3]
    if R is not None:
        # local_k' = R @ local_k for every corner k.
        local = (R[..., None, :, :] * local[..., :, None, :]).sum(dim=-1)
    return local + center[..., None, :]


def project_points(K: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """Camera-space points [..., N, 3] through intrinsics [..., 3, 3] ->
    [..., N, 3] = (u, v, z), u and v in pixels (math_util.py:251-253)."""
    proj = (K[..., None, :, :] * pts3d[..., :, None, :]).sum(dim=-1)
    z = proj[..., 2:3]
    uv = proj[..., :2] / torch.where(z.abs() < _EPS, torch.full_like(z, _EPS),
                                     z)
    return torch.cat([uv, z], dim=-1)


def chamfer_corner_distance(pred: torch.Tensor,
                            gt: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer distance between two 8-corner sets [..., 8, 3] ->
    [...]: the two directed means of min-L1 matches, summed as the
    reference's chamfer_loss does (roi_heads.py:299-309)."""
    diff = (pred[..., :, None, :] - gt[..., None, :, :]).abs().sum(dim=-1)
    return (diff.amin(dim=-1).mean(dim=-1) + diff.amin(dim=-2).mean(dim=-1))


def virtual_to_real_scale(focal, height, virtual_focal, virtual_height):
    """Depth factor from the virtual focal space to the real one:
    H0 * f / (f0 * H) (math_util.py:581-592)."""
    return (virtual_height * focal) / (virtual_focal * height)


def _viewing_ray_correction(K: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Rotation aligning the optical axis with the viewing ray of (u, v)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    sx, sy = K[..., 0, 2], K[..., 1, 2]
    ray = torch.stack([(u - sx) / fx, (v - sy) / fy, torch.ones_like(u)],
                      dim=-1)
    ray = ray / torch.linalg.vector_norm(ray, dim=-1,
                                         keepdim=True).clamp(min=_EPS)
    xy_norm = torch.sqrt(ray[..., 0] ** 2 + ray[..., 1] ** 2)
    angle = torch.atan2(xy_norm, ray[..., 2])
    axis = torch.stack([-ray[..., 1], ray[..., 0], torch.zeros_like(u)],
                       dim=-1)
    norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    M = axis_angle_to_matrix(angle[..., None] * axis / norm.clamp(min=_EPS))
    eye = torch.eye(3, dtype=M.dtype, device=M.device).expand_as(M)
    return torch.where((angle > _EPS)[..., None, None], M, eye)


def R_from_allocentric(K: torch.Tensor, R_view: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Allocentric -> egocentric rotation at pixel (u, v): M @ R_view."""
    return matmul3(_viewing_ray_correction(K, u, v), R_view)


def R_to_allocentric(K: torch.Tensor, R: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Egocentric -> allocentric rotation at pixel (u, v): M^T @ R."""
    return matmul3(_viewing_ray_correction(K, u, v).transpose(-1, -2), R)


def scaled_sigmoid(vals, lo=0.0, hi=1.0):
    """Sigmoid rescaled to (lo, hi) (math_util.py:969-978)."""
    return lo + torch.sigmoid(vals) * (hi - lo)


def backproject(K: torch.Tensor, uv: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """Pixel coords [..., 2] and depth [...] -> camera space [..., 3]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    x = z * (uv[..., 0] - cx) / fx
    y = z * (uv[..., 1] - cy) / fy
    return torch.stack([x, y, z], dim=-1)
