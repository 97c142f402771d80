"""Cuboid geometry of Cube R-CNN (cubercnn/util/math_util.py), float32.

Box convention: [X, Y, Z, W, H, L] camera-space center and dimensions; the
unit cuboid puts L along x, H along y and W along z, corners in
math_util's order.
"""
from __future__ import annotations

import math

import torch

SIGNS = ((-.5, -.5, -.5), (.5, -.5, -.5), (.5, .5, -.5),
         (-.5, .5, -.5), (-.5, -.5, .5), (.5, -.5, .5), (.5, .5, .5),
         (-.5, .5, .5))
EPS = 1e-8


def corners(center: torch.Tensor, whl: torch.Tensor,
            R: torch.Tensor | None) -> torch.Tensor:
    """center [..., 3], whl [..., 3] (W, H, L), R [..., 3, 3] -> corners
    [..., 8, 3]."""
    signs = torch.tensor(SIGNS, dtype=center.dtype, device=center.device)
    extent = torch.stack([whl[..., 2], whl[..., 1], whl[..., 0]], -1)
    local = signs * extent[..., None, :]
    if R is not None:
        local = torch.einsum("...ij,...kj->...ki", R, local)
    return local + center[..., None, :]


def backproject(K: torch.Tensor, uv: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """Pixel (u, v) at depth z -> camera-space point, K [..., 3, 3]."""
    x = (uv[..., 0] - K[..., 0, 2]) / K[..., 0, 0] * z
    y = (uv[..., 1] - K[..., 1, 2]) / K[..., 1, 1] * z
    return torch.stack([x, y, z], -1)


def project(K: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Camera-space points [..., N, 3] -> pixels [..., N, 2]."""
    p = torch.einsum("...ij,...nj->...ni", K, pts)
    return p[..., :2] / p[..., 2:3]


def rotation_6d(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s 6D representation -> rotation rows (b1, b2, b1 x b2)."""
    b1 = d6[..., :3] / d6[..., :3].norm(dim=-1, keepdim=True).clamp(min=EPS)
    a2 = d6[..., 3:]
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / a2.norm(dim=-1, keepdim=True).clamp(min=EPS)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], -2)


def rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis [..., 3] and angle [...] -> rotation matrix."""
    x, y, z = axis.unbind(-1)
    o = torch.zeros_like(x)
    k = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        *axis.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    return c * eye + s * k + (1 - c) * axis[..., :, None] * axis[..., None, :]


def ray_rotation(K: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """The rotation that takes the optical axis onto the viewing ray of
    pixel (u, v): Cube R-CNN's allocentric-to-egocentric correction."""
    ray = torch.stack([(u - K[..., 0, 2]) / K[..., 0, 0],
                       (v - K[..., 1, 2]) / K[..., 1, 1],
                       torch.ones_like(u)], -1)
    ray = ray / ray.norm(dim=-1, keepdim=True).clamp(min=EPS)
    angle = torch.atan2(ray[..., :2].norm(dim=-1), ray[..., 2])
    axis = torch.stack([-ray[..., 1], ray[..., 0], torch.zeros_like(u)], -1)
    axis = axis / axis.norm(dim=-1, keepdim=True).clamp(min=EPS)
    eye = torch.eye(3, dtype=u.dtype, device=u.device).expand(
        *u.shape, 3, 3)
    return torch.where((angle > EPS)[..., None, None],
                       rodrigues(axis, angle), eye)


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer of two corner sets [..., 8, 3] under L1."""
    d = (a[..., :, None, :] - b[..., None, :, :]).abs().sum(-1)
    return d.min(-1).values.mean(-1) + d.min(-2).values.mean(-1)


def yaw_rotation(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about the camera's y axis."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    o, i = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, o, s, o, i, o, -s, o, c], -1).reshape(
        *yaw.shape, 3, 3)


SQRT2 = math.sqrt(2.0)
