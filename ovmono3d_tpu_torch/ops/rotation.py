"""Rotation representation conversions, in f32 PyTorch.

Counterpart of ovmono3d_tpu/ops/rotation.py (the pytorch3d.transforms
functions the reference uses). Every function takes arbitrary leading batch
dimensions. The 3x3 products are written out elementwise, so they are full
f32 on every device whatever the TF32 settings.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] in plain f32 multiply-adds."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a` with the sign of `b`; sign(0) counts as positive."""
    return torch.where(b < 0, -a.abs(), a.abs())


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D representation (Zhou et al. 2019) -> 3x3 matrices whose rows are
    (b1, b2, b1 x b2), by Gram-Schmidt on d6[..., :3] and d6[..., 3:]."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp(min=_EPS)
    a2_proj = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2_proj / torch.linalg.vector_norm(
        a2_proj, dim=-1, keepdim=True).clamp(min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z), not necessarily unit -> rotation matrices."""
    w, x, y, z = quat.unbind(-1)
    two_s = 2.0 / (quat * quat).sum(dim=-1).clamp(min=_EPS)
    m = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(*quat.shape[:-1], 3, 3)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle vector (angle = norm) -> matrix."""
    angle = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    axis = axis_angle / angle.clamp(min=_EPS)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    kmat = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    kmat = kmat.reshape(*axis_angle.shape[:-1], 3, 3)
    theta = angle[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    outer = axis[..., :, None] * axis[..., None, :]
    return (torch.cos(theta) * eye + torch.sin(theta) * kmat
            + (1.0 - torch.cos(theta)) * outer)


def euler_angles_to_matrix(euler: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """Euler angles -> R = R(c0) @ R(c1) @ R(c2) (pytorch3d semantics)."""

    def axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
        c, s = torch.cos(angle), torch.sin(angle)
        one, zero = torch.ones_like(angle), torch.zeros_like(angle)
        if axis == "X":
            flat = [one, zero, zero, zero, c, -s, zero, s, c]
        elif axis == "Y":
            flat = [c, zero, s, zero, one, zero, -s, zero, c]
        elif axis == "Z":
            flat = [c, -s, zero, s, c, zero, zero, zero, one]
        else:
            raise ValueError(f"bad axis {axis}")
        return torch.stack(flat, dim=-1).reshape(*angle.shape, 3, 3)

    mats = [axis_rot(a, euler[..., i]) for i, a in enumerate(convention)]
    return matmul3(matmul3(mats[0], mats[1]), mats[2])


def so3_relative_angle(r1: torch.Tensor, r2: torch.Tensor, eps: float = 1e-4,
                       cos_angle: bool = False) -> torch.Tensor:
    """Angle of r1 @ r2^T by the trace formula (pytorch3d semantics). With
    `cos_angle` the raw cosine, unclipped (the reference's `1 - cos` pose
    loss); else acos of the cosine clipped to [-1 + eps, 1 - eps]."""
    r12 = matmul3(r1, r2.transpose(-1, -2))
    cos = (r12[..., 0, 0] + r12[..., 1, 1] + r12[..., 2, 2] - 1.0) * 0.5
    if cos_angle:
        return cos
    return torch.acos(cos.clamp(-1.0 + eps, 1.0 - eps))
