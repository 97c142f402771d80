"""The port's rotation and cuboid geometry against the JAX package, in f32.

The JAX functions pin Precision.HIGHEST, so both sides are plain f32 and
agree to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.ops import rotation as jrot
from ovmono3d_tpu.utils import geometry as jgeom
from ovmono3d_tpu_torch.ops import rotation as trot
from ovmono3d_tpu_torch.utils import geometry as tgeom

torch.set_num_threads(2)

ATOL = 1e-5


def _rng():
    return np.random.default_rng(7)


def _K(n):
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = 700.0, 690.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 320.0, 240.0, 1.0
    return K


def _rot_inputs(kind):
    rng = _rng()
    if kind == "6d":
        return (rng.normal(size=(5, 4, 6)),)
    if kind == "quat":
        return (rng.normal(size=(7, 4)),)
    if kind == "euler":
        return (rng.uniform(-np.pi, np.pi, size=(7, 3)),)
    if kind == "axis_angle":
        aa = rng.normal(size=(7, 3))
        aa[0] = 0.0                                 # zero angle -> identity
        return (aa,)
    if kind == "copysign":
        b = rng.normal(size=(9,))
        b[0] = 0.0                                  # sign(0) is positive
        return rng.normal(size=(9,)), b
    raise KeyError(kind)


ROTATIONS = {
    "6d": (jrot.rotation_6d_to_matrix, trot.rotation_6d_to_matrix),
    "quat": (jrot.quaternion_to_matrix, trot.quaternion_to_matrix),
    "euler": (jrot.euler_angles_to_matrix, trot.euler_angles_to_matrix),
    "axis_angle": (jrot.axis_angle_to_matrix, trot.axis_angle_to_matrix),
    "copysign": (jrot.copysign, trot.copysign),
}


@pytest.mark.parametrize("kind", sorted(ROTATIONS))
def test_rotation_matches_jax(kind):
    jfn, tfn = ROTATIONS[kind]
    args = [a.astype(np.float32) for a in _rot_inputs(kind)]
    want = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def _geom_case(kind):
    rng = _rng()
    n = 6
    if kind == "corners":
        box = np.concatenate([rng.normal(0, 3, (n, 3)),
                              rng.uniform(0.2, 3, (n, 3))], 1)
        return (box,)
    if kind == "corners_R":
        box = np.concatenate([rng.normal(0, 3, (n, 3)),
                              rng.uniform(0.2, 3, (n, 3))], 1)
        R = np.asarray(jrot.rotation_6d_to_matrix(
            jnp.asarray(rng.normal(size=(n, 6)), jnp.float32)))
        return box, R
    if kind == "virtual_to_real":
        return (rng.uniform(300, 1500, n), rng.uniform(300, 1000, n),
                np.float32(512.0), rng.uniform(200, 900, n))
    if kind == "allocentric":
        R = np.asarray(jrot.rotation_6d_to_matrix(
            jnp.asarray(rng.normal(size=(n, 6)), jnp.float32)))
        u = rng.uniform(0, 640, n)
        v = rng.uniform(0, 480, n)
        u[0], v[0] = 320.0, 240.0                   # on the optical axis
        return _K(n), R, u, v
    if kind == "scaled_sigmoid":
        return (rng.normal(0, 3, n), rng.uniform(0, 2, n),
                rng.uniform(3, 9, n))
    if kind == "backproject":
        return _K(n), rng.uniform(0, 640, (n, 2)), rng.uniform(1, 50, n)
    raise KeyError(kind)


GEOMETRY = {
    "corners": (jgeom.cuboid_corners, tgeom.cuboid_corners),
    "corners_R": (jgeom.cuboid_corners, tgeom.cuboid_corners),
    "virtual_to_real": (jgeom.virtual_to_real_scale,
                        tgeom.virtual_to_real_scale),
    "allocentric": (jgeom.R_from_allocentric, tgeom.R_from_allocentric),
    "scaled_sigmoid": (jgeom.scaled_sigmoid, tgeom.scaled_sigmoid),
    "backproject": (jgeom.backproject, tgeom.backproject),
}


@pytest.mark.parametrize("kind", sorted(GEOMETRY))
def test_geometry_matches_jax(kind):
    jfn, tfn = GEOMETRY[kind]
    args = [np.array(a, np.float32) for a in _geom_case(kind)]
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = tfn(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()),
                               rtol=ATOL)


def test_rotations_are_orthonormal():
    (d6,) = _rot_inputs("6d")
    R = trot.rotation_6d_to_matrix(torch.from_numpy(d6.astype(np.float32)))
    eye = torch.eye(3).expand_as(R)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(torch.linalg.det(R), torch.ones(R.shape[:-2]),
                               atol=1e-5, rtol=0)
