"""The port's oracle-2D LIFT slice against the JAX RCNN3D at matched weights.

Both models hold the same parameters at the tiny test config -- the tree
JAX's init through compute_losses makes (trunk, pyramid, RPN, box and cube
heads), filled from the port's seeded init and loaded back through
utils/flax_bridge.py -- and run the same numpy-seeded image, intrinsics and
oracle boxes on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model import tiny_config

from ovmono3d_tpu.models.heads import CubeHead as JaxCubeHead
from ovmono3d_tpu.models.rcnn3d import RCNN3D as JaxRCNN3D
from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu.models.rcnn3d import decode_cube as jax_decode_cube
from ovmono3d_tpu.structures import GroundTruth as JaxGroundTruth
from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.models.heads import CubeHead
from ovmono3d_tpu_torch.models.rcnn3d import build_model, decode_cube
from ovmono3d_tpu_torch.utils import flax_bridge
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)

S, B, NO = 112, 2, 4


def port_config(jcfg) -> tcfg.ModelConfig:
    """The port's ModelConfig holding the JAX config's values."""

    def conv(cls, src):
        kw = {}
        for f in dataclasses.fields(cls):
            val = getattr(src, f.name)
            if dataclasses.is_dataclass(val):
                val = conv(type(getattr(cls(), f.name)), val)
            kw[f.name] = val
        return cls(**kw)

    return conv(tcfg.ModelConfig, jcfg)


def _inputs():
    rng = np.random.default_rng(0)
    image = (rng.random((B, S, S, 3)) * 255).astype(np.float32)
    K = np.tile(np.array([[100.0, 0, 56], [0, 100.0, 56], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    im_hw = np.array([[112, 112], [98, 84]], np.int32)
    ratio = np.array([2.0, 1.5], np.float32)
    boxes = np.array(
        [[[10, 10, 50, 50], [30, 20, 90, 80], [0, 0, 20, 20], [0, 0, 0, 0]],
         [[5, 5, 60, 60], [40, 40, 80, 90], [2, 3, 111, 100], [0, 0, 0, 0]]],
        np.float32)
    classes = np.array([[0, 2, 4, 0], [1, 3, 0, 0]], np.int32)
    scores = np.array([[0.9, 0.8, 0.7, 0.0], [0.95, 0.6, 0.5, 0.0]],
                      np.float32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool)
    return image, K, im_hw, ratio, boxes, classes, scores, valid


def training_tree(model, image_shape, num_gt: int):
    """The parameter tree JAX's init through compute_losses makes for
    `model`, as shapes only (no compute)."""
    sds = jax.ShapeDtypeStruct
    b = image_shape[0]

    def init(key, image, K, im_hw, ratio, gt):
        return model.init(key, image, K, im_hw, ratio, gt, key,
                          method=JaxRCNN3D.compute_losses)

    gt = JaxGroundTruth(
        boxes=sds((b, num_gt, 4), jnp.float32),
        classes=sds((b, num_gt), jnp.int32),
        boxes3d=sds((b, num_gt, 9), jnp.float32),
        poses=sds((b, num_gt, 3, 3), jnp.float32),
        valid=sds((b, num_gt), jnp.bool_))
    return jax.eval_shape(
        init, jax.random.PRNGKey(0), sds(image_shape, jnp.float32),
        sds((b, 3, 3), jnp.float32), sds((b, 2), jnp.int32),
        sds((b,), jnp.float32), gt)


def to_flax(port, tree) -> dict:
    """The port's parameters in the flax layout of `tree`: the inverse of
    load_flax_params, through the bridge's own plan."""
    params = dict(port.named_parameters())
    out: dict = {}
    for path, (full, perm, flip) in flax_bridge.plan(port, tree).items():
        arr = params[full].detach().numpy()
        if perm is not None:
            arr = np.transpose(arr, np.argsort(perm))
        if flip:
            arr = arr[::-1, ::-1]
        d = out
        *mods, leaf = path.split("/")
        for m in mods:
            d = d.setdefault(m, {})
        d[leaf] = np.array(arr)
    return {"params": out}


def _spread(params):
    """Move the init off its near-identity point so every stage shows in the
    outputs: LayerScale 1e-5 -> 0.5, cube output kernels x100. A 6D pose
    bias of one class is set to the identity's 6D vector, so Gram-Schmidt
    stays well conditioned and bf16 noise in the head input is not
    amplified."""
    def fix(path, x):
        names = [getattr(p, "key", "") for p in path]
        x = np.asarray(x)
        if names[-1] == "gamma":
            return np.full_like(x, 0.5)
        if names[-2:] == ["pose", "bias"] and x.shape == (6,):
            return np.array([1, 0, 0, 0, 1, 0], x.dtype)
        if names[-1] == "kernel" and names[-2] in (
                "center_deltas", "dims", "pose", "depth", "uncertainty"):
            return x * 100.0
        return x
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = tiny_config().model
    image, K, im_hw, ratio, boxes, classes, scores, valid = _inputs()
    model = jax_build_model(jcfg)
    oracle = dict(oracle_boxes=jnp.asarray(boxes),
                  oracle_classes=jnp.asarray(classes),
                  oracle_scores=jnp.asarray(scores),
                  oracle_valid=jnp.asarray(valid))
    args = (jnp.asarray(image), jnp.asarray(K), jnp.asarray(im_hw),
            jnp.asarray(ratio))
    port = build_model(port_config(jcfg), device="cpu")
    params = _spread(to_flax(port, training_tree(model, image.shape, 3)))
    load_flax_params(port, params)
    want = jax.jit(model.apply)(params, *args, **oracle)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in (image, K, im_hw, ratio)),
                   oracle_boxes=torch.from_numpy(boxes),
                   oracle_classes=torch.from_numpy(classes),
                   oracle_scores=torch.from_numpy(scores),
                   oracle_valid=torch.from_numpy(valid))
    return want, got


@pytest.mark.parametrize("field", ["boxes", "classes", "valid"])
def test_slice_exact_fields(slice_pair, field):
    want, got = slice_pair
    np.testing.assert_array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(want, field)))


@pytest.mark.parametrize(
    "field", ["scores", "center_cam", "center_2d", "dimensions", "pose",
              "corners3d"])
def test_slice_3d_fields(slice_pair, field):
    # The trunk and ROI pooling run in bf16 on both sides, and the two
    # frameworks round bf16 at different places (fused bias adds, gelu,
    # matmul epilogues): allow 2e-2 of the field's own scale.
    want, got = slice_pair
    w = np.asarray(getattr(want, field))
    g = getattr(got, field).numpy()
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=2e-2,
                               atol=2e-2 * float(np.abs(w).max()))


def test_forward_without_oracle_raises():
    """Without some of the oracle arguments: the oracle path needs all four
    (without any, the model detects its own 2D boxes,
    tests/test_torch_detect2d.py)."""
    port = build_model(port_config(tiny_config().model), device="meta")
    with pytest.raises(ValueError, match="go together"):
        port(torch.zeros(1, S, S, 3), torch.eye(3)[None],
             torch.full((1, 2), S), torch.ones(1),
             oracle_boxes=torch.zeros(1, 2, 4))


def test_build_model_seeded():
    cfg = port_config(tiny_config().model)
    a = build_model(cfg, seed=3, device="cpu")
    b = build_model(cfg, seed=3, device="cpu")
    c = build_model(cfg, seed=4, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.backbone.vit.pos_embed, c.backbone.vit.pos_embed)


# decode_cube branches, against the JAX function on the same head outputs.
N_DEC, C_DEC, BINS = 6, 3, 3


def _decode_inputs(priors: bool, bins: int):
    rng = np.random.default_rng(1)
    shape = (N_DEC, C_DEC) if priors else (N_DEC,)
    z_shape = (N_DEC, bins, C_DEC) if priors else (N_DEC, bins)
    d6 = rng.normal(size=shape + (6,)).astype(np.float32)
    from ovmono3d_tpu.ops.rotation import rotation_6d_to_matrix
    outputs = {
        "deltas_2d": rng.normal(0, 0.2, shape + (2,)).astype(np.float32),
        "dims": rng.normal(0, 0.5, shape + (3,)).astype(np.float32),
        "pose": np.array(rotation_6d_to_matrix(jnp.asarray(d6))),
        "z": (rng.normal(2, 1, z_shape if bins > 1 else shape)
              .astype(np.float32)),
        "uncert": rng.uniform(0.01, 3, shape).astype(np.float32),
    }
    x1y1 = rng.uniform(0, 300, (N_DEC, 2))
    wh = rng.uniform(10, 200, (N_DEC, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], 1).astype(np.float32)
    classes = rng.integers(0, C_DEC, N_DEC).astype(np.int32)
    K = np.tile(np.array([[600, 0, 320], [0, 610, 240], [0, 0, 1]],
                         np.float32), (N_DEC, 1, 1))
    focal = np.full(N_DEC, 900.0, np.float32)
    im_h = np.full(N_DEC, 480.0, np.float32)
    ratio = np.full(N_DEC, 1.5, np.float32)
    pri = {
        "dims": np.stack([rng.uniform(0.5, 2, (C_DEC, 3)),
                          rng.uniform(0.1, 0.3, (C_DEC, 3))], 1
                         ).astype(np.float32),
        "z_scales": np.sort(rng.uniform(20, 300, (C_DEC, bins)), 1
                            ).astype(np.float32),
        "z_stats": np.stack([rng.uniform(2, 20, (C_DEC, bins)),
                             rng.uniform(0.5, 2, (C_DEC, bins))], -1
                            ).astype(np.float32),
    }
    return outputs, boxes, classes, K, focal, im_h, ratio, pri


@pytest.mark.parametrize("z_type,priors,dims_func,bins,allo", [
    ("direct", False, "exp", 1, True),
    ("sigmoid", False, "exp", 1, False),
    ("log", True, "exp", 1, True),
    ("clusters", True, "sigmoid", BINS, True),
    ("clusters", False, "exp", BINS, True),
])
def test_decode_cube_matches_jax(z_type, priors, dims_func, bins, allo):
    jcube = dataclasses.replace(
        tiny_config().model.cube, z_type=z_type, dims_priors_enabled=priors,
        dims_priors_func=dims_func, cluster_bins=bins, allocentric_pose=allo)
    tcube = port_config(dataclasses.replace(
        tiny_config().model, cube=jcube)).cube
    outputs, boxes, classes, K, focal, im_h, ratio, pri = _decode_inputs(
        priors, bins)
    want = jax_decode_cube(
        jcube, {k: jnp.asarray(v) for k, v in outputs.items()},
        *(jnp.asarray(a) for a in (boxes, classes, K, focal, im_h, ratio)),
        *(jnp.asarray(pri[k]) for k in ("dims", "z_scales", "z_stats")))
    got = decode_cube(
        tcube, {k: torch.from_numpy(v) for k, v in outputs.items()},
        *(torch.from_numpy(a) for a in (boxes, classes, K, focal, im_h,
                                        ratio)),
        *(torch.from_numpy(pri[k]) for k in ("dims", "z_scales", "z_stats")))
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
            continue
        # f32 everywhere; the JAX decode pins Precision.HIGHEST.
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(pose_type="6d"),
    dict(pose_type="quaternion", shared_fc=False, num_conv=1),
    dict(pose_type="euler", dims_priors_enabled=True, cluster_bins=3),
    dict(pose_type="6d", use_confidence=0.0, num_fc=1),
], ids=["6d", "quat_conv_unshared", "euler_priors_bins", "no_conf"])
def test_cube_head_matches_jax(kw):
    kw = dict(num_classes=3, conv_dim=8, fc_dim=16, **kw)
    rng = np.random.default_rng(2)
    pooled = rng.normal(size=(5, 7, 7, 8)).astype(np.float32)
    jhead = JaxCubeHead(**kw)
    params = jax.jit(jhead.init)(jax.random.PRNGKey(3), jnp.asarray(pooled))
    params = _spread(params)
    want = jax.jit(jhead.apply)(params, jnp.asarray(pooled))
    head = CubeHead(in_channels=8, resolution=7, **kw)
    load_flax_params(head, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        got = head(torch.from_numpy(pooled))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
            continue
        # f32 on both sides.
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
