"""Rematerialization of the port's ViT blocks (models/vit.py `remat`,
`remat_policy`) on the CPU: a tiny unfrozen DINOv2 trunk in f32 gives the
same loss and trunk gradients under no remat and under "full", "dots" and
"dots_attn" (atol 1e-6), and the JAX trunk's gradients under the same
policy (bridged weights; ||d|| <= 2e-2 ||g_jax|| per parameter, the slice
tests' allowance in tests/test_torch_train_step.py); the attention forward
(the training operator, counted on its CPU implementation) runs again in
the backward once a block under "full" and "dots" and never under
"dots_attn"; rel-pos and windowed blocks are not wrapped.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
from ovmono3d_tpu_torch.config import BackboneConfig
from ovmono3d_tpu_torch.models import vit as tvit
from ovmono3d_tpu_torch.models.backbones import build_backbone
from ovmono3d_tpu_torch.ops import attention as tattn
from ovmono3d_tpu_torch.utils import flax_bridge

torch.set_num_threads(2)

# The JAX CLI tests' tiny trunk: embed 64, depth 2, 2 heads, a 112^2 input.
KW = dict(patch_size=14, embed_dim=64, depth=2, num_heads=2, pretrain_grid=8,
          layerscale=True, use_depth_fusion=True)
IMG = 112
POLICIES = [None, "full", "dots", "dots_attn"]
SLICE_TOL = 2e-2


@pytest.fixture(scope="module")
def trunk():
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jvit = JaxViT(dtype=jnp.float32, pos_interp_offset=tvit.DINOV2_POS_OFFSET,
                  **KW)
    params = jax.jit(jvit.init)(jax.random.PRNGKey(0), jnp.asarray(image))

    def widen(path, x):       # LayerScale from 1e-5 so the blocks matter
        x = np.asarray(x)
        return np.full_like(x, 0.5) if path[-1].key == "gamma" else x

    return image, jax.tree_util.tree_map_with_path(widen, params)


def port_run(image, params, policy):
    """(loss, {name: gradient}, attention runs in the backward)."""
    port = tvit.VisionTransformer(dtype=torch.float32,
                                  remat=policy is not None,
                                  remat_policy=policy or "dots_attn", **KW)
    flax_bridge.load_flax_params(port, params)
    named = dict(port.named_parameters())
    loss = port(torch.from_numpy(image))["last_feat"].square().mean()
    runs = tattn._train_attention_cpu.runs
    grads = torch.autograd.grad(loss, list(named.values()))
    return (float(loss.detach()), dict(zip(named, grads)),
            tattn._train_attention_cpu.runs - runs)


def jax_run(image, params, policy):
    jvit = JaxViT(dtype=jnp.float32, pos_interp_offset=tvit.DINOV2_POS_OFFSET,
                  remat=policy is not None,
                  remat_policy=policy or "full", **KW)

    def loss_fn(p):
        return jnp.mean(jvit.apply(p, jnp.asarray(image))["last_feat"] ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), grads


@pytest.fixture(scope="module")
def baseline(trunk):
    return port_run(*trunk, None)


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_policies_match_no_remat(trunk, baseline, policy):
    loss, grads, _ = port_run(*trunk, policy)
    assert abs(loss - baseline[0]) <= 1e-6
    assert grads.keys() == baseline[1].keys()
    for name, g in grads.items():
        torch.testing.assert_close(g, baseline[1][name], rtol=0, atol=1e-6,
                                   msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_backward_reruns_attention_only_where_the_policy_says(trunk,
                                                              policy):
    _, _, runs = port_run(*trunk, policy)
    assert runs == (KW["depth"] if policy in ("full", "dots") else 0)


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_match_jax_under_the_same_policy(trunk, policy):
    image, params = trunk
    loss, grads, _ = port_run(image, params, policy)
    jloss, jgrads = jax_run(image, params, policy)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    port = tvit.VisionTransformer(dtype=torch.float32, device="meta", **KW)
    plan = flax_bridge.plan(port, params)
    flat = flax_bridge._flatten(jax.tree.map(np.asarray, jgrads)["params"])
    assert len(plan) == len(grads)
    for path, (name, perm, flip) in plan.items():
        want = flat[path]
        if flip:
            want = want[::-1, ::-1]
        if perm is not None:
            want = np.transpose(want, perm)
        got = grads[name].numpy().reshape(want.shape)
        err = np.linalg.norm(got - want)
        assert err <= SLICE_TOL * np.linalg.norm(want) + 1e-12, (name, err)


def test_rel_pos_and_windowed_blocks_are_not_wrapped(monkeypatch, caplog):
    wrapped = []
    real = tvit.checkpoint

    def counting(fn, *args, **kwargs):
        wrapped.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(tvit, "checkpoint", counting)
    # SAM's layout at a tiny width: windowed blocks with global rel-pos
    # blocks between them.
    sam = tvit.VisionTransformer(
        patch_size=16, embed_dim=32, depth=2, num_heads=2, pretrain_grid=8,
        layerscale=False, use_depth_fusion=False, use_cls_token=False,
        window_size=4, global_blocks=(1,), use_rel_pos=True,
        neck_channels=16, dtype=torch.float32, remat=True)
    x = torch.randn(1, 128, 128, 3)
    sam(x)["last_feat"].sum().backward()
    assert wrapped == []
    dino = tvit.VisionTransformer(dtype=torch.float32, remat=True, **KW)
    dino(torch.randn(1, IMG, IMG, 3))["last_feat"].sum().backward()
    assert len(wrapped) == KW["depth"]
    with caplog.at_level(logging.WARNING, logger="ovmono3d"):
        with pytest.raises(NotImplementedError, match="items 8 and 9"):
            build_backbone(BackboneConfig(name="sam", remat=True),
                           device="meta")
    assert any("remat only wraps plain" in r.getMessage()
               for r in caplog.records)
