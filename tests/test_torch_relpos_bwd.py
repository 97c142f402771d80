"""Training through the port's rel-pos attention (the SAM trunk unfrozen):
the plain forward-with-lse and backward against `jax.vjp` of the JAX
package's `_rel_pos_attention_fast(..., clamp=None)` (what its `_rpa_bwd`
differentiates on the CPU), with the factors' gradients taken back to q and
the tables through `rel_pos_factors`; the `rel_pos_train_attention`
operator against torch autograd of `rel_pos_attention_ref`; the
dispatcher's routes; the new refusals; the optimizer's group of the tables;
one unfrozen SGD step of a tiny SAM ViT + SFP detector against the JAX
train step; and, marked `cuda` (skipped without a card), kernel 7's lse
instance and csrc/relpos_flash_bwd.cu against their plain versions and
the backward's determinism.

JAX is imported inside the fixtures that need it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_relpos_bwd.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_fast():
    pytest.importorskip("jax")
    from ovmono3d_tpu.models.vit import _rel_pos_attention_fast

    return _rel_pos_attention_fast


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def _inputs(b, grid, h, d, seed=0, qkv_scale=1.0, rel_scale=0.3):
    """numpy q, k, v, do [B, N, H, D] and tables Rh [gh, gh, D], Rw [gw,
    gw, D]."""
    rng = np.random.default_rng(seed)
    gh, gw = grid
    n = gh * gw
    q, k, v, do = (rng.standard_normal((b, n, h, d)).astype(np.float32)
                   * qkv_scale for _ in range(4))
    rh = rng.standard_normal((gh, gh, d)).astype(np.float32) * rel_scale
    rw = rng.standard_normal((gw, gw, d)).astype(np.float32) * rel_scale
    return q, k, v, do, rh, rw


def plain_grads(q, k, v, do, rh, rw, grid):
    """out and lse of the plain forward, and dq, dk, dv, dRh, dRw: the plain
    backward's, the factors' gradients taken back to q and the tables by
    autograd through rel_pos_factors. Tensors in the caller's dtype."""
    q = q.detach().requires_grad_()
    rh = rh.detach().requires_grad_()
    rw = rw.detach().requires_grad_()
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    out, lse = tattn.rel_pos_attention_lse_ref(q.detach(), k, v,
                                               qrh.detach(), qrw.detach(),
                                               grid)
    dq, dk, dv, dqrh, dqrw = tattn.rel_pos_attention_bwd_ref(
        q.detach(), k, v, out, lse, do, qrh.detach(), qrw.detach(), grid)
    gq, grh, grw = torch.autograd.grad((qrh, qrw), (q, rh, rw), (dqrh, dqrw))
    return out, lse, (dq + gq, dk, dv, grh, grw)


def jax_logits_lse(q, k, rh, rw, grid):
    """The logits' row log-sum-exp as _rel_pos_attention_fast builds them
    (clamp None), [B, H, N] f32."""
    import jax
    import jax.numpy as jnp

    B, N, H, D = q.shape
    h, w = grid
    qg = q.transpose(0, 2, 1, 3).reshape(B, H, h, w, D)
    bias_h = jnp.einsum("bnhwc,hkc->bnhwk", qg, rh,
                        preferred_element_type=jnp.float32)
    bias_w = jnp.einsum("bnhwc,wkc->bnhwk", qg, rw,
                        preferred_element_type=jnp.float32)
    attn = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                      preferred_element_type=jnp.float32) * D ** -0.5
    attn = attn.reshape(B, H, h, w, h, w) + (bias_h[..., :, None]
                                             + bias_w[..., None, :])
    return jax.nn.logsumexp(attn.reshape(B, H, N, N), axis=-1)


# Against the JAX package: f32 computes the same math in another order
# (1e-5 of each tensor's largest entry). bf16: JAX rounds its probabilities
# and every gradient to bf16 and feeds bf16 products of the rounded
# probabilities into dv and dS, where the plain backward keeps f32; 2^-8
# relative per rounding, several roundings deep: 2e-2 of the largest entry.
JAX_TOL = {"f32": 1e-5, "bf16": 2e-2}
NAMES = ("dq", "dk", "dv", "dRh", "dRw")


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("grid", [(6, 6), (9, 11), (14, 14)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_backward_matches_jax_vjp(jax_fast, dtype, grid, d):
    import jax
    import jax.numpy as jnp

    q, k, v, do, rh, rw = _inputs(2, grid, 2, d, seed=sum(grid) + d,
                                  qkv_scale=0.5)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jx = [jnp.asarray(x).astype(jd) for x in (q, k, v, rh, rw)]
    fwd = jax.jit(lambda *a: jax.vjp(lambda *b: jax_fast(*b, grid, None),
                                     *a))
    want_out, vjp = fwd(*jx)
    want = jax.jit(vjp)(jnp.asarray(do).astype(jd))
    want_lse = jax.jit(jax_logits_lse, static_argnums=4)(
        jx[0], jx[1], jx[3], jx[4], grid)
    tq, tk, tv, tdo, trh, trw = (torch.from_numpy(x).to(td)
                                 for x in (q, k, v, do, rh, rw))
    out, lse, got = plain_grads(tq, tk, tv, tdo, trh, trw, grid)
    tol = JAX_TOL[dtype]

    def close(g, w, name):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        g = g.detach().float().numpy()
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())

    close(out, want_out, "out")
    # lse: f32 logits from the same exact products on both sides.
    close(lse, want_lse, "lse")
    for name, g, w in zip(NAMES, got, want):
        close(g, w, name)


def _packed(b, grid, h, d, dtype=torch.bfloat16, device="cpu", seed=0,
            rel_std=0.1):
    """qkv [B, N, 3, H, D] (one tensor, as the encoder's qkv projection
    leaves it), tables of about a trained table's scale, and an output
    gradient."""
    g = torch.Generator().manual_seed(seed)
    gh, gw = grid
    n = gh * gw
    qkv = torch.randn(b, n, 3 * h * d, generator=g).view(b, n, 3, h, d)
    rh = torch.randn(gh, gh, d, generator=g) * rel_std
    rw = torch.randn(gw, gw, d, generator=g) * rel_std
    do = torch.randn(b, n, h, d, generator=g)
    return (qkv.to(dtype).to(device), rh.to(device), rw.to(device),
            do.to(dtype).to(device))


def op_and_ref_grads(qkv, rh, rw, do, grid, call_op):
    """Gradients of (qkv, Rh, Rw) through `call_op` and through autograd
    of rel_pos_attention_ref, and both outputs."""
    res = []
    for fn in (call_op, lambda x, a, b: tattn.rel_pos_attention_ref(
            *x.unbind(2), a, b, grid)):
        x, a, b = (t.detach().requires_grad_() for t in (qkv, rh, rw))
        out = fn(x, a, b)
        res.append((out, torch.autograd.grad(out, (x, a, b), do)))
    return res


def test_operator_matches_autograd_f32():
    """The operator's CPU forward and backward (the plain pair) against
    torch autograd of the f32 reference: the same math, 1e-5."""
    grid = (9, 11)
    qkv, rh, rw, do = _packed(2, grid, 2, 64, dtype=torch.float32, seed=1)

    def call_op(x, a, b):
        qrh, qrw = tattn.rel_pos_factors(x[:, :, 0], a, b, grid)
        return tattn.rel_pos_train_attention(x, qrh, qrw, *grid)[0]

    (out, got), (want_out, want) = op_and_ref_grads(qkv, rh, rw, do, grid,
                                                    call_op)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("grid", [(6, 6), (14, 14)])
def test_dispatcher_bf16_grad_runs_the_operator(grid):
    """bf16 with a gradient goes through the operator on the CPU (its CPU
    kernel counts the run): the forward equals the reference's bit for bit
    (the same logits, softmax and bf16 PV); the gradients, the plain
    backward's in f32 from the bf16 output against autograd through the
    reference's bf16 casts, within 2e-2 of each one's largest entry."""
    qkv, rh, rw, do = _packed(2, grid, 2, 80, seed=2)
    runs = tattn._rel_pos_train_cpu.runs
    (out, got), (want_out, want) = op_and_ref_grads(
        qkv, rh, rw, do, grid,
        lambda x, a, b: tattn.rel_pos_attention(x, a, b, grid))
    assert tattn._rel_pos_train_cpu.runs == runs + 1
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for name, g, w in zip(("qkv", "Rh", "Rw"), got, want):
        assert g.dtype == w.dtype, name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * w.float().abs().max().item(), (name, err)


def test_dispatcher_routes_without_the_operator():
    """No gradient (bf16 on the CPU) and f32 with a gradient stay on the
    plain version; the operator does not run."""
    grid = (6, 6)
    qkv, rh, rw, _ = _packed(1, grid, 2, 64, seed=3)
    runs = tattn._rel_pos_train_cpu.runs
    with torch.no_grad():
        out = tattn.rel_pos_attention(qkv, rh, rw, grid)
    torch.testing.assert_close(
        out, tattn.rel_pos_attention_ref(*qkv.unbind(2), rh, rw, grid),
        rtol=0, atol=0)
    x = qkv.float().requires_grad_()
    out32 = tattn.rel_pos_attention(x, rh.requires_grad_(), rw, grid)
    out32.sum().backward()
    assert x.grad is not None and rh.grad is not None
    assert tattn._rel_pos_train_cpu.runs == runs


def test_plain_backward_bias_gradients_are_row_and_column_sums():
    """dqrh and dqrw are dS summed over each key row and key column, the
    layout of the factors (checked against the [N, N] dS summed by hand)."""
    grid = (3, 4)
    qkv, rh, rw, do = _packed(1, grid, 1, 64, dtype=torch.float32, seed=4)
    q, k, v = qkv.unbind(2)
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    out, lse = tattn.rel_pos_attention_lse_ref(q, k, v, qrh, qrw, grid)
    _, _, _, dqrh, dqrw = tattn.rel_pos_attention_bwd_ref(
        q, k, v, out, lse, do, qrh, qrw, grid)
    logits = tattn._rel_pos_logits(q, k, qrh, qrw, grid)[0, 0]
    p = torch.softmax(logits, -1)
    dp = do[0, :, 0] @ v[0, :, 0].T
    ds = p * (dp - (do[0, :, 0] * out[0, :, 0]).sum(-1, keepdim=True))
    for i in range(12):
        for a in range(3):
            want = ds[i, 4 * a:4 * a + 4].sum()
            torch.testing.assert_close(dqrh[0, i, 0, a], want, rtol=1e-5,
                                       atol=1e-6)
        for c in range(4):
            want = ds[i, c::4].sum()
            torch.testing.assert_close(dqrw[0, i, 0, c], want, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("bad,match", [
    ("head_dim", "head dim"), ("wide_grid", "at most 64"),
    ("dtype", "bfloat16"), ("lse_shape", "lse"), ("o_stride", "unit stride"),
    ("bias_terms", "gh \\+ gw"), ("qrw_dtype", "qrw"),
])
def test_training_wrappers_reject(bad, match):
    """The lse instance's and the backward's checks, on CPU tensors (every
    layout check runs before the device's)."""
    grid = (5, 8)
    qkv, rh, rw, do = _packed(1, grid, 2, 64, seed=5)
    q, k, v = qkv.unbind(2)
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    lse = torch.zeros(1, 2, 40)
    o = do
    if bad == "head_dim":
        qkv, rh, rw, do = _packed(1, grid, 4, 32, seed=5)
        q, k, v = qkv.unbind(2)
        qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
        o, lse = do, torch.zeros(1, 4, 40)
    elif bad == "wide_grid":
        grid = (1, 65)
        qkv, rh, rw, do = _packed(1, grid, 2, 64, seed=5)
        q, k, v = qkv.unbind(2)
        qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
        o, lse = do, torch.zeros(1, 2, 65)
    elif bad == "dtype":
        q = q.float()
    elif bad == "lse_shape":
        lse = torch.zeros(1, 40, 2)
    elif bad == "o_stride":
        o = torch.zeros(1, 40, 2, 128, dtype=do.dtype)[..., ::2]
    elif bad == "bias_terms":
        grid = (3, 126)
        qkv, rh, rw, do = _packed(1, grid, 2, 64, seed=5)
        q, k, v = qkv.unbind(2)
        qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
        o, lse = do, torch.zeros(1, 2, 378)
    elif bad == "qrw_dtype":
        qrw = qrw.to(torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        tattn.rel_pos_flash_attention_bwd(q, k, v, o, lse, do, qrh, qrw, grid)
    if bad not in ("lse_shape", "o_stride"):
        with pytest.raises(ValueError, match=match):
            tattn.rel_pos_flash_attention_lse(q, k, v, qrh, qrw, grid)


def test_training_wrappers_refuse_the_cpu():
    grid = (6, 6)
    qkv, rh, rw, do = _packed(1, grid, 2, 64, seed=6)
    q, k, v = qkv.unbind(2)
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.rel_pos_flash_attention_lse(q, k, v, qrh, qrw, grid)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.rel_pos_flash_attention_bwd(q, k, v, do, torch.zeros(1, 2, 36),
                                          do, qrh, qrw, grid)


def test_rel_pos_tables_take_the_jax_groups():
    """rel_pos_h / rel_pos_w fall in the group the JAX label rule gives
    them ("default": full weight decay and lr) in both packages."""
    pytest.importorskip("jax")
    import jax

    from ovmono3d_tpu.train import optim as joptim
    from ovmono3d_tpu_torch.train import optim as toptim
    from ovmono3d_tpu_torch.utils import flax_bridge

    port, tree = tiny_sam_pair()
    labels = toptim.param_group_labels(port)
    jlabels = flax_bridge._leaves(joptim.param_group_labels(
        jax.tree.map(np.asarray, tree)))
    plan = flax_bridge.plan(port, tree)
    tables = [p for p, (full, *_) in plan.items()
              if full.endswith(("rel_pos_h", "rel_pos_w"))]
    assert len(tables) == 2 * 3
    for path in tables:
        assert labels[plan[path][0]] == jlabels[path] == "default", path


# -- one unfrozen SGD step of a tiny SAM ViT + SFP detector ---------------

SAM_TINY = dict(embed_dim=32, depth=3, num_heads=2, pretrain_grid=8,
                out_channels=32, square_pad=128, use_depth_fusion=False,
                scale_factors=(4.0, 2.0, 1.0))


def tiny_sam_configs(freeze=False):
    """tiny_config with the SAM preset at tiny widths on 128^2 (an 8 x 8
    grid: blocks 0 and 1 windowed in one padded 14 x 14 window, block 2
    global; the pyramid's p2-p4 from the stride-16 trunk), trunk unfrozen,
    and test_torch_trunks' SGD solver."""
    from test_model import tiny_config

    base = tiny_config()
    bb = dataclasses.replace(base.model.backbone, name="sam", freeze=freeze,
                             patch_size=16, **SAM_TINY)
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, backbone=bb),
        solver=dataclasses.replace(base.solver, base_lr=0.01,
                                   warmup_iters=0, steps=()))


def tiny_sam_pair():
    """The port's tiny SAM detector and the JAX training tree's shapes."""
    from test_torch_rcnn3d import port_config, training_tree
    from test_torch_trunks import _train_batch

    from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
    from ovmono3d_tpu_torch.models.rcnn3d import build_model

    cfg = tiny_sam_configs()
    batch = _train_batch()
    tree = training_tree(jax_build_model(cfg.model), batch["image"].shape,
                         batch["gt_boxes"].shape[1])
    return build_model(port_config(cfg.model), device="cpu", seed=1), tree


@pytest.fixture(scope="module")
def sam_step():
    """One JAX train step and one port train step of the tiny SAM detector
    from the same weights (rel-pos tables ~N(0, 0.1^2)), batch and sampling
    draws, as test_torch_trunks.py's cnn_step."""
    import jax
    import jax.numpy as jnp
    from test_torch_rcnn3d import port_config, training_tree
    from test_torch_train_ops import jax_draws
    from test_torch_train_step import port_config_solver
    from test_torch_trunks import QUICK, S_CNN, _train_batch, \
        to_flax_variables

    from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
    from ovmono3d_tpu.parallel import train_step as jts
    from ovmono3d_tpu.train import optim as joptim
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                        make_train_step)
    from ovmono3d_tpu_torch.train import optim as toptim
    from ovmono3d_tpu_torch.utils import flax_bridge

    cfg = tiny_sam_configs()
    batch = _train_batch()
    jmodel = jax_build_model(cfg.model)
    tree = training_tree(jmodel, batch["image"].shape,
                         batch["gt_boxes"].shape[1])
    port = build_model(port_config(cfg.model), device="cpu", seed=1)
    variables = to_flax_variables(port, tree, seed=2)
    variables["params"]["rpn_head"]["objectness"]["kernel"] *= 0.0
    for head, fcs in (("box_head", ("fc1", "fc2")),
                      ("cube_head", ("shared_fc1", "shared_fc2"))):
        for fc in fcs:
            variables["params"][head][fc]["bias"] += 3.0
    flax_bridge.load_flax_params(port, variables)

    params = jax.tree.map(jnp.asarray, variables)
    tx = joptim.build_optimizer(cfg.solver, params)
    state = jts.create_train_state(params, tx, jax.random.PRNGKey(2))
    state1, jmetrics = jax.jit(jts.make_train_step(jmodel, tx, 0.01),
                               compiler_options=QUICK)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})

    _, step_rng = jax.random.split(state.rng)
    rng_anchor, rng_prop = jax.random.split(step_rng)
    n_anchors = 3 * sum((S_CNN // s) ** 2 for s in port.feature_strides)
    n_props = cfg.model.rpn.post_nms_topk_train + batch["gt_boxes"].shape[1]
    draws = {
        "anchor": np.stack([jax_draws(k, n_anchors)
                            for k in jax.random.split(rng_anchor, 2)]),
        "proposal": np.stack([jax_draws(k, n_props)
                              for k in jax.random.split(rng_prop, 2)])}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["draws"] = {k: torch.from_numpy(v) for k, v in draws.items()}
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = toptim.Optimizer(port_config_solver(cfg.solver), port)
    runs = tattn._rel_pos_train_cpu.runs
    state_t, tmetrics = make_train_step(port, opt, 0.01)(
        create_train_state(port, opt), tbatch)
    return {"variables": variables, "new": jax.tree.map(np.asarray,
                                                        state1.params),
            "jmetrics": jmetrics, "tmetrics": tmetrics, "port": port,
            "before": before, "op_runs": tattn._rel_pos_train_cpu.runs - runs,
            "skipped": int(state_t.skipped)}


def test_sam_train_step_matches_jax(sam_step):
    """Losses within 1e-2 and each trunk layer's update within 2e-2 of the
    JAX step's (bf16 trunk and heads on both sides, rounded at different
    places: test_torch_trunks.py's limits). Every trunk parameter moves on
    both sides, the rel-pos tables among them, and the three rel-pos blocks
    ran the training operator."""
    from ovmono3d_tpu_torch.utils import flax_bridge

    s = sam_step
    assert s["op_runs"] == 3 and s["skipped"] == 0
    for name in ("rpn/cls", "rpn/loc", "box/cls", "box/reg", "cube/loss_z",
                 "cube/loss_dims", "total_loss"):
        want, got = float(s["jmetrics"][name]), float(s["tmetrics"][name])
        assert abs(got - want) <= 1e-2 * abs(want) + 1e-6, (name, got, want)
    port = s["port"]
    params = dict(port.named_parameters())
    old, now = (flax_bridge._leaves(s["variables"]),
                flax_bridge._leaves(s["new"]))
    n_trunk = n_tables = 0
    groups: dict = {}
    for path, (full, perm, flip) in flax_bridge.plan(
            port, s["variables"]).items():
        if not full.startswith("backbone.vit."):
            continue
        d_jax = now[path] - old[path]
        if flip:
            d_jax = d_jax[::-1, ::-1]
        if perm is not None:
            d_jax = np.transpose(d_jax, perm)
        d_port = (params[full] - s["before"][full]).detach().numpy()
        assert np.abs(d_port).max() > 0 and np.abs(d_jax).max() > 0, full
        n_trunk += 1
        if full.endswith(("rel_pos_h", "rel_pos_w")):
            n_tables += 1
            # Each table alone: the gradients dqrh / dqrw bring back
            # through the factors. A table's update sums dS over every
            # query-key pair of its block, which the two frameworks round
            # to bf16 at different places: 1.6-2.1% measured, held to 3e-2
            # (each block as a whole to 2e-2, with the rest).
            err = np.sqrt(((d_port - d_jax) ** 2).sum())
            assert err <= 3e-2 * np.sqrt((d_jax ** 2).sum()), (full, err)
        key = ".".join(full.split(".")[:3])
        err, ref = groups.get(key, (0.0, 0.0))
        groups[key] = (err + float(((d_port - d_jax) ** 2).sum()),
                       ref + float((d_jax ** 2).sum()))
    assert n_tables == 6
    assert n_trunk == sum(k.startswith("backbone.vit.") for k in params)
    for key, (err, ref) in groups.items():
        assert np.sqrt(err) <= 2e-2 * np.sqrt(ref) + 1e-12, (key, err, ref)


# -- on the card -----------------------------------------------------------

# (B, grid, H, D): SAM ViT-B's global and windowed blocks at 1024^2, SAM-H's
# global, the JAX tests' grids, one-row grids at the backward's widest gw
# and the 64-row tile's edges.
CUDA_SHAPES = [(1, (64, 64), 12, 64), (25, (14, 14), 12, 64),
               (1, (64, 64), 16, 80), (25, (14, 14), 16, 80),
               (2, (6, 6), 2, 64), (2, (9, 11), 2, 80), (1, (1, 1), 2, 64),
               (2, (1, 64), 2, 80), (2, (2, 64), 4, 64), (3, (5, 13), 4, 80),
               (2, (8, 8), 2, 64), (2, (3, 43), 2, 64)]
# Against the plain versions on the same bf16 inputs: out and dq/dk/dv in
# bf16 (rounded once), p and dS rounded to bf16 before the products as
# kernel 4 does; lse, dqrh and dqrw in f32 from the same exp2 arithmetic.
# Each relative to the largest |ref|, with an absolute floor of 1e-5 for a
# gradient that is exactly 0 (a one-token grid: p = 1 and dS = 0, where the
# kernel's f32 rounding leaves ~5e-7).
CUDA_LIMITS = {"out": 2e-2, "lse": 1e-4, "dq": 3e-2, "dk": 3e-2,
               "dv": 3e-2, "dqrh": 2e-2, "dqrw": 2e-2}


def kernel_and_plain(b, grid, h, d, device, seed=0):
    qkv, rh, rw, do = _packed(b, grid, h, d, device=device, seed=seed)
    q, k, v = qkv.unbind(2)
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    out, lse = tattn.rel_pos_flash_attention_lse(q, k, v, qrh, qrw, grid)
    grad, dqrh, dqrw = tattn.rel_pos_flash_attention_bwd(
        q, k, v, out, lse, do, qrh, qrw, grid)
    torch.cuda.synchronize()
    got = {"out": out, "lse": lse, "dq": grad[:, :, 0], "dk": grad[:, :, 1],
           "dv": grad[:, :, 2], "dqrh": dqrh, "dqrw": dqrw}
    want_out, want_lse = tattn.rel_pos_attention_lse_ref(q, k, v, qrh, qrw,
                                                         grid)
    dq, dk, dv, wdqrh, wdqrw = tattn.rel_pos_attention_bwd_ref(
        q, k, v, out, lse, do, qrh, qrw, grid)
    want = {"out": want_out, "lse": want_lse, "dq": dq, "dk": dk, "dv": dv,
            "dqrh": wdqrh, "dqrw": wdqrw}
    return (q, k, v, do, qrh, qrw, grid, out, lse), got, want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_training_kernels_match_plain_on_cuda(cuda_device, shape):
    _, got, want = kernel_and_plain(*shape, cuda_device)
    for name, lim in CUDA_LIMITS.items():
        g, w = got[name].float(), want[name].float()
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= lim * w.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
def test_backward_is_deterministic_on_cuda(cuda_device):
    args, _, _ = kernel_and_plain(2, (14, 14), 12, 64, cuda_device, seed=7)
    q, k, v, do, qrh, qrw, grid, out, lse = args
    first = tattn.rel_pos_flash_attention_bwd(q, k, v, out, lse, do, qrh,
                                              qrw, grid)
    second = tattn.rel_pos_flash_attention_bwd(q, k, v, out, lse, do, qrh,
                                               qrw, grid)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dispatcher_trains_on_cuda(cuda_device):
    """bf16 with a gradient on the card: one lse-instance and one backward
    launch, no inference launch, and the gradients of qkv and the tables
    within 3e-2 of f32 autograd through rel_pos_attention_ref."""
    grid = (14, 14)
    qkv, rh, rw, do = _packed(2, grid, 4, 80, device=cuda_device, seed=8)
    counts = (tattn.rel_pos_flash_attention.launches,
              tattn.rel_pos_flash_attention_lse.launches,
              tattn.rel_pos_flash_attention_bwd.launches)
    x, a, b = (t.detach().requires_grad_() for t in (qkv, rh, rw))
    out = tattn.rel_pos_attention(x, a, b, grid)
    got = torch.autograd.grad(out, (x, a, b), do)
    assert (tattn.rel_pos_flash_attention.launches,
            tattn.rel_pos_flash_attention_lse.launches,
            tattn.rel_pos_flash_attention_bwd.launches) == (
        counts[0], counts[1] + 1, counts[2] + 1)
    x, a, b = (t.detach().float().requires_grad_() for t in (qkv, rh, rw))
    want = torch.autograd.grad(
        tattn.rel_pos_attention_ref(*x.unbind(2), a, b, grid), (x, a, b),
        do.float())
    for name, g, w in zip(("qkv", "Rh", "Rw"), got, want):
        err = (g.float() - w).abs().max().item()
        assert err <= 3e-2 * w.abs().max().item(), (name, err)
    assert math.isfinite(out.float().sum().item())
