"""The port's head-major attention family (kernels 2, 5 and 6), its f32
forward instance and its routing: the wrappers' plain paths on the CPU
against the JAX package's TPU kernels in Pallas interpret mode, the copied
gates against the JAX ones under both switches, the dispatcher and an f32
Depth-Pro GEO request on the CPU, and on the card (marker `cuda`) each
kernel against its plain version, the head-major autograd Function, the
dispatcher's routes and the entry points' TF32 setting.

JAX is imported inside the fixture that needs it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_attention_headmajor.py
"""
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.geo import cli
from ovmono3d_tpu_torch.models.depth import DepthPro
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import Block, VisionTransformer
from ovmono3d_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# The JAX package's own test shape for the head-major kernels
# (tests/test_attention.py): 3 heads of 32 do not tile to 128 lanes.
B, N, H, D = 2, 150, 3, 32
WRAPPERS = (tattn.flash_attention_packed, tattn.flash_attention_packed_lse,
            tattn.flash_attention_packed_bwd, tattn.flash_attention,
            tattn.flash_attention_fwd_lse, tattn.flash_attention_bwd)


@pytest.fixture(scope="module")
def jattn():
    pytest.importorskip("jax")
    from ovmono3d_tpu.ops import attention

    return attention


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def _counts() -> tuple:
    return tuple((fn.launches, getattr(fn, "launches_f32", 0))
                 for fn in WRAPPERS)


def _arrays(shape=(B, N, H, D), n=4, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    out[0] *= scale
    return out


DTYPES = {"f32": ("float32", torch.float32), "bf16": ("bfloat16",
                                                      torch.bfloat16)}
# f32: the same math with exp2 of pre-scaled logits against exp, summed in
# another order (tests/test_attention.py's 1e-5 forward, 1e-4 gradients).
# bf16: both round q's scaled copy, p, ds and the outputs to bf16 (2^-8
# relative) at different points.
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}
BWD_TOL = {"f32": 1e-4, "bf16": 5e-2}


def _both(dtype, arrays):
    import jax.numpy as jnp

    jd, td = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jd) for x in arrays],
            [torch.from_numpy(x).to(td) for x in arrays])


def _np(x) -> np.ndarray:
    """A JAX array or a torch tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_tpu_kernel_interpret(jattn, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, _arrays(n=3, seed=1))
    before = _counts()
    got = tattn.flash_attention(tq, tk, tv)
    want = jattn.flash_attention(jq, jk, jv, block_q=64, interpret=True)
    assert got.dtype == tq.dtype and got.shape == (B, N, H, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=FWD_TOL[dtype],
                               rtol=FWD_TOL[dtype])
    assert _counts() == before       # the plain path on CPU tensors


def _jax_lse_natural(jlse, n, clamp=50.0):
    """The JAX head-major lse ([B*H, 1, n_q], log2 of the clamp-shifted
    denominator) in the port's units: natural log, [B, H, N]."""
    return np.asarray(jlse).reshape(B, H, -1)[..., :n] * math.log(2) + clamp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_fwd_lse_matches_tpu_kernel_interpret(jattn, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, _arrays(n=3, seed=2))
    before = _counts()
    out, lse = tattn.flash_attention_fwd_lse(tq, tk, tv)
    jo, jlse = jattn.flash_attention_fwd_lse(jq, jk, jv, block_q=64,
                                             interpret=True)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == (B, H, N) and jlse.shape == (B * H, 1, 192)
    np.testing.assert_allclose(_np(out), _np(jo), atol=FWD_TOL[dtype],
                               rtol=FWD_TOL[dtype])
    # lse ~ 5 here; f32 differs in the last bits of exp2 vs exp sums.
    np.testing.assert_allclose(lse.numpy(), _jax_lse_natural(jlse, N),
                               atol=max(1e-4, FWD_TOL[dtype]), rtol=1e-5)
    assert _counts() == before


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_bwd_matches_tpu_kernels_interpret(jattn, dtype,
                                                           fused):
    """The port's kernel-6 wrapper (its plain path here) against the JAX
    fused kernel and the split dq / dk-dv pair, each on its own forward's
    residuals."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(dtype, _arrays(seed=3))
    before = _counts()
    o, lse = tattn.flash_attention_fwd_lse(tq, tk, tv)
    got = tattn.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    jo, jlse = jattn.flash_attention_fwd_lse(jq, jk, jv, block_q=64,
                                             interpret=True)
    want = jattn.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, block_q=64,
                                     block_k=64, fused=fused, interpret=True)
    for g, w, x, name in zip(got, want, (tq, tk, tv), ("dq", "dk", "dv")):
        assert g.dtype == x.dtype and g.shape == (B, N, H, D)
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype], err_msg=name)
    assert _counts() == before


def test_lse_has_no_clamp(jattn):
    """Row-max logits near 90, past the TPU kernels' clamp C = 50: the JAX
    lse converted to natural units stops at the clamp (at most C + ln N),
    the port's stays the exact log-sum-exp (float64 reference)."""
    import jax.numpy as jnp

    q, k, v = _arrays(n=3, seed=4, scale=32.0)    # logits ~ N(0, 32^2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = tattn.flash_attention_fwd_lse(tq, tk, tv)
    logits = torch.einsum("bqhd,bkhd->bhqk", tq.double(),
                          tk.double()) / math.sqrt(D)
    exact = torch.logsumexp(logits, dim=-1)
    # f32 logits of ~100 carry ~1e-5 of rounding.
    torch.testing.assert_close(lse.double(), exact, rtol=1e-6, atol=2e-4)
    _, jlse = jattn.flash_attention_fwd_lse(
        *(jnp.asarray(x) for x in (q, k, v)), block_q=64, interpret=True)
    clamped = _jax_lse_natural(jlse, N)
    # The clamped denominator sums at most N ones: lse <= C + ln N.
    beyond = exact.numpy() > 60.0
    assert beyond.sum() > 10
    assert np.all(clamped[beyond] <= 50.0 + math.log(N) + 1e-3)


GRID = [(n, h, d) for n in (4097, 6144, 6145) for h in (3, 12, 16)
        for d in (32, 64, 80)]


@pytest.mark.parametrize("packed_attn", [None, "1", "0"])
@pytest.mark.parametrize("packed_bwd", [None, "auto", "1", "0"])
def test_gates_match_jax(jattn, monkeypatch, packed_attn, packed_bwd):
    for var, val in (("OVMONO3D_PACKED_ATTN", packed_attn),
                     ("OVMONO3D_PACKED_BWD", packed_bwd)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    assert tattn._packed_bwd_wins() == jattn._packed_bwd_wins()
    for n, h, d in GRID:
        assert tattn._use_packed(n, h, d) == jattn._use_packed(n, h, d), (
            n, h, d)


@pytest.mark.parametrize("shape", [(1, 33, 2, 64), (B, N, H, D),
                                   (1, 40, 4, 32)])
@pytest.mark.parametrize("grad", [False, True])
def test_dispatcher_cpu_stays_plain(monkeypatch, shape, grad):
    """CPU tensors run attention_ref under every switch, with or without a
    gradient, at packed and head-major shapes alike: no kernel count moves
    and the output and gradient equal attention_ref's."""
    monkeypatch.setenv("OVMONO3D_PACKED_ATTN", "0")
    rng = np.random.default_rng(5)
    b, n, h, d = shape
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d)).astype(
        np.float32))
    ref = qkv.clone()
    if grad:
        qkv.requires_grad_()
        ref.requires_grad_()
    before = _counts()
    out = tattn.dot_product_attention(qkv)
    want = tattn.attention_ref(*ref.unbind(2))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    if grad:
        out.square().sum().backward()
        want.square().sum().backward()
        torch.testing.assert_close(qkv.grad, ref.grad, rtol=0, atol=0)
    assert _counts() == before


def _views(b, n, h, d, dtype=torch.bfloat16, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * d, generator=g).to(dtype).to(device)
    return qkv.view(b, n, 3, h, d).unbind(2)


@pytest.mark.parametrize("bad,match", [
    ("f32_training", "queue 2 item 7"), ("head_dim", "queue 2 item 7"),
    ("mixed", "one dtype"), ("f32_align", "aligned"),
    ("grad", "forward-only"), ("cpu", "CUDA"),
])
def test_kernel_checks_refuse(bad, match):
    """What the kernels do not take raises before any launch, naming the
    ROADMAP item where an instance is missing."""
    q, k, v = _views(1, 40, 2, 64)
    kw = dict(dtypes=tattn._FWD_DTYPES, forward_only=True,
              wrapper="flash_attention")
    if bad == "f32_training":
        q, k, v = _views(1, 40, 2, 64, dtype=torch.float32)
        kw = {}
    elif bad == "head_dim":
        q, k, v = _views(1, 40, 2, 80)
    elif bad == "mixed":
        v = v.float()
    elif bad == "f32_align":      # rows of 2 floats: 8 bytes
        q, k, v = (torch.zeros(1, 40, 2, 34)[..., :32] for _ in range(3))
    elif bad == "grad":
        q = q.detach().requires_grad_()
    with pytest.raises(ValueError, match=match):
        tattn.check_kernel_inputs(q, k, v, **kw)


def _tiny_geo_models() -> cli.GeoModels:
    """Tiny SAM encoder, decoder and an f32 Depth-Pro (8-pixel patches on
    32^2 crops of a 128^2 pyramid), seeded: the GEO CLI's default dtype."""
    sam = VisionTransformer(
        patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_grid=6,
        layerscale=False, use_depth_fusion=False, use_cls_token=False,
        window_size=4, global_blocks=(1,), neck_channels=16,
        use_rel_pos=True, pos_interp_offset=0.0, dtype=torch.float32)
    seg = SamSegmenter(embed_dim=16, decoder_mlp_dim=32)
    depth = DepthPro(dtype=torch.float32, patch_size=8, encoder_size=32,
                     vit_dim=32, vit_depth=2, vit_heads=4,
                     scaled_dims=(16, 16, 8), hook_ids=(1,), hook_dims=(8,),
                     fusion_dim=8, merge_padding=1)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in (sam, seg, depth):
            m.init_weights(g)
    return cli.GeoModels(sam.eval(), seg.eval(), depth.eval(), sam_size=48,
                         depth_size=128, max_instances=3)


def test_f32_depth_pro_geo_request_runs_plain_on_cpu():
    """One GEO request through geo.cli with an f32 Depth-Pro (the JAX CLI's
    default, depth_bf16=False) on the CPU: its attention goes through
    dot_product_attention to attention_ref (no kernel count moves), the
    depth stays f32, and the boxes equal those of the same models with
    attention_ref set in every Depth-Pro block."""
    models = _tiny_geo_models()
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    K = np.array([[60.0, 0, 28.0], [0, 60.0, 20.0], [0, 0, 1]], np.float32)
    dets = [{"bbox2d": [4.0, 3.0, 30.0, 25.0], "score": 0.9,
             "category_id": 0},
            {"bbox2d": [20.0, 5.0, 55.0, 39.0], "score": 0.5,
             "category_id": 1}]
    seen = []

    def recorded(qkv):
        seen.append(qkv.dtype)
        return tattn.dot_product_attention(qkv)

    blocks = [blk for vit in models.depth.trunks() for blk in vit.blocks()]
    for blk in blocks:
        blk.attn.attn_fn = recorded
    before = _counts()
    trace: dict = {}
    got = cli.predict_image(models, image, K, dets, trace=trace)
    assert _counts() == before
    assert seen and set(seen) == {torch.float32}
    assert trace["canonical_inverse_depth"].dtype == torch.float32
    for blk in blocks:
        blk.attn.attn_fn = lambda qkv: tattn.attention_ref(*qkv.unbind(2))
    want = cli.predict_image(models, image, K, dets)
    assert got == want


# ---- on the card ----

def _close(got, want, what, f32: bool):
    """f32: exact products on both sides, summed in another order; the
    error is held to 2e-5 of the largest |ref|. bf16: both round p and the
    outputs to bf16 at different points; 5% of the largest |ref| and 1% of
    the mean |ref|."""
    got, want = got.float(), want.float()
    err, ref = (got - want).abs(), want.abs()
    assert torch.isfinite(got).all(), what
    if f32:
        assert err.max().item() <= 2e-5 * ref.max().item(), what
    else:
        assert err.max().item() <= 5e-2 * ref.max().item(), what
        assert err.mean().item() <= 1e-2 * ref.mean().item(), what


FWD_SHAPES = [(1, 4097, 12, 64), (1, 8192, 12, 64), (B, N, H, D),
              (3, 65, 4, 32), (1, 1, 2, 32)]
F32_SHAPES = [(1, 577, 16, 64), (35, 577, 16, 64), (2, 77, 12, 64),
              (B, N, H, D), (1, 4097, 12, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_kernel2_matches_plain_on_cuda(cuda_device, shape, dtype):
    td = DTYPES[dtype][1]
    q, k, v = _views(*shape, dtype=td, device=cuda_device)
    before = (tattn.flash_attention.launches,
              tattn.flash_attention.launches_f32)
    got = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    f32 = td == torch.float32
    assert (tattn.flash_attention.launches,
            tattn.flash_attention.launches_f32) == (
        before[0] + (not f32), before[1] + f32)
    _close(got, tattn.attention_ref(q, k, v), "out", f32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_SHAPES)
def test_kernel1_f32_matches_plain_on_cuda(cuda_device, shape):
    q, k, v = _views(*shape, dtype=torch.float32, device=cuda_device)
    before = tattn.flash_attention_packed.launches_f32
    got = tattn.flash_attention_packed(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert tattn.flash_attention_packed.launches_f32 == before + 1
    _close(got, tattn.attention_ref(q, k, v), "out", True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 577])
def test_f32_instance_edges_on_cuda(cuda_device, n, d):
    """The f32 instance at the 64-key tile's and 8-row group's edges, on
    packed views (token stride 3 H D) and on head-major views of a
    [B, H, N, D] tensor (kernel 2's route), against f32 attention_ref, at a
    small and at Depth-Pro's patch-encoder batch and heads."""
    for b, h in ((2, 3), (35, 16)):
        q, k, v = _views(b, n, h, d, dtype=torch.float32,
                         device=cuda_device, seed=n + d)
        _close(tattn.flash_attention_packed(q, k, v),
               tattn.attention_ref(q, k, v), f"packed {b, n, h, d}", True)
        qh, kh, vh = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (q, k, v))
        assert qh.stride(2) == n * d
        _close(tattn.flash_attention(qh, kh, vh),
               tattn.attention_ref(qh, kh, vh), f"head-major {b, n, h, d}",
               True)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_f32_kernel_is_not_tf32_on_cuda(cuda_device):
    """Logits of a few hundred: TF32 products (10-bit mantissas) would move
    them by ~0.1 and the probabilities by ~10%; the f32 instance stays
    within 2e-5 of the float64 attention."""
    q, k, v = _views(2, 300, 2, 64, dtype=torch.float32, device=cuda_device,
                     seed=7)
    q = q * 20.0
    got = tattn.flash_attention(q, k, v).double()
    want = tattn.attention_ref(q.double(), k.double(), v.double())
    assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4097, 12, 64), (B, N, H, D),
                                   (3, 65, 4, 32)])
def test_kernels_5_6_match_plain_on_cuda(cuda_device, shape):
    q, k, v = _views(*shape, device=cuda_device)
    do = _views(*shape, device=cuda_device, seed=1)[0]
    before = (tattn.flash_attention_fwd_lse.launches,
              tattn.flash_attention_bwd.launches)
    o, lse = tattn.flash_attention_fwd_lse(q, k, v)
    want_o, want_lse = tattn.attention_lse_ref(q, k, v)
    _close(o, want_o, "o", False)
    _close(lse, want_lse, "lse", False)
    grads = tattn.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = tattn.attention_bwd_ref(q, k, v, o, lse, do)
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        assert g.is_contiguous() and g.dtype == torch.bfloat16
        _close(g, w, name, False)
    assert (tattn.flash_attention_fwd_lse.launches,
            tattn.flash_attention_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)


@pytest.mark.cuda
def test_head_major_equals_packed_on_cuda(cuda_device):
    """The two families run the same kernels on the same views: kernel 2
    equals kernel 1, and 5 + 6 equal 3 + 4, bit for bit."""
    q, k, v = _views(1, 577, 16, 64, device=cuda_device)
    do = _views(1, 577, 16, 64, device=cuda_device, seed=1)[0]
    assert torch.equal(tattn.flash_attention(q, k, v),
                       tattn.flash_attention_packed(q, k, v))
    o, lse = tattn.flash_attention_fwd_lse(q, k, v)
    o3, lse3 = tattn.flash_attention_packed_lse(q, k, v)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)
    grad = tattn.flash_attention_packed_bwd(q, k, v, o, lse, do)
    for g, g4 in zip(tattn.flash_attention_bwd(q, k, v, o, lse, do),
                     grad.unbind(2)):
        assert torch.equal(g, g4)


ROUTES = {  # (switches, shape) -> the wrapper that must launch
    "packed": ({}, (1, 577, 16, 64)),
    "switch": ({"OVMONO3D_PACKED_ATTN": "0"}, (1, 577, 16, 64)),
    "bwd_switch": ({"OVMONO3D_PACKED_BWD": "0"}, (1, 577, 16, 64)),
    "unpackable": ({}, (B, N, H, D)),
    "long": ({}, (1, 6145, 2, 64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_dispatcher_routes_as_jax_on_cuda(cuda_device, monkeypatch, route):
    env, shape = ROUTES[route]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    b, n, h, d = shape
    qkv = torch.randn(b, n, 3, h, d, device=cuda_device).to(torch.bfloat16)
    packed_fwd = route in ("packed", "bwd_switch")
    packed_bwd = route == "packed"
    before = _counts()
    with torch.no_grad():
        tattn.dot_product_attention(qkv)
    after = _counts()
    assert after[0][0] - before[0][0] == int(packed_fwd)
    assert after[3][0] - before[3][0] == int(not packed_fwd)
    qkv.requires_grad_()
    tattn.dot_product_attention(qkv).float().square().sum().backward()
    torch.cuda.synchronize()
    done = _counts()
    for i, want in ((1, packed_bwd), (2, packed_bwd), (4, not packed_bwd),
                    (5, not packed_bwd)):
        assert done[i][0] - after[i][0] == int(want), (route, i)


@pytest.mark.cuda
def test_f32_training_raises_on_cuda(cuda_device):
    qkv = torch.randn(1, 40, 3, 2, 64, device=cuda_device,
                      requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 2 item 7"):
        tattn.dot_product_attention(qkv)


@pytest.mark.cuda
def test_head_major_function_matches_plain_through_a_block(cuda_device,
                                                           monkeypatch):
    """One ViT block (trunk width, H=12) forward and backward through
    HeadMajorAttention (OVMONO3D_PACKED_BWD=0) against autograd of
    attention_ref: every gradient within 5e-2 of the plain one's norm."""
    monkeypatch.setenv("OVMONO3D_PACKED_BWD", "0")
    torch.manual_seed(0)
    blk = Block(768, 12, device=cuda_device)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.02)
        blk.ls1.gamma.fill_(0.5)
        blk.ls2.gamma.fill_(0.5)
        blk.norm1.weight.fill_(1.0)
        blk.norm2.weight.fill_(1.0)
    x = torch.randn(2, 577, 768, device=cuda_device)
    grads = {}
    for name, fn in (("kernel", tattn.dot_product_attention),
                     ("plain", lambda qkv: tattn.attention_ref(*qkv.unbind(2)))):
        blk.attn.attn_fn = fn
        blk.zero_grad()
        xi = x.clone().requires_grad_()
        launches = tattn.flash_attention_bwd.launches
        blk(xi).float().square().mean().backward()
        assert tattn.flash_attention_bwd.launches - launches == (
            name == "kernel")
        grads[name] = {"x": xi.grad.clone(),
                       **{n: p.grad.clone() for n, p in blk.named_parameters()}}
    blk.attn.attn_fn = tattn.dot_product_attention
    for n, want in grads["plain"].items():
        rel = ((grads["kernel"][n] - want).norm() / want.norm()).item()
        assert rel <= 5e-2, (n, rel)


TF32_PROBE = textwrap.dedent("""
    import torch
    import torch.nn.functional as F
    from ovmono3d_tpu_torch.config import flagship_config
    from ovmono3d_tpu_torch.models.rcnn3d import build_model

    print("before", torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32)
    model = build_model(flagship_config(224), device="cuda", seed=0)
    conv = model.rpn_head.conv
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, conv.in_channels, 64, 64, device="cuda", generator=g)
    with torch.no_grad():
        got = conv(x).double()
        want = F.conv2d(x.double(), conv.weight.double(), conv.bias.double(),
                        padding=1)
    err = ((got - want).norm() / want.norm()).item()
    print("after", torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32, "rel", err)
    assert err <= 1e-5, err
""")


@pytest.mark.cuda
def test_entry_point_turns_tf32_off_on_cuda(cuda_device):
    """A fresh process builds the model through `build_model` without
    touching the flags; then the RPN head's f32 conv matches a float64 conv
    to 1e-5 relative (with cuDNN's default TF32 it misses by ~1e-3)."""
    run = subprocess.run([sys.executable, "-c", TF32_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "after False False" in run.stdout
