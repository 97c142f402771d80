"""The JAX package's head-major attention family (kernels 2, 5 and 6) in
the port, the f32 forward instance and the routing. The port has no
wrappers of its own for 2, 5 and 6: kernels 1, 3 and 4's wrappers take
head-major strides. On the CPU: the plain versions against the JAX
package's head-major TPU kernels in Pallas interpret mode, the dispatcher's
output and qkv gradient against jax.vjp of the JAX dispatcher at shapes its
gate sends head-major, the dispatcher on CPU tensors and an f32 Depth-Pro
GEO request; on the card (marker `cuda`) the wrappers on head-major views
against the plain versions and against packed views, the dispatcher's
route at every shape, a block's gradients through head-major views and the
entry points' TF32 setting.

JAX is imported inside the fixture that needs it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_attention_headmajor.py
"""
import contextlib
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
            tattn.flash_attention_packed_bwd)


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


@contextlib.contextmanager
def _one_torch_thread():
    """The port's side of a comparison with the JAX kernels, on one torch
    CPU thread. Under the Tier-1 command (six xdist workers, each running
    other JAX tests first with a cold compilation cache), the f32 plain
    forward on two threads returned, in about one process in six, one
    batch element (one thread's share of the batched products) with ~40x
    its usual f32 error (1.8e-5 against 4.3e-7 from float64), past FWD_TOL;
    recomputed in the same process it was exact again, and JAX's output was
    the same in every run. On one thread it was exact in every run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _np(x) -> np.ndarray:
    """A JAX array or a torch tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_tpu_kernel_interpret(jattn, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, _arrays(n=3, seed=1))
    before = _counts()
    with _one_torch_thread():
        got = tattn.attention_ref(tq, tk, tv)
    want = jattn.flash_attention(jq, jk, jv, block_q=64, interpret=True)
    assert got.dtype == tq.dtype and got.shape == (B, N, H, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=FWD_TOL[dtype],
                               rtol=FWD_TOL[dtype])
    assert _counts() == before       # no kernel on CPU tensors


def _jax_lse_natural(jlse, n, clamp=50.0):
    """The JAX head-major lse ([B*H, 1, n_q], log2 of the clamp-shifted
    denominator) in the port's units: natural log, [B, H, N]."""
    return np.asarray(jlse).reshape(B, H, -1)[..., :n] * math.log(2) + clamp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_fwd_lse_matches_tpu_kernel_interpret(jattn, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, _arrays(n=3, seed=2))
    before = _counts()
    with _one_torch_thread():
        out, lse = tattn.attention_lse_ref(tq, tk, tv)
        out = out.to(tq.dtype)
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
    """The plain backward (kernel 4's plain version, which kernel 6's
    head-major route shares) against the JAX fused kernel and the split
    dq / dk-dv pair, each on its own forward's residuals."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(dtype, _arrays(seed=3))
    before = _counts()
    with _one_torch_thread():
        o, lse = tattn.attention_lse_ref(tq, tk, tv)
        got = [g.to(x.dtype) for g, x in zip(
            tattn.attention_bwd_ref(tq, tk, tv, o.to(tq.dtype), lse, tdo),
            (tq, tk, tv))]
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
    with _one_torch_thread():
        _, lse = tattn.attention_lse_ref(tq, tk, tv)
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


@pytest.mark.parametrize("d,h", [(64, 3), (32, 2)])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 128, 129])
def test_training_attention_matches_jax_vjp(jattn, n, d, h):
    """The dispatcher with a gradient (the training operator's CPU pair)
    against jax.vjp of the JAX package's dot_product_attention on the CPU
    (its XLA path), in f32: the output and the gradient of every qkv slot
    within 1e-5, across the 64- and 128-row tile edges, at head groups the
    JAX gate sends head-major (3 x 64 and 2 x 32 do not tile to 128
    lanes)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + n + d)
    qkv = rng.standard_normal((2, n, 3, h, d)).astype(np.float32)
    do = rng.standard_normal((2, n, h, d)).astype(np.float32)
    jout, vjp = jax.vjp(jattn.dot_product_attention,
                        *(jnp.asarray(qkv[:, :, i]) for i in range(3)))
    jgrads = vjp(jnp.asarray(do))
    tqkv = torch.from_numpy(qkv).requires_grad_()
    before = _counts()
    with _one_torch_thread():
        out = tattn.dot_product_attention(tqkv)
        out.backward(torch.from_numpy(do))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(tqkv.grad[:, :, i].numpy(),
                                   np.asarray(jgrads[i]), atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(1, 33, 2, 64), (B, N, H, D),
                                   (1, 40, 4, 32)])
@pytest.mark.parametrize("grad", [False, True])
def test_dispatcher_cpu_stays_plain(shape, grad):
    """CPU tensors run the plain versions at the shapes the JAX gate sends
    to either family alike, and no kernel count moves: the output equals
    attention_ref's, and with a gradient the training operator's plain
    backward, attention_bwd_ref's gradient (from attention_lse_ref's lse),
    exactly."""
    rng = np.random.default_rng(5)
    b, n, h, d = shape
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d)).astype(
        np.float32))
    q, k, v = qkv.unbind(2)
    if grad:
        qkv.requires_grad_()
    before = _counts()
    out = tattn.dot_product_attention(qkv)
    want = tattn.attention_ref(q, k, v)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    if grad:
        out.square().sum().backward()
        lse = tattn.attention_lse_ref(q, k, v)[1]
        grads = tattn.attention_bwd_ref(q, k, v, want, lse, 2 * want)
        torch.testing.assert_close(qkv.grad, torch.stack(grads, dim=2),
                                   rtol=0, atol=0)
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
              wrapper="flash_attention_packed")
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


def _headmajor_views(b, n, h, d, dtype=torch.bfloat16, device="cpu",
                     seed=0, count=3):
    """[B, N, H, D] views of [B, H, N, D] storage: the JAX package's
    head-major [B*H, N, D] layout, read through its head stride N*D."""
    g = torch.Generator().manual_seed(seed)
    store = torch.randn(count, b, h, n, d, generator=g).to(dtype).to(device)
    return tuple(x.transpose(1, 2) for x in store.unbind(0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_kernel2_matches_plain_on_cuda(cuda_device, shape, dtype):
    """Kernel 2, the JAX package's head-major inference forward: kernel 1's
    wrapper on head-major views, bf16 and f32, counted as kernel 1."""
    td = DTYPES[dtype][1]
    q, k, v = _headmajor_views(*shape, dtype=td, device=cuda_device)
    before = (tattn.flash_attention_packed.launches,
              tattn.flash_attention_packed.launches_f32)
    got = tattn.flash_attention_packed(q, k, v)
    torch.cuda.synchronize()
    f32 = td == torch.float32
    assert (tattn.flash_attention_packed.launches,
            tattn.flash_attention_packed.launches_f32) == (
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
    [B, H, N, D] tensor (the JAX package's kernel 2 layout), against f32
    attention_ref, at a small and at Depth-Pro's patch-encoder batch and
    heads."""
    for b, h in ((2, 3), (35, 16)):
        q, k, v = _views(b, n, h, d, dtype=torch.float32,
                         device=cuda_device, seed=n + d)
        _close(tattn.flash_attention_packed(q, k, v),
               tattn.attention_ref(q, k, v), f"packed {b, n, h, d}", True)
        qh, kh, vh = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (q, k, v))
        assert qh.stride(2) == n * d
        _close(tattn.flash_attention_packed(qh, kh, vh),
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
    got = tattn.flash_attention_packed(q, k, v).double()
    want = tattn.attention_ref(q.double(), k.double(), v.double())
    assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4097, 12, 64), (B, N, H, D),
                                   (3, 65, 4, 32)])
def test_kernels_5_6_match_plain_on_cuda(cuda_device, shape):
    """Kernels 5 and 6, the JAX package's head-major training pair: kernels
    3 and 4's wrappers on head-major views (do too), counted as 3 and 4."""
    q, k, v, do = _headmajor_views(*shape, device=cuda_device, count=4)
    before = (tattn.flash_attention_packed_lse.launches,
              tattn.flash_attention_packed_bwd.launches)
    o, lse = tattn.flash_attention_packed_lse(q, k, v)
    want_o, want_lse = tattn.attention_lse_ref(q, k, v)
    _close(o, want_o, "o", False)
    _close(lse, want_lse, "lse", False)
    grad = tattn.flash_attention_packed_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = tattn.attention_bwd_ref(q, k, v, o, lse, do)
    assert grad.shape == (*shape[:2], 3, *shape[2:])
    assert grad.dtype == torch.bfloat16
    for g, w, name in zip(grad.unbind(2), want, ("dq", "dk", "dv")):
        _close(g, w, name, False)
    assert (tattn.flash_attention_packed_lse.launches,
            tattn.flash_attention_packed_bwd.launches) == (before[0] + 1,
                                                           before[1] + 1)


@pytest.mark.cuda
def test_head_major_equals_packed_on_cuda(cuda_device):
    """The wrappers read through strides: on head-major copies of packed
    views (kernels 2, 5 and 6's layout) kernels 1, 3 and 4 give the packed
    views' results bit for bit."""
    q, k, v = _views(1, 577, 16, 64, device=cuda_device)
    do = _views(1, 577, 16, 64, device=cuda_device, seed=1)[0]
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous().transpose(1, 2)
                       for x in (q, k, v, do))
    assert qh.stride(2) == 577 * 64 and q.stride(2) == 64
    assert torch.equal(tattn.flash_attention_packed(qh, kh, vh),
                       tattn.flash_attention_packed(q, k, v))
    o, lse = tattn.flash_attention_packed_lse(qh, kh, vh)
    o3, lse3 = tattn.flash_attention_packed_lse(q, k, v)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)
    assert torch.equal(
        tattn.flash_attention_packed_bwd(qh, kh, vh, o, lse, doh),
        tattn.flash_attention_packed_bwd(q, k, v, o3, lse3, do))


# Shapes the JAX gate sends to either family: 16 heads of 64 (packed), 3 of
# 32 (head-major: no head group tiles to 128 lanes), N past 6144
# (head-major, and differentiated through XLA in training).
ROUTE_SHAPES = [(1, 577, 16, 64), (B, N, H, D), (1, 6145, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_dispatcher_takes_kernels_1_3_4_at_every_shape_on_cuda(cuda_device,
                                                               shape):
    """One route on the card: kernel 1 without a gradient, kernels 3 + 4
    with one, at every shape, and no other attention wrapper."""
    b, n, h, d = shape
    qkv = torch.randn(b, n, 3, h, d, device=cuda_device).to(torch.bfloat16)
    before = _counts()
    with torch.no_grad():
        tattn.dot_product_attention(qkv)
    after = _counts()
    assert [a[0] - c[0] for a, c in zip(after, before)] == [1, 0, 0]
    qkv.requires_grad_()
    tattn.dot_product_attention(qkv).float().square().sum().backward()
    torch.cuda.synchronize()
    done = _counts()
    assert [a[0] - c[0] for a, c in zip(done, after)] == [0, 1, 1]
    assert qkv.grad.shape == qkv.shape


@pytest.mark.cuda
def test_f32_training_raises_on_cuda(cuda_device):
    qkv = torch.randn(1, 40, 3, 2, 64, device=cuda_device,
                      requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 2 item 7"):
        tattn.dot_product_attention(qkv)


def _headmajor_qkv(qkv: torch.Tensor) -> torch.Tensor:
    """qkv [B, N, 3, H, D] as a view of [3, B, H, N, D] storage."""
    return qkv.permute(2, 0, 3, 1, 4).contiguous().permute(1, 3, 0, 2, 4)


@pytest.mark.cuda
def test_head_major_function_matches_plain_through_a_block(cuda_device):
    """One ViT block (trunk width, H=12) forward and backward with its qkv
    handed to the training operator as head-major views (kernels 5 + 6's
    layout, run by 3 + 4) against autograd of attention_ref: every gradient
    within 5e-2 of the plain one's norm."""
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
    for name, fn in (("kernel", lambda qkv: tattn.dot_product_attention(
                         _headmajor_qkv(qkv))),
                     ("plain", lambda qkv: tattn.attention_ref(*qkv.unbind(2)))):
        blk.attn.attn_fn = fn
        blk.zero_grad()
        xi = x.clone().requires_grad_()
        launches = tattn.flash_attention_packed_bwd.launches
        blk(xi).float().square().mean().backward()
        assert tattn.flash_attention_packed_bwd.launches - launches == (
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
