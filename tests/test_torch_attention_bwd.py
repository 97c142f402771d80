"""The port's training attention: the plain forward-with-lse and backward
against autograd and against the JAX package's TPU kernels (Pallas interpret
mode), the wrappers' checks on the CPU, and on the card (marker `cuda`)
kernels 3 and 4 and the autograd Function against the plain versions.

JAX is imported inside the fixture that needs it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_attention_bwd.py
"""
import math

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.models.vit import Block
from ovmono3d_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


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


def _arrays(b, n, h, d, scales=(1.0, 1.0, 1.0, 1.0), seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, n, h, d)) * s).astype(np.float32)
            for s in scales]


def test_bwd_ref_equals_autograd_of_attention_ref():
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(2, 37, 3, 16, seed=1))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = tattn.attention_ref(q, k, v)
    out.backward(do)
    o, lse = tattn.attention_lse_ref(q.detach(), k.detach(), v.detach())
    # Both f32; the explicit formula sums in another order than autograd.
    torch.testing.assert_close(o, out.detach(), rtol=1e-5, atol=1e-6)
    got = tattn.attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse,
                                  do)
    for g, x in zip(got, (q, k, v)):
        torch.testing.assert_close(g, x.grad, rtol=1e-5, atol=1e-5)


def test_lse_ref_is_the_log_normalizer():
    q, k, v = (torch.from_numpy(x) for x in _arrays(1, 20, 2, 8, seed=2)[:3])
    _, lse = tattn.attention_lse_ref(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(8)
    # f32 logsumexp against an f64 sum of exponentials.
    want = torch.log(torch.exp(logits.double()).sum(-1)).float()
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_refs_match_tpu_kernels_interpret(jattn):
    """attention_lse_ref / attention_bwd_ref against the TPU kernels 3 and 4
    (`flash_attention_packed_lse` / `flash_attention_packed_bwd`) in Pallas
    interpret mode, at logits inside the TPU kernels' clamp window, where
    their clamped softmax is exact. The TPU lse is base 2, shifted by the
    clamp c = 50 and laid out [b, h/g, g, n_q]: natural = lse * ln 2 + 50."""
    import jax.numpy as jnp

    b, n, h, d = 1, 77, 2, 64
    q, k, v, do = _arrays(b, n, h, d, scales=(2.0, 1.0, 1.0, 1.0), seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jlse = jattn.flash_attention_packed_lse(jq, jk, jv, num_heads=h,
                                                interpret=True)
    jgrads = jattn.flash_attention_packed_bwd(jq, jk, jv, jo, jlse, jdo,
                                              num_heads=h, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tattn.attention_lse_ref(tq, tk, tv)
    want_lse = (np.asarray(jlse).reshape(b, h, -1)[..., :n] * math.log(2)
                + 50.0)
    # f32 throughout; the TPU kernel takes exp2 of logits pre-scaled by
    # log2(e) and clamped, the plain version exp of the logits.
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-4)
    got = tattn.attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    for g, w, name in zip(got, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_dispatcher_cpu_autograd_runs_plain_path():
    counts = (tattn.flash_attention_packed_lse.launches,
              tattn.flash_attention_packed_bwd.launches)
    qkv = torch.from_numpy(
        np.random.default_rng(4).standard_normal((1, 33, 3, 2, 64))
        .astype(np.float32)).requires_grad_()
    out = tattn.dot_product_attention(qkv)
    out.square().sum().backward()
    ref = qkv.detach().clone().requires_grad_()
    tattn.attention_ref(*ref.unbind(2)).square().sum().backward()
    torch.testing.assert_close(qkv.grad, ref.grad, rtol=0, atol=0)
    assert (tattn.flash_attention_packed_lse.launches,
            tattn.flash_attention_packed_bwd.launches) == counts


def _packed(b, n, h, d, device="cpu", seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    qkv = (torch.randn(b, n, 3, h, d, generator=g) * scale).to(
        torch.bfloat16).to(device)
    return qkv


def test_lse_wrapper_takes_views_and_refuses_the_cpu():
    q, k, v = _packed(2, 77, 12, 64).unbind(2)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_packed_lse(q, k, v)


@pytest.mark.parametrize("bad,match", [
    ("do_dtype", "bfloat16"), ("do_stride", "unit stride"),
    ("lse_shape", "lse"), ("o_shape", "shape"),
])
def test_bwd_wrapper_rejects(bad, match):
    q, k, v = _packed(1, 40, 2, 64).unbind(2)
    o = torch.zeros(1, 40, 2, 64, dtype=torch.bfloat16)
    do = torch.zeros_like(o)
    lse = torch.zeros(1, 2, 40)
    if bad == "do_dtype":
        do = do.float()
    elif bad == "do_stride":
        do = torch.zeros(1, 40, 2, 128, dtype=torch.bfloat16)[..., ::2]
    elif bad == "lse_shape":
        lse = torch.zeros(1, 40, 2)
    elif bad == "o_shape":
        o = o[:, :39]
    with pytest.raises(ValueError, match=match):
        tattn.flash_attention_packed_bwd(q, k, v, o, lse, do)


# On the card: kernels 3 and 4 against the plain versions on the main path's
# shapes (trunk, Depth-Pro, small ragged), at the 64-row tile edges and at
# kernel 3's 128-row ones (one partial tile, one full tile, one row past a
# tile), and long.
CUDA_SHAPES = [(1, 4097, 12, 64), (1, 577, 16, 64), (2, 77, 12, 64),
               (1, 1, 2, 64), (1, 64, 2, 64), (3, 65, 4, 64),
               (2, 128, 12, 64), (2, 129, 12, 64), (1, 8192, 12, 64)]


def _close(got, want, what):
    """bf16 inputs on both sides; the kernels round o, p, ds and the outputs
    to bf16 where the plain version stays in f32. The error is held to 5% of
    the largest |ref| and 1% of the mean |ref|."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    assert torch.isfinite(got).all(), what
    assert err.max().item() <= 5e-2 * ref.max().item(), what
    assert err.mean().item() <= 1e-2 * ref.mean().item(), what


def _check_kernels(q, k, v, do):
    launches = (tattn.flash_attention_packed_lse.launches,
                tattn.flash_attention_packed_bwd.launches)
    o, lse = tattn.flash_attention_packed_lse(q, k, v)
    want_o, want_lse = tattn.attention_lse_ref(q, k, v)
    _close(o, want_o, "o")
    _close(lse, want_lse, "lse")
    grad = tattn.flash_attention_packed_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = tattn.attention_bwd_ref(q, k, v, o, lse, do)
    for g, w, name in zip(grad.unbind(2), want, ("dq", "dk", "dv")):
        _close(g, w, name)
    assert (tattn.flash_attention_packed_lse.launches,
            tattn.flash_attention_packed_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernels_3_4_match_plain_on_cuda(cuda_device, shape):
    q, k, v = _packed(*shape, device=cuda_device).unbind(2)
    do = _packed(*shape, device=cuda_device, seed=1)[:, :, 0]
    _check_kernels(q, k, v, do)


@pytest.mark.cuda
def test_kernels_3_4_take_any_strides_on_cuda(cuda_device):
    """Separate contiguous q/k/v/do, and head-major [B, H, N, D] views (the
    second at Depth-Pro's width, a ragged last tile: 577 = 4 * 128 + 65)."""
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(2, 200, 3, 64, generator=g).to(torch.bfloat16)
                   .to(cuda_device) for _ in range(4))
    _check_kernels(q, k, v, do)
    for b, h, n in ((2, 3, 200), (4, 16, 577)):
        q, k, v, do = (torch.randn(b, h, n, 64, generator=g)
                       .to(torch.bfloat16).to(cuda_device).transpose(1, 2)
                       for _ in range(4))
        _check_kernels(q, k, v, do)


@pytest.mark.cuda
def test_function_matches_plain_autograd_through_a_block(cuda_device):
    """One ViT block with the trunk's width, forward and backward, with the
    autograd Function against autograd of attention_ref: every parameter
    gradient and the input gradient within 5e-2 of the plain one's norm."""
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
        launches = tattn.flash_attention_packed_bwd.launches
        blk(xi).float().square().mean().backward()
        ran = tattn.flash_attention_packed_bwd.launches - launches
        assert ran == (1 if name == "kernel" else 0)
        grads[name] = {"x": xi.grad.clone(),
                       **{n: p.grad.clone() for n, p in blk.named_parameters()}}
    blk.attn.attn_fn = tattn.dot_product_attention
    for n, want in grads["plain"].items():
        got = grads["kernel"][n]
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= 5e-2, (n, rel)
