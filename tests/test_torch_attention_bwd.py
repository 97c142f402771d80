"""The port's training attention: the plain forward-with-lse and backward
against autograd and against the JAX package's TPU kernels (Pallas interpret
mode), the backward's stats pass (delta, lse2) against the JAX package's,
the wrappers' checks on the CPU, and on the card (marker `cuda`) kernels 3
and 4 (also on the storage orders of the JAX package's head-major kernel
6), the stats pass and the autograd Function against the plain versions.

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
from ovmono3d_tpu_torch.probes import flash_bwd as bwd_probe

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


def _spy_pallas_calls(jattn, monkeypatch):
    """Record the arguments of every Pallas kernel the JAX package calls
    (run its wrappers under jax.disable_jit to see concrete arrays)."""
    seen = []
    orig = jattn.pl.pallas_call

    def spy(*args, **kwargs):
        kernel = orig(*args, **kwargs)

        def call(*operands):
            seen.append(operands)
            return kernel(*operands)
        return call

    monkeypatch.setattr(jattn.pl, "pallas_call", spy)
    return seen


@pytest.mark.parametrize("shape", [(2, 150, 3, 32), (1, 77, 2, 64)])
def test_stats_ref_matches_jax_package(jattn, monkeypatch, shape):
    """attention_bwd_delta_ref and attention_bwd_stats_ref against the delta
    and the padded lse that the JAX package's flash_attention_bwd hands its
    split Pallas pair (recorded from the pallas_call operands, interpret
    mode) at the JAX tests' shapes. The JAX lse is log2 of its softmax
    denominator shifted by the clamp c = 50 and padded with 1e30; the
    port's lse2 is log2 of the unshifted one, padded with +inf."""
    import jax
    import jax.numpy as jnp

    b, n, h, d = shape
    q, k, v, do = _arrays(b, n, h, d, seed=6)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jlse = jattn.flash_attention_fwd_lse(jq, jk, jv, block_q=64,
                                             interpret=True)
    seen = _spy_pallas_calls(jattn, monkeypatch)
    with jax.disable_jit():
        jattn.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, block_q=64,
                                  block_k=64, fused=False, interpret=True)
    # (q, k, v, do, lse, delta, mask) of the dq kernel, [b*h, 1, n_q].
    jax_lse2, jax_delta = (np.asarray(seen[0][i])[:, 0].reshape(b, h, -1)
                           for i in (4, 5))
    o = torch.from_numpy(np.array(jo))
    tdo = torch.from_numpy(do)
    lse = torch.from_numpy(jax_lse2[..., :n] * math.log(2) + 50.0)
    delta = tattn.attention_bwd_delta_ref(o, tdo)
    # Both f32 sums of the same products, in another order.
    np.testing.assert_allclose(delta.numpy(), jax_delta[..., :n], rtol=1e-5,
                               atol=1e-5)
    n_pad = jax_lse2.shape[-1]
    assert n_pad > n
    stats = tattn.attention_bwd_stats_ref(o, tdo, lse, n_pad=n_pad)
    assert stats.shape == (2, b, h, n_pad) and stats.dtype == torch.float32
    torch.testing.assert_close(stats[0, ..., :n], delta)
    np.testing.assert_allclose(stats[1, ..., :n].numpy(),
                               jax_lse2[..., :n] + 50.0 / math.log(2),
                               rtol=1e-6, atol=1e-5)
    assert (stats[0, ..., n:] == 0).all()
    assert torch.isposinf(stats[1, ..., n:]).all()
    assert (jax_delta[..., n:] == 0).all() and (jax_lse2[..., n:] >= 1e30).all()


def test_bwd_stats_runs_plain_on_cpu_and_backs_the_backward_formula():
    """The stats hook runs attention_bwd_stats_ref on CPU tensors; its lse2
    rebuilds attention_bwd_ref's p."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(1, 40, 2, 32, seed=7))
    o, lse = tattn.attention_lse_ref(q, k, v)
    stats = tattn._bwd_stats(o, do, lse)
    torch.testing.assert_close(stats, tattn.attention_bwd_stats_ref(o, do,
                                                                   lse))
    logits2 = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(32) / math.log(2)
    p = torch.exp2(logits2 - stats[1, ..., :40, None])
    torch.testing.assert_close(p.sum(-1), torch.ones(1, 2, 40), rtol=1e-5,
                               atol=1e-5)


def test_probe_bound_is_the_backward_flops():
    """The backward probe's bound: 10 B H N^2 D flops at 989 TFLOP/s, 0.1303
    ms at the LIFT trunk; its shapes are the ones the issue names."""
    bound, by = bwd_probe.bound_ms((1, 4097, 12, 64))
    assert by == "operations" and abs(bound - 0.13026) < 1e-4
    assert set(bwd_probe.SHAPES) == {"trunk", "train_b8", "long", "ragged"}


@pytest.mark.parametrize("n_pad", [None, 40, 128])
def test_stats_ref_pads_past_n(n_pad):
    """attention_bwd_stats_ref at N = 40: n_pad defaults to N; the rows past
    N hold delta = 0 and lse2 = +inf, those before it the unpadded stats;
    an n_pad below N is refused."""
    o, do = (torch.from_numpy(x) for x in _arrays(2, 40, 3, 32, seed=8)[:2])
    lse = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 3, 40)).astype(np.float32))
    stats = tattn.attention_bwd_stats_ref(o, do, lse, n_pad=n_pad)
    assert stats.shape == (2, 2, 3, n_pad or 40)
    torch.testing.assert_close(stats[0, ..., :40],
                               tattn.attention_bwd_delta_ref(o, do))
    torch.testing.assert_close(stats[1, ..., :40], lse / math.log(2))
    assert (stats[0, ..., 40:] == 0).all()
    assert torch.isposinf(stats[1, ..., 40:]).all()
    with pytest.raises(ValueError, match="n_pad"):
        tattn.attention_bwd_stats_ref(o, do, lse, n_pad=39)


def test_dispatcher_cpu_autograd_runs_plain_path():
    """With a gradient, CPU tensors run the training operator's plain pair:
    its output is attention_ref's and its gradient attention_bwd_ref's (from
    attention_lse_ref's lse), exactly, and no kernel count moves."""
    counts = (tattn.flash_attention_packed_lse.launches,
              tattn.flash_attention_packed_bwd.launches)
    qkv = torch.from_numpy(
        np.random.default_rng(4).standard_normal((1, 33, 3, 2, 64))
        .astype(np.float32)).requires_grad_()
    out = tattn.dot_product_attention(qkv)
    out.square().sum().backward()
    q, k, v = qkv.detach().unbind(2)
    want = tattn.attention_ref(q, k, v)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    lse = tattn.attention_lse_ref(q, k, v)[1]
    grads = tattn.attention_bwd_ref(q, k, v, want, lse, 2 * want)
    torch.testing.assert_close(qkv.grad, torch.stack(grads, dim=2), rtol=0,
                               atol=0)
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


# Kernel 4 on kernel 6's storage orders (and the stats pass) at the wgmma
# design's tile edges: 64-row stages, 128-row units; N = 4097 ends on a
# one-row tile.
EDGE_NS = [64, 128, 129, 77, 4097]


def _check_grads(grads, q, k, v, o, lse, do):
    want = tattn.attention_bwd_ref(q, k, v, o, lse, do)
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        _close(g, w, name)


def _headmajor(b, n, h, d, device, seed, layout=(0, 1, 2, 3)):
    """q, k, v, do as [B, N, H, D] views of storage laid out in `layout`'s
    order of the dims (B, N, H, D): (0, 1, 2, 3) is contiguous."""
    g = torch.Generator().manual_seed(seed)
    shape = (b, n, h, d)
    store = [shape[i] for i in layout]
    back = [layout.index(i) for i in range(4)]
    return [torch.randn(*store, generator=g).to(torch.bfloat16).to(device)
            .permute(*back) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS)
def test_kernel_6_matches_plain_on_contiguous_storage(cuda_device, n):
    b = 1 if n > 1000 else 2
    q, k, v, do = _headmajor(b, n, 12, 64, cuda_device, seed=n)
    o, lse = tattn.flash_attention_packed_lse(q, k, v)
    launches = tattn.flash_attention_packed_bwd.launches
    grad = tattn.flash_attention_packed_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert tattn.flash_attention_packed_bwd.launches == launches + 1
    assert grad.is_contiguous()
    _check_grads(grad.unbind(2), q, k, v, o, lse, do)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(2, 1, 0, 3), (1, 2, 0, 3)])
def test_kernel_6_takes_unsorted_strides(cuda_device, layout):
    """Head-major views whose batch stride is the smallest or whose head
    stride is the largest: the tensor maps sort the dims by stride."""
    q, k, v, do = _headmajor(2, 129, 4, 64, cuda_device, seed=9,
                             layout=layout)
    o, lse = tattn.flash_attention_packed_lse(q, k, v)
    _check_grads(tattn.flash_attention_packed_bwd(q, k, v, o, lse,
                                                  do).unbind(2),
                 q, k, v, o, lse, do)


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS)
@pytest.mark.parametrize("d", [32, 64])
def test_bwd_stats_kernel_matches_plain_on_cuda(cuda_device, n, d):
    q, k, v = _packed(2, n, 3, d, device=cuda_device, seed=n).unbind(2)
    do = _packed(2, n, 3, d, device=cuda_device, seed=n + 1)[:, :, 1]
    o, lse = tattn.flash_attention_packed_lse(q, k, v)
    got = tattn._bwd_stats(o, do, lse)
    assert got.shape[:3] == (2, 2, 3) and got.shape[-1] >= n
    want = tattn.attention_bwd_stats_ref(o, do, lse, n_pad=got.shape[-1])
    _close(got[0], want[0], "delta")
    # lse2: the same f32 product; +inf past N on both.
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)


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
