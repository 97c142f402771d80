"""The port's decomposed rel-pos attention (SAM encoder blocks): the plain
version against the JAX package's XLA path and its TPU kernel in interpret
mode, the dispatcher and the kernel wrapper's checks on the CPU, and the
CUDA kernel (kernel 7) against the plain version on the card (marker
`cuda`); the dispatcher on the card with a gradient runs the training
kernels (tests/test_torch_relpos_bwd.py holds those).

JAX is imported inside the fixture that needs it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_relpos.py
"""
import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_relpos():
    pytest.importorskip("jax")
    from ovmono3d_tpu.models.vit import _rel_pos_attention_fast
    from ovmono3d_tpu.ops.attention import rel_pos_flash_attention

    return _rel_pos_attention_fast, rel_pos_flash_attention


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


def _inputs(b, grid, h, d, qkv_scale=0.3, rel_scale=0.05, seed=0):
    """q, k, v [B, N, H, D] and tables Rh [gh, gh, D], Rw [gw, gw, D]."""
    rng = np.random.default_rng(seed)
    gh, gw = grid
    n = gh * gw
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               * qkv_scale for _ in range(3))
    rh = rng.standard_normal((gh, gh, d)).astype(np.float32) * rel_scale
    rw = rng.standard_normal((gw, gw, d)).astype(np.float32) * rel_scale
    return q, k, v, rh, rw


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("grid", [(4, 4), (6, 10)])
def test_rel_pos_ref_matches_jax_fast(jax_relpos, dtype, grid):
    import jax.numpy as jnp

    fast, _ = jax_relpos
    q, k, v, rh, rw = _inputs(2, grid, 3, 32, qkv_scale=1.0, rel_scale=0.3,
                              seed=1)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = fast(*(jnp.asarray(x).astype(jd) for x in (q, k, v, rh, rw)),
                grid, None)
    got = tattn.rel_pos_attention_ref(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)),
        torch.from_numpy(rh), torch.from_numpy(rw), grid)
    assert got.dtype == td and got.shape == q.shape
    # f32: the same math summed in another order. bf16: both round the
    # probabilities and the output to bf16 (2^-8 relative), once each.
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("grid,h,d", [((16, 16), 2, 64), ((6, 10), 3, 32)])
def test_rel_pos_ref_matches_tpu_kernel_interpret(jax_relpos, grid, h, d):
    """The TPU kernel's own semantics (Pallas interpret mode) with f32
    inputs inside its clamp window, where its clamped softmax is exact; the
    port's bias factors feed it."""
    import jax.numpy as jnp

    _, kernel = jax_relpos
    q, k, v, rh, rw = _inputs(2, grid, h, d, seed=2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    trh, trw = torch.from_numpy(rh), torch.from_numpy(rw)
    qrh, qrw = tattn.rel_pos_factors(tq, trh, trw, grid)
    want = kernel(*(jnp.asarray(x) for x in (q, k, v)),
                  jnp.asarray(qrh.numpy()), jnp.asarray(qrw.numpy()), grid, h,
                  clamp_c=50.0, interpret=True)
    got = tattn.rel_pos_attention_ref(tq, tk, tv, trh, trw, grid)
    # f32; exp2 of pre-scaled logits against exp of scaled logits.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_rel_pos_factors_match_jax_einsums():
    """qrh/qrw as the JAX package computes them before its kernel (bf16 q
    and tables, f32 products and sums), without its later bf16 cast."""
    jnp = pytest.importorskip("jax.numpy")
    grid, h, d = (6, 10), 2, 64
    q, _, _, rh, rw = _inputs(1, grid, h, d, qkv_scale=1.0, rel_scale=0.3,
                              seed=3)
    jq = jnp.asarray(q).astype(jnp.bfloat16).reshape(1, *grid, h, d)
    want_h = jnp.einsum("brcnd,rkd->brcnk", jq,
                        jnp.asarray(rh).astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    want_w = jnp.einsum("brcnd,ckd->brcnk", jq,
                        jnp.asarray(rw).astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    qrh, qrw = tattn.rel_pos_factors(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(rh),
        torch.from_numpy(rw), grid)
    assert qrh.dtype == qrw.dtype == torch.float32
    assert qrh.is_contiguous() and qrw.is_contiguous()
    # Exact bf16 products summed in f32, in another order.
    np.testing.assert_allclose(qrh.numpy(),
                               np.asarray(want_h).reshape(1, 60, h, 6),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qrw.numpy(),
                               np.asarray(want_w).reshape(1, 60, h, 10),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatcher_cpu_runs_plain_path(dtype):
    tattn.rel_pos_flash_attention.launches = 0
    q, k, v, rh, rw = _inputs(2, (4, 5), 2, 64, seed=4)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).to(dtype)
    trh, trw = torch.from_numpy(rh), torch.from_numpy(rw)
    out = tattn.rel_pos_attention(qkv, trh, trw, (4, 5))
    want = tattn.rel_pos_attention_ref(*qkv.unbind(2), trh, trw, (4, 5))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert tattn.rel_pos_flash_attention.launches == 0


def _packed(b, grid, h, d, dtype=torch.bfloat16, device="cpu", seed=0,
            rel_std=0.1):
    """q/k/v as the encoder makes them (views of one [B, N, 3*H*D] tensor)
    and the bias factors from tables of about a trained table's scale."""
    g = torch.Generator().manual_seed(seed)
    gh, gw = grid
    n = gh * gw
    qkv = torch.randn(b, n, 3 * h * d, generator=g).to(dtype).to(device)
    q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
    rh = (torch.randn(gh, gh, d, generator=g) * rel_std).to(device)
    rw = (torch.randn(gw, gw, d, generator=g) * rel_std).to(device)
    return q, k, v, rh, rw


def test_wrapper_takes_the_encoders_strided_views():
    q, k, v, rh, rw = _packed(2, (14, 14), 16, 80)
    assert q.stride() == (196 * 3 * 1280, 3 * 1280, 80, 1)
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, (14, 14))
    # Every layout check passes; only the device is refused on the CPU.
    with pytest.raises(ValueError, match="CUDA"):
        tattn.rel_pos_flash_attention(q, k, v, qrh, qrw, (14, 14))


@pytest.mark.parametrize("bad,match", [
    ("dtype", "bfloat16"), ("head_dim", "head dim"), ("stride", "unit stride"),
    ("grad", "forward-only"), ("shape", "shape"), ("align", "aligned"),
    ("grid", "tokens"), ("qrh_dtype", "qrh"), ("qrw_shape", "qrw"),
    ("qrh_strided", "qrh"), ("bias_terms", "gh \\+ gw"),
])
def test_wrapper_rejects(bad, match):
    grid = (5, 8)
    q, k, v, rh, rw = _packed(1, grid, 2, 64)
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    if bad == "dtype":
        q = q.float()
    elif bad == "head_dim":
        q, k, v, rh, rw = _packed(1, grid, 4, 32)
        qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    elif bad == "stride":
        v = torch.zeros(1, 40, 2, 128, dtype=v.dtype)[..., ::2]
    elif bad == "grad":
        qrh = qrh.detach().requires_grad_()
    elif bad == "shape":
        k = k[:, :39]
    elif bad == "align":
        qkv = torch.zeros(1, 40, 3 * 128 + 1, dtype=torch.bfloat16)
        q = qkv[..., 1:].view(1, 40, 3, 2, 64)[:, :, 0]
    elif bad == "grid":
        grid = (4, 8)
    elif bad == "qrh_dtype":
        qrh = qrh.to(torch.bfloat16)
    elif bad == "qrw_shape":
        qrw = qrw[..., :7].contiguous()
    elif bad == "qrh_strided":
        qrh = qrh.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "bias_terms":
        grid = (3, 126)                     # 129 bias terms a row
        q, k, v, rh, rw = _packed(1, grid, 2, 64)
        qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    with pytest.raises(ValueError, match=match):
        tattn.rel_pos_flash_attention(q, k, v, qrh, qrw, grid)


# On the card: kernel 7 against the plain version at the smoke's shapes
# (SAM ViT-H global and windowed, SAM ViT-B global, a small ragged grid) and
# at the tile edges.
CUDA_SHAPES = [(1, (64, 64), 16, 80), (25, (14, 14), 16, 80),
               (1, (64, 64), 12, 64), (2, (6, 10), 12, 64),
               (1, (1, 1), 2, 80), (1, (8, 8), 2, 64), (3, (5, 13), 4, 80),
               # the 128-row tile's edges (one full tile, one row past it)
               # and the largest bias table (gh + gw = 128)
               (2, (8, 16), 4, 80), (2, (3, 43), 4, 64),
               (1, (2, 126), 2, 80), (25, (14, 14), 16, 64)]


def check_kernel(q, k, v, rh, rw, grid, absolute=True):
    before = tattn.rel_pos_flash_attention.launches
    qrh, qrw = tattn.rel_pos_factors(q, rh, rw, grid)
    got = tattn.rel_pos_flash_attention(q, k, v, qrh, qrw, grid).float()
    torch.cuda.synchronize()
    assert tattn.rel_pos_flash_attention.launches == before + 1
    want = tattn.rel_pos_attention_ref(q, k, v, rh, rw, grid).float()
    err, ref = (got - want).abs(), want.abs()
    # As kernel 1's test: bf16 output and bf16 probabilities in PV on both
    # sides, rounded at different points; absolute limits, and relative ones
    # where the outputs are small.
    if absolute:
        assert err.max().item() <= 2e-2
        assert err.mean().item() <= 2e-3
    assert err.max().item() <= 5e-2 * ref.max().item()
    assert err.mean().item() <= 1e-2 * ref.mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, shape):
    b, grid, h, d = shape
    check_kernel(*_packed(b, grid, h, d, device=cuda_device), grid)


@pytest.mark.cuda
def test_kernel_is_exact_for_large_bias_on_cuda(cuda_device):
    """A bias of tens (beyond the TPU kernel's clamp window): the online
    softmax stays finite and matches the plain version. The softmax is then
    nearly one-hot, so outputs are single entries of v up to ~5, where one
    bf16 ulp (2^-5) is above the absolute limit: the relative limits hold
    it."""
    grid = (12, 12)
    q, k, v, rh, rw = _packed(2, grid, 2, 80, device=cuda_device, seed=5,
                              rel_std=3.0)
    check_kernel(q, k, v, rh, rw, grid, absolute=False)


@pytest.mark.cuda
def test_dispatcher_on_cuda(cuda_device):
    grid = (14, 14)
    q, k, v, rh, rw = _packed(2, grid, 4, 80, device=cuda_device, seed=6)
    qkv = torch.stack([q, k, v], dim=2)
    before = tattn.rel_pos_flash_attention.launches
    with torch.no_grad():
        out = tattn.rel_pos_attention(qkv, rh, rw, grid)
    assert tattn.rel_pos_flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    # With a gradient: kernel 7's lse instance and the backward kernel, not
    # the inference instance; the tables' gradient within 3e-2 of f32
    # autograd through the plain version
    # (tests/test_torch_relpos_bwd.py holds every gradient).
    lse_before = tattn.rel_pos_flash_attention_lse.launches
    bwd_before = tattn.rel_pos_flash_attention_bwd.launches
    rh_g = rh.detach().requires_grad_()
    got = torch.autograd.grad(
        tattn.rel_pos_attention(qkv, rh_g, rw, grid).float().sum(), rh_g)[0]
    assert tattn.rel_pos_flash_attention.launches == before + 1
    assert tattn.rel_pos_flash_attention_lse.launches == lse_before + 1
    assert tattn.rel_pos_flash_attention_bwd.launches == bwd_before + 1
    rh32 = rh.detach().requires_grad_()
    want = torch.autograd.grad(tattn.rel_pos_attention_ref(
        *qkv.float().unbind(2), rh32, rw, grid).sum(), rh32)[0]
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()
    # f32 stays the plain exact branch on the card.
    with torch.no_grad():
        out32 = tattn.rel_pos_attention(qkv.float(), rh, rw, grid)
    assert out32.dtype == torch.float32
    assert tattn.rel_pos_flash_attention.launches == before + 1
