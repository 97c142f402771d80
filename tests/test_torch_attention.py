"""The port's attention: the plain version against the JAX package, the
dispatcher and the kernel wrapper's checks on the CPU, and the CUDA kernel
against the plain version on the card (marker `cuda`).

JAX is imported inside the fixture that needs it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_attention.py
"""
import numpy as np
import pytest
import torch

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
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


def _qkv(b, n, h, d, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, n, h, d)) * s).astype(np.float32)
            for s in (scale, 1.0, 1.0)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_ref_matches_attention_xla(jattn, dtype):
    import jax.numpy as jnp

    q, k, v = _qkv(2, 77, 3, 32, seed=1)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = jattn.attention_xla(*(jnp.asarray(x).astype(jd) for x in (q, k, v)))
    got = tattn.attention_ref(*(torch.from_numpy(x).to(td) for x in (q, k, v)))
    assert got.dtype == td
    # f32: the same math, summed in another order. bf16: both round the
    # probabilities and the output to bf16 (2^-8 relative), once each.
    atol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=atol)


def test_attention_ref_matches_tpu_kernel_interpret(jattn):
    """The TPU kernel's own semantics (Pallas interpret mode) at logits inside
    its clamp window, where its clamped softmax is exact."""
    import jax.numpy as jnp

    q, k, v = _qkv(1, 77, 2, 64, scale=2.0, seed=2)   # row max logits ~5
    want = jattn.flash_attention_packed(
        *(jnp.asarray(x) for x in (q, k, v)), num_heads=2, interpret=True)
    got = tattn.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)))
    # f32; exp2 of pre-scaled logits against exp of scaled logits.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_dispatcher_cpu_runs_plain_path():
    tattn.flash_attention_packed.launches = 0
    qkv = torch.from_numpy(np.stack(_qkv(1, 33, 2, 64, seed=3), axis=2))
    q, k, v = qkv.unbind(2)
    out = tattn.dot_product_attention(qkv)
    torch.testing.assert_close(out, tattn.attention_ref(q, k, v), rtol=0,
                               atol=0)
    assert tattn.flash_attention_packed.launches == 0


def _packed_views(b, n, h, d, dtype=torch.bfloat16, device="cpu", seed=0):
    """q/k/v as the model makes them: views of one [B, N, 3*H*D] tensor."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * d, generator=g).to(dtype).to(device)
    return qkv.view(b, n, 3, h, d).unbind(2)


def test_wrapper_takes_the_models_strided_views():
    q, k, v = _packed_views(2, 77, 12, 64)
    assert q.stride() == (77 * 3 * 768, 3 * 768, 64, 1)
    # Every layout check passes; only the device is refused on the CPU.
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_packed(q, k, v)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "bfloat16"), ("head_dim", "head dim"), ("stride", "unit stride"),
    ("grad", "forward-only"), ("shape", "shape"), ("align", "aligned"),
])
def test_wrapper_rejects(bad, match):
    q, k, v = _packed_views(1, 40, 2, 64)
    if bad == "dtype":
        q = q.float()
    elif bad == "head_dim":          # the kernels take 32 and 64
        q, k, v = _packed_views(1, 40, 2, 80)
    elif bad == "stride":
        v = torch.zeros(1, 40, 2, 128, dtype=v.dtype)[..., ::2]
    elif bad == "grad":
        q = q.detach().requires_grad_()
    elif bad == "shape":
        k = k[:, :39]
    elif bad == "align":
        qkv = torch.zeros(1, 40, 3 * 128 + 1, dtype=torch.bfloat16)
        q = qkv[..., 1:].view(1, 40, 3, 2, 64)[:, :, 0]
    with pytest.raises(ValueError, match=match):
        tattn.flash_attention_packed(q, k, v)


# On the card: the kernel against the plain version on the main path's
# shapes (trunk, Depth-Pro's B=1 encoders and its 35-crop patch encoder,
# small ragged), at the 64-row tile edges of the D = 32 design and the
# 128-row tile edges of the D = 64 one (one partial tile, one full tile, one
# row past a tile), and long.
CUDA_SHAPES = [(1, 4097, 12, 64), (1, 577, 16, 64), (35, 577, 16, 64),
               (2, 77, 12, 64), (1, 1, 2, 64), (1, 64, 2, 64), (3, 65, 4, 64),
               (2, 128, 12, 64), (2, 129, 12, 64), (1, 8192, 12, 64)]


def _check_kernel(q, k, v):
    before = tattn.flash_attention_packed.launches
    got = tattn.flash_attention_packed(q, k, v).float()
    torch.cuda.synchronize()
    assert tattn.flash_attention_packed.launches == before + 1
    want = tattn.attention_ref(q, k, v).float()
    err, ref = (got - want).abs(), want.abs()
    # bf16 output (2^-8 relative) and bf16 probabilities in PV on both sides,
    # rounded at different points: q/k/v ~ N(0, 1). The absolute limits
    # alone are loose where the outputs are small (~0.02 at N=4097), so the
    # error is also held to 5% of the largest output and 1% of the mean one.
    assert err.max().item() <= 2e-2
    assert err.mean().item() <= 2e-3
    assert err.max().item() <= 5e-2 * ref.max().item()
    assert err.mean().item() <= 1e-2 * ref.mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, shape):
    _check_kernel(*_packed_views(*shape, device=cuda_device))


@pytest.mark.cuda
def test_kernel_takes_any_strides_on_cuda(cuda_device):
    """Separate contiguous q/k/v, and head-major [B, H, N, D] views (the
    second at Depth-Pro's width, a ragged last tile: 577 = 4 * 128 + 65)."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 200, 3, 64, generator=g).to(torch.bfloat16)
               .to(cuda_device) for _ in range(3))
    _check_kernel(q, k, v)
    for b, h, n in ((2, 3, 200), (4, 16, 577)):
        q, k, v = (torch.randn(b, h, n, 64, generator=g).to(torch.bfloat16)
                   .to(cuda_device).transpose(1, 2) for _ in range(3))
        _check_kernel(q, k, v)


@pytest.mark.cuda
def test_kernel_is_exact_outside_the_tpu_clamp_window(cuda_device):
    """Row-max logits around 70 (beyond the TPU kernel's [-37, 50] window):
    the online softmax stays finite and matches the plain version."""
    q, k, v = _packed_views(1, 300, 2, 64, device=cuda_device, seed=5)
    q = (q.float() * 20.0).to(torch.bfloat16)
    _check_kernel(q, k, v)
