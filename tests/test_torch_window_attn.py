"""The port's Swin window attention: the plain version against the JAX
package's XLA path and its TPU kernel in interpret mode, the dispatcher and
the kernel wrapper's checks on the CPU, and the CUDA kernel (kernel 8)
against the plain version on the card (marker `cuda`).

JAX is imported inside the fixture that needs it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_window_attn.py
"""
import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_window():
    pytest.importorskip("jax")
    from ovmono3d_tpu.ops.attention import (window_attention_pallas,
                                            window_attention_xla)

    return window_attention_xla, window_attention_pallas


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


def _inputs(bw, n, h, d, nw, bias_std=1.0, seed=0):
    """q, k, v [BW, N, H, D], bias [H, N, N] and region ids [nw, N] in three
    regions, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bw, n, h, d)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((h, n, n)) * bias_std).astype(np.float32)
    ids = rng.integers(0, 3, (nw, n)).astype(np.int32)
    return q, k, v, bias, ids


@pytest.mark.parametrize("with_ids", [True, False], ids=["ids", "no_ids"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_window_ref_matches_jax_xla(jax_window, dtype, with_ids):
    import jax.numpy as jnp

    xla, _ = jax_window
    q, k, v, bias, ids = _inputs(6, 16, 2, 32, nw=3, seed=1)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jids = jnp.asarray(ids) if with_ids else None
    want = xla(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
               jnp.asarray(bias), jids, clamp_c=None)
    got = tattn.window_attention_ref(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(ids) if with_ids else None)
    assert got.dtype == td and got.shape == q.shape
    # f32: the same math summed in another order. bf16: both round the
    # probabilities and the output to bf16 (2^-8 relative), once each.
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("with_ids", [True, False], ids=["ids", "no_ids"])
def test_window_ref_matches_tpu_kernel_interpret(jax_window, with_ids):
    """The TPU kernel's own semantics (Pallas interpret mode), f32 inputs:
    it takes one row of ids per window (all equal for no mask)."""
    import jax.numpy as jnp

    _, pallas = jax_window
    bw, nw = 6, 3
    q, k, v, bias, ids = _inputs(bw, 16, 2, 32, nw=nw, bias_std=0.5, seed=2)
    full = np.tile(ids, (bw // nw, 1)) if with_ids else np.zeros((bw, 16),
                                                                 np.int32)
    want = pallas(*(jnp.asarray(x) for x in (q, k, v, bias, full)),
                  interpret=True)
    got = tattn.window_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v, bias)),
        torch.from_numpy(ids) if with_ids else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatcher_cpu_runs_plain_path(dtype):
    tattn.window_flash_attention.launches = 0
    q, k, v, bias, ids = _inputs(4, 9, 2, 32, nw=2, seed=3)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).to(dtype)
    tbias, tids = torch.from_numpy(bias), torch.from_numpy(ids)
    out = tattn.window_attention(qkv, tbias, tids)
    want = tattn.window_attention_ref(*qkv.unbind(2), tbias, tids)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert tattn.window_flash_attention.launches == 0


def _packed(bw, n, h, d=32, dtype=torch.bfloat16, device="cpu", seed=0,
            bias_std=1.0, nw=None):
    """q/k/v as Swin makes them (views of one [BW, N, 3*H*D] tensor), an
    f32 bias and, with nw, region ids of a shifted block."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(bw, n, 3 * h * d, generator=g).to(dtype).to(device)
    q, k, v = qkv.view(bw, n, 3, h, d).unbind(2)
    bias = (torch.randn(h, n, n, generator=g) * bias_std).to(device)
    ids = None
    if nw is not None:
        ids = torch.randint(0, 4, (nw, n), generator=g,
                            dtype=torch.int32).to(device)
    return q, k, v, bias, ids


def test_wrapper_takes_the_swin_strided_views():
    q, k, v, bias, ids = _packed(25, 144, 16, nw=25)
    assert q.stride() == (144 * 3 * 512, 3 * 512, 32, 1)
    # Every layout check passes; only the device is refused on the CPU.
    with pytest.raises(ValueError, match="CUDA"):
        tattn.window_flash_attention(q, k, v, bias, ids)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "bfloat16"), ("head_dim", "head dim"), ("stride", "unit stride"),
    ("grad", "inference-only"), ("shape", "shape"), ("align", "aligned"),
    ("tokens", "tokens a window"), ("bias_dtype", "bias"),
    ("bias_shape", "bias"), ("ids_dtype", "ids"), ("ids_rows", "ids"),
])
def test_wrapper_rejects(bad, match):
    q, k, v, bias, ids = _packed(4, 16, 2, nw=2)
    if bad == "dtype":
        q = q.float()
    elif bad == "head_dim":
        q, k, v, bias, ids = _packed(4, 16, 2, d=64, nw=2)
    elif bad == "stride":
        v = torch.zeros(4, 16, 2, 64, dtype=v.dtype)[..., ::2]
    elif bad == "grad":
        bias = bias.requires_grad_()
    elif bad == "shape":
        k = k[:, :15]
    elif bad == "align":
        qkv = torch.zeros(4, 16, 3 * 64 + 1, dtype=torch.bfloat16)
        q = qkv[..., 1:].view(4, 16, 3, 2, 32)[:, :, 0]
    elif bad == "tokens":
        q, k, v, bias, ids = _packed(1, 1025, 1, bias_std=0.0)
    elif bad == "bias_dtype":
        bias = bias.to(torch.bfloat16)
    elif bad == "bias_shape":
        bias = bias[:1].contiguous()
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_rows":
        ids = torch.zeros(3, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        tattn.window_flash_attention(q, k, v, bias, ids)


@pytest.mark.parametrize("n,instance", [
    (1, "window_fwd_sm90_kernel"), (49, "window_fwd_sm90_kernel"),
    (121, "window_fwd_sm90_kernel"), (144, "window_fwd_sm90_kernel"),
    (145, "window_fwd_kernel"), (196, "window_fwd_kernel"),
    (1024, "window_fwd_kernel")])
def test_kernel_instance_by_tokens(n, instance):
    """The C entry runs the wgmma + TMA design for every window Swin makes
    (144 tokens, or w^2 for a map smaller than the window) and the earlier
    mma.sync one past 144, up to the 1024 it always took."""
    assert tattn.window_kernel_instance(n) == instance


@pytest.mark.parametrize("n", [0, 1025])
def test_kernel_instance_refuses_what_the_entry_refuses(n):
    with pytest.raises(ValueError, match="tokens a window"):
        tattn.window_kernel_instance(n)


@pytest.mark.parametrize("n", [1, 16, 49, 121, 196])
def test_wrapper_takes_small_and_large_windows(n):
    """Windows of w^2 < 144 tokens (a map smaller than Swin's window) and
    past 144 pass every layout check on the Swin strided views; only the
    device is refused on the CPU."""
    q, k, v, bias, ids = _packed(4, n, 2, nw=2)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.window_flash_attention(q, k, v, bias, ids)


@pytest.mark.parametrize("shifted", [True, False],
                         ids=["shifted", "unshifted"])
def test_probe_yardstick_computes_the_same_function(shifted):
    """probes/window.py's SDPA yardstick (bias and mask built in the call)
    and its region ids, in f32 on the CPU, against the plain version."""
    from ovmono3d_tpu_torch.probes import window as wprobe

    q, k, v, bias, ids = wprobe.inputs(4, 16, 2, 0, shifted, device="cpu")
    assert (ids is not None) == shifted
    if shifted:
        assert ids.shape == (4, 16) and ids.dtype == torch.int32
    q, k, v = (x.float() for x in (q, k, v))
    got = wprobe.sdpa_window(q, k, v, bias, ids)
    want = tattn.window_attention_ref(q, k, v, bias, ids)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad,match", [
    ("none", "CUDA"), ("dtype", "bfloat16"), ("head_dim", "head dim")])
def test_probe_previous_runs_the_wrappers_own_code(monkeypatch, bad, match):
    """probes/window.py's earlier design runs window_flash_attention's own
    code (its checks and launch) on the other library's C entry, with the
    shipped entry's argument types, and counts no shipped launch."""
    import types

    from ovmono3d_tpu_torch.probes import window as wprobe

    shipped = types.SimpleNamespace(argtypes=["shipped"], restype="int")
    earlier = types.SimpleNamespace(argtypes=None, restype=None)
    monkeypatch.setattr(tattn, "_kernels", lambda: {"window": shipped})
    monkeypatch.setattr(wprobe, "previous_library", lambda source, csrc:
                        types.SimpleNamespace(window_attn_fwd_bf16=earlier))
    prev = wprobe.previous_window("DIR")
    assert prev.__code__ is tattn.window_flash_attention.__code__
    assert prev.__globals__["_kernels"]()["window"] is earlier
    assert (earlier.argtypes, earlier.restype) == (["shipped"], "int")
    q, k, v, bias, ids = _packed(4, 144, 2, nw=2)
    if bad == "dtype":
        q = q.float()
    elif bad == "head_dim":
        q, k, v = (x[..., :16] for x in (q, k, v))
    launches = tattn.window_flash_attention.launches
    for fn in (prev, tattn.window_flash_attention):
        with pytest.raises(ValueError, match=match):
            fn(q, k, v, bias, ids)
    assert tattn.window_flash_attention.launches == launches


def test_probe_bounds():
    """Kernel 8's bound at Swin-B's stages: bytes (q, k, v, out in bf16, the
    bias in f32, the ids in int32), 0.0161 ms at stage 0 shifted."""
    from ovmono3d_tpu_torch.probes import window as wprobe

    ms, by = wprobe.bound_ms(361, 144, 4, nw=361)
    assert by == "bytes"
    assert ms == pytest.approx((4 * 361 * 144 * 4 * 32 * 2 + 4 * 144 * 144
                                * 4 + 361 * 144 * 4) / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0161, abs=1e-4)
    assert set(wprobe.SHAPES) == {f"stage{i}{s}" for i in range(4)
                                  for s in ("", "_shifted")}


def test_dispatcher_cpu_runs_with_autograd():
    """On the CPU the plain path runs with autograd; a gradient through the
    CUDA path raises (forward-only, as the JAX package's)."""
    q, k, v, bias, ids = _packed(2, 16, 2, dtype=torch.float32, nw=2)
    qkv = torch.stack([q, k, v], 2).requires_grad_()
    tattn.window_attention(qkv, bias, ids).sum().backward()
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()


# On the card: kernel 8 against the plain version at the four Swin-B stage
# shapes at 896^2 (with and without ids), a small map (N = 64), a single
# token and windows just past 64 and 144 tokens.
CUDA_SHAPES = [(361, 144, 4), (100, 144, 8), (25, 144, 16), (9, 144, 32),
               (2, 64, 4), (3, 9, 2), (1, 1, 1), (2, 65, 3), (2, 145, 3)]


def check_kernel(q, k, v, bias, ids, absolute=True):
    before = tattn.window_flash_attention.launches
    got = tattn.window_flash_attention(q, k, v, bias, ids).float()
    torch.cuda.synchronize()
    assert tattn.window_flash_attention.launches == before + 1
    want = tattn.window_attention_ref(q, k, v, bias, ids).float()
    err, ref = (got - want).abs(), want.abs()
    # As kernels 1 and 7's tests: bf16 output and bf16 probabilities in PV
    # on both sides, rounded at different points; absolute limits, and
    # relative ones where the outputs are small.
    if absolute:
        assert err.max().item() <= 2e-2
        assert err.mean().item() <= 2e-3
    assert err.max().item() <= 5e-2 * ref.max().item()
    assert err.mean().item() <= 1e-2 * ref.mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("with_ids", [True, False], ids=["ids", "no_ids"])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, shape, with_ids):
    bw, n, h = shape
    check_kernel(*_packed(bw, n, h, device=cuda_device,
                          nw=bw if with_ids else None))


@pytest.mark.cuda
def test_kernel_is_exact_for_large_bias_on_cuda(cuda_device):
    """A bias of std ~30: the softmax is one-hot, stays finite and matches
    the plain version. Outputs are single entries of v,
    up to ~5, where one bf16 ulp (2^-5) is above the absolute limit: the
    relative limits hold it."""
    q, k, v, bias, ids = _packed(4, 64, 4, device=cuda_device, seed=5,
                                 bias_std=30.0, nw=4)
    check_kernel(q, k, v, bias, ids, absolute=False)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ids", [True, False], ids=["ids", "no_ids"])
@pytest.mark.parametrize("n", [144, 121, 64, 49, 16, 1])
def test_kernel_small_maps_large_bias_on_cuda(cuda_device, n, with_ids):
    """The wgmma design at every window size Swin gives (144, or w^2 for a
    map smaller than the window) with a bias of std 30 (one-hot rows):
    keys past N padded to 144 and masked, rows past N not stored."""
    q, k, v, bias, ids = _packed(6, n, 4, device=cuda_device, seed=n,
                                 bias_std=30.0, nw=3 if with_ids else None)
    check_kernel(q, k, v, bias, ids, absolute=False)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ids", [True, False], ids=["ids", "no_ids"])
def test_kernel_past_144_tokens_on_cuda(cuda_device, with_ids):
    """N = 196 (14 x 14 windows) runs the earlier mma.sync design."""
    assert tattn.window_kernel_instance(196) == "window_fwd_kernel"
    check_kernel(*_packed(8, 196, 4, device=cuda_device, seed=196,
                          nw=4 if with_ids else None))


@pytest.mark.cuda
def test_dispatcher_on_cuda(cuda_device):
    q, k, v, bias, ids = _packed(8, 144, 4, device=cuda_device, seed=6, nw=4)
    qkv = torch.stack([q, k, v], dim=2)
    before = tattn.window_flash_attention.launches
    with torch.no_grad():
        out = tattn.window_attention(qkv, bias, ids)
    assert tattn.window_flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="inference-only"):
        tattn.window_attention(qkv, bias.requires_grad_(), ids)
    # f32 stays the plain exact branch on the card.
    with torch.no_grad():
        out32 = tattn.window_attention(qkv.float(), bias, ids)
    assert out32.dtype == torch.float32
    assert tattn.window_flash_attention.launches == before + 1
