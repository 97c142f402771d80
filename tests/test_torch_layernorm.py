"""The port's fused LayerNorm (kernel 9) and the probe's variants (kernel 12):
the plain versions against the JAX package's `_ln_reference` and its Pallas
kernels in interpret mode, the gate and the autograd Function on the CPU, and
the CUDA kernel against the plain versions on the card (marker `cuda`).

JAX is imported inside the fixtures that need it, so the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_layernorm.py

Limits: bf16 outputs within 2e-2 (the JAX tests' own, about 2 bf16 ulps at
|y| ~ 4); f32 within 1e-6 absolute + 1e-6 relative (the sums run in another
order in each framework). On the card, bf16 outputs also have no element
more than one bf16 ulp from the plain version (the kernel and its plain
version differ in the order of the f32 sums and in rsqrtf alone), and v4's
instance differs from v2's plain version in at least 10x as many elements
as from its own and in 0.1% of them (its bf16 squares).
"""
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.ops import layernorm as tln
from ovmono3d_tpu_torch.probes import bf16_ulp_diff

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F32_TOL = dict(atol=1e-6, rtol=1e-6)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def jax_ln():
    pytest.importorskip("jax")
    from ovmono3d_tpu.ops import layernorm

    return layernorm


@pytest.fixture(scope="module")
def probe():
    """tools/probe_layernorm.py as a module (its main is guarded)."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "probe_layernorm", REPO / "tools" / "probe_layernorm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


def _inputs(lead=(2, 300), c=256, seed=0):
    """x ~ N(1.5, 3^2), scale ~ N(1, 0.2^2), bias ~ N(0, 0.1^2), as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*lead, c)) * 3 + 1.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


def _as(dtype, *arrays):
    import jax.numpy as jnp

    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    xj = jnp.asarray(arrays[0]).astype(jd)
    xt = torch.from_numpy(arrays[0]).to(td)
    rest_j = [jnp.asarray(a) for a in arrays[1:]]
    rest_t = [torch.from_numpy(a) for a in arrays[1:]]
    return (xj, *rest_j), (xt, *rest_t), jd, td


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype,out", [("bf16", "bf16"), ("bf16", "f32"),
                                       ("f32", "f32"), ("f32", "bf16")])
def test_ref_matches_jax_reference(jax_ln, dtype, out):
    import jax.numpy as jnp

    x, scale, bias = _inputs(seed=1)
    (xj, sj, bj), (xt, st, bt), _, _ = _as(dtype, x, scale, bias)
    jo = jnp.bfloat16 if out == "bf16" else jnp.float32
    to = torch.bfloat16 if out == "bf16" else torch.float32
    want = jax_ln._ln_reference(xj, sj, bj, 1e-6, jo)
    got = tln.layer_norm_ref(xt, st, bt, 1e-6, to)
    assert got.dtype == to and tuple(got.shape) == x.shape
    _close(got, want, BF16_TOL if out == "bf16" else F32_TOL)


@pytest.mark.parametrize("rows,c,block_rows", [(300, 256, 128), (77, 128, 64),
                                               (5, 768, 256)],
                         ids=["blocks", "ragged", "dinov2_width"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ref_matches_tpu_kernel_interpret(jax_ln, dtype, rows, c, block_rows):
    x, scale, bias = _inputs((rows,), c, seed=2)
    (xj, sj, bj), (xt, st, bt), jd, td = _as(dtype, x, scale, bias)
    want = jax_ln._ln_pallas(xj, sj, bj, 1e-5, jd, block_rows=block_rows,
                             interpret=True)
    got = tln.layer_norm_ref(xt, st, bt, 1e-5, td)
    _close(got, want, BF16_TOL if dtype == "bf16" else F32_TOL)


def test_layer_norm_fused_on_cpu_runs_the_plain_version():
    x, scale, bias = _inputs(seed=3)
    xt, st, bt = (torch.from_numpy(a) for a in (x, scale, bias))
    got = tln.layer_norm_fused(xt.bfloat16(), st, bt)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tln.layer_norm_ref(xt.bfloat16(), st, bt))
    assert tln.layernorm_fwd.launches == dict.fromkeys(tln.MODES, 0)


def _grads(fn, x, scale, bias):
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    (fn(*leaves, 1e-6, torch.float32) ** 2).sum().backward()
    return [t.grad for t in leaves]


def test_gradients_match_jax_grad(jax_ln):
    import jax
    import jax.numpy as jnp

    x, scale, bias = _inputs((40,), 128, seed=4)

    def loss(x, s, b):
        return jnp.sum(jax_ln.layer_norm_fused(x, s, b, 1e-6,
                                               jnp.float32) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in
                                               (x, scale, bias)))
    got = _grads(tln.layer_norm_fused,
                 *(torch.from_numpy(a) for a in (x, scale, bias)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_autograd_function_backward_is_the_plain_gradient(monkeypatch):
    """LayerNormFused with its forward launch replaced by the plain version
    (no card here): its backward gives the plain version's autograd."""
    monkeypatch.setattr(
        tln, "layernorm_fwd",
        lambda x, s, b, eps, out_dtype: tln.layer_norm_ref(x, s, b, eps,
                                                           out_dtype))
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((3, 17), 128, 5))

    def fused(x, s, b, eps, out_dtype):
        return tln.LayerNormFused.apply(x, s, b, eps, out_dtype)

    for g, w in zip(_grads(fused, x, scale, bias),
                    _grads(tln.layer_norm_ref, x, scale, bias)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _probe_call(probe, monkeypatch, variant, x, scale, bias):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    b, n, c = x.shape
    monkeypatch.setattr(probe, "B", b)
    monkeypatch.setattr(probe, "N", n)
    proxy = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(probe, "pl", proxy)
    fn = getattr(probe, variant)
    return fn(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale),
              jnp.asarray(bias), block_rows=64)


@pytest.mark.parametrize("variant", ["v2", "v3", "v4"])
def test_probe_variants_match_tpu_kernels_interpret(probe, monkeypatch,
                                                    variant):
    """The probe at [2, 45, 768] (B and N patched down, C as the probe's):
    each plain version against its Pallas kernel in interpret mode, and the
    CPU path of the port's entry point equal to the plain version."""
    rng = np.random.default_rng(6)
    c = probe.C
    x = (rng.standard_normal((2, 45, c)) * 1.7 + 0.8).astype(np.float32)
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    want = _probe_call(probe, monkeypatch, variant, x, scale, bias)
    xt = torch.from_numpy(x).bfloat16()
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    got = tln.ln_probe_ref(xt, st, bt, variant)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    assert bf16_ulp_diff(got, torch.from_numpy(np.asarray(want, np.float32))
                         )[1] == 0
    entry = getattr(tln, f"ln_probe_{variant}")
    assert torch.equal(entry(xt, st, bt), got)


def test_probe_v4_rounds_the_squares():
    """v4's plain version differs from v3's only through the bf16 squares;
    the difference is small but not zero."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((64,), 768, 7))
    xb = x.bfloat16()
    v3 = tln.ln_probe_ref(xb, scale, bias, "v3").float()
    v4 = tln.ln_probe_ref(xb, scale, bias, "v4").float()
    assert 0 < (v3 - v4).abs().max() < 5e-2
    with pytest.raises(ValueError, match="unknown probe variant"):
        tln.ln_probe_ref(xb, scale, bias, "v5")


@pytest.mark.parametrize("bad,match", [
    ("width", "take C in"),
    ("wide", "take C in"),
    ("unused_width", "take C in"),
    ("dtype", "bfloat16 or float32"),
    ("scale", r"scale must be \[C\]"),
    ("probe_f32", "bf16 in and out"),
    ("aligned_x", "x starts at a pointer that is not 16-byte aligned"),
    ("aligned_bias", "bias starts at a pointer that is not 16-byte aligned"),
    ("cpu", "CUDA device"),
])
def test_kernel_wrapper_refuses(bad, match):
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((4,), 256, 8))
    mode, out_dtype = "f32_stats", torch.bfloat16
    if bad == "width":
        x, scale, bias = x[:, :200], scale[:200], bias[:200]
    elif bad == "wide":
        x, scale, bias = x.repeat(1, 9), scale.repeat(9), bias.repeat(9)
    elif bad == "unused_width":
        x, scale, bias = x.repeat(1, 3)[:, :384], scale.repeat(2)[:384], \
            bias.repeat(2)[:384]
    elif bad == "dtype":
        x = x.half()
    elif bad == "scale":
        scale = scale.bfloat16()
    elif bad == "probe_f32":
        mode = "recip_mean"
    elif bad == "aligned_x":
        # A contiguous view one element into its storage (4 bytes).
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
    elif bad == "aligned_bias":
        # Scale and bias sliced out of one packed parameter.
        packed = torch.cat([scale, bias.new_zeros(1), bias])
        scale, bias = packed[:256], packed[257:]
    with pytest.raises(ValueError, match=match):
        tln.layernorm_fwd(x, scale, bias, 1e-6, out_dtype, mode)


# -- on the card ------------------------------------------------------------

def _cuda_inputs(shape, dtype, seed, device):
    x, scale, bias = _inputs(shape[:-1], shape[-1], seed)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(scale).to(device),
            torch.from_numpy(bias).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 77, 768), (3, 100, 128), (1, 50, 1280),
                                   (7, 512), (5, 1024), (9, 256)])
@pytest.mark.parametrize("dtype,out", [(torch.bfloat16, torch.bfloat16),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.float32),
                                       (torch.float32, torch.bfloat16)])
def test_kernel_matches_plain_on_cuda(cuda_device, shape, dtype, out):
    x, scale, bias = _cuda_inputs(shape, dtype, 9, cuda_device)
    before = tln.layernorm_fwd.launches["f32_stats"]
    got = tln.layer_norm_fused(x, scale, bias, 1e-6, out)
    torch.cuda.synchronize()
    assert tln.layernorm_fwd.launches["f32_stats"] == before + 1
    want = tln.layer_norm_ref(x, scale, bias, 1e-6, out)
    assert got.dtype == out
    torch.testing.assert_close(
        got.float(), want.float(),
        **(F32_TOL if out == torch.float32 else BF16_TOL))
    if out == torch.bfloat16:
        assert bf16_ulp_diff(got, want)[1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v2", "v3", "v4"])
def test_probe_kernels_match_plain_on_cuda(cuda_device, variant):
    x, scale, bias = _cuda_inputs((2, 333, 768), torch.bfloat16, 10,
                                  cuda_device)
    got = getattr(tln, f"ln_probe_{variant}")(x, scale, bias)
    torch.cuda.synchronize()
    want = tln.ln_probe_ref(x, scale, bias, variant)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert bf16_ulp_diff(got, want)[1] == 0


@pytest.mark.cuda
def test_probe_v4_kernel_is_apart_from_v2_on_cuda(cuda_device):
    """The control: v4's instance against v2's plain version differs in at
    least 10x as many elements as against its own, and in 0.1% of them."""
    x, scale, bias = _cuda_inputs((8, 333, 768), torch.bfloat16, 12,
                                  cuda_device)
    got = tln.ln_probe_v4(x, scale, bias)
    own = bf16_ulp_diff(got, tln.ln_probe_ref(x, scale, bias, "v4"))[0]
    v2 = bf16_ulp_diff(got, tln.ln_probe_ref(x, scale, bias, "v2"))[0]
    assert v2 >= max(10 * own, 1e-3 * got.numel()), (own, v2)


@pytest.mark.cuda
def test_kernel_gradients_on_cuda(cuda_device):
    x, scale, bias = _cuda_inputs((3, 40, 256), torch.float32, 11,
                                  cuda_device)
    for g, w in zip(_grads(tln.layer_norm_fused, x, scale, bias),
                    _grads(tln.layer_norm_ref, x, scale, bias)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
