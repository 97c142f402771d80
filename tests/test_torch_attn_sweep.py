"""The port's block-size sweep attention (kernel 11): the plain version
against the swept TPU kernel (tools/profile_attn_sweep.py `make_kernel` /
`flash`) in interpret mode in both softmax modes, the wrapper's CPU path and
refusals, and the CUDA instances against the plain version on the card
(marker `cuda`).

tools/profile_attn_sweep.py runs its TPU probe when imported, so the test
takes `_NEG_INF`, `make_kernel` and `flash` out of its source with `ast` and
runs them with a `pl` whose `pallas_call` interprets.

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_attn_sweep.py

Inputs: peaked rows, q, k ~ 2 N(0, 1) and v ~ N(0, 1) (the probe's own
U(0, 1) inputs give logits that spread by ~0.2, so every output row is near
the mean of v and a kernel that ignored q and k would pass). Limit
(`probes.attn_sweep.error`): at most 1e-2 of the elements more than one bf16
ulp apart and none more than 0.15 (the reasons stand beside ATOL and
ULP_SHARE there). Sound pairs leave 3e-5 to 1.7e-3 beyond one ulp; the
controls, the bf16 softmax against the f32 one and the mean of v, leave
0.45 to 1.0 and must fail it. Another block_k leaves 2e-3 to 1e-2: it is
shown to move outputs, not held to the limit.
"""
import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.ops import attn_sweep as tsweep
from ovmono3d_tpu_torch.probes import attn_sweep as sweep_probe

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_flash():
    """`flash` of tools/profile_attn_sweep.py, its Pallas calls
    interpreted."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    src = (REPO / "tools" / "profile_attn_sweep.py").read_text()
    tree = ast.parse(src)
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef)
                and node.name in ("make_kernel", "flash"))
            or (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "_NEG_INF"
                        for t in node.targets))]
    assert len(keep) == 3
    proxy = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, ds=pl.ds,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    ns = {"jax": jax, "jnp": jnp, "pl": proxy, "functools": functools}
    exec(compile(ast.Module(body=keep, type_ignores=[]),
                 "profile_attn_sweep.py", "exec"), ns)
    assert ns["_NEG_INF"] == tsweep.NEG_INF
    return ns["flash"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


def _qkv(shape, seed):
    """q, k ~ 2 N(0, 1), v ~ N(0, 1), numpy f32: peaked rows."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * s
            for s in (2.0, 2.0, 1.0)]


def _bf16(*arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def _within(got, want) -> dict:
    e = sweep_probe.error(got, want)
    assert e["ok"], e
    return e


@pytest.mark.parametrize("softmax_f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("block_k", [64, 128])
def test_ref_matches_tpu_kernel_interpret(jax_flash, block_k, softmax_f32):
    import jax.numpy as jnp

    q, k, v = _qkv((1, 300, 2, 64), seed=block_k + softmax_f32)
    want = jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                     block_q=64, block_k=block_k, sm_f32=softmax_f32)
    got = tsweep.attn_sweep_ref(*_bf16(q, k, v), block_k, softmax_f32)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    _within(got, torch.from_numpy(np.asarray(want, np.float32)))


def test_limit_refuses_the_controls(jax_flash):
    """The TPU kernel's bf16 softmax against the plain f32 one, and the
    mean of v (what uniform weights give) against the plain version, each
    fail the limit the sound pairs pass."""
    import jax.numpy as jnp

    q, k, v = _qkv((1, 300, 2, 64), seed=12)
    tpu_bf16 = jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16)
                           for a in (q, k, v)),
                         block_q=64, block_k=64, sm_f32=False)
    qt, kt, vt = _bf16(q, k, v)
    plain_f32 = tsweep.attn_sweep_ref(qt, kt, vt, 64, True)
    e = sweep_probe.error(torch.from_numpy(np.asarray(tpu_bf16, np.float32)),
                          plain_f32)
    assert not e["ok"] and e["share_beyond_ulp"] > 0.1, e
    mean_v = vt.float().mean(1, keepdim=True).expand_as(vt).bfloat16()
    e = sweep_probe.error(mean_v, plain_f32)
    assert not e["ok"] and e["max_abs_err"] > 1.0, e


def test_bf16_softmax_depends_on_the_key_block():
    """p is rounded to bf16 against the running max (for PV in both modes,
    and before its sum too with a bf16 softmax), so two key blocks give
    different outputs, beyond one ulp in more elements than a sound pair
    leaves: the plain version has to replay the kernel's blocks."""
    q, k, v = _bf16(*_qkv((1, 200, 2, 64), seed=3))
    for softmax_f32 in (False, True):
        a, b = (tsweep.attn_sweep_ref(q, k, v, bk, softmax_f32)
                for bk in (64, 128))
        assert not torch.equal(a, b)
        assert sweep_probe.error(a, b)["share_beyond_ulp"] > 2e-3


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = _bf16(*_qkv((1, 70, 2, 64), 4))
    got = tsweep.attn_sweep(q, k, v, 128, 64, False)
    assert torch.equal(got, tsweep.attn_sweep_ref(q, k, v, 64, False))
    assert sum(tsweep.attn_sweep.launches.values()) == 0


def test_instances_are_the_sweep():
    assert len(tsweep.INSTANCES) == 8
    assert {i[:2] for i in tsweep.INSTANCES} == {(64, 64), (64, 128),
                                                 (128, 64), (128, 128)}


def test_previous_source_builds_apart(tmp_path):
    """A probe's --previous copy of the sources builds into its own
    library: the path follows the source and header contents, not the
    directory (an identical copy reuses the shipped library)."""
    from ovmono3d_tpu_torch.utils import cuda_build

    src = "attn_sweep_fwd.cu"
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in [cuda_build.CSRC / src, *cuda_build.CSRC.glob("*.cuh")]:
        (copy / f.name).write_bytes(f.read_bytes())
    shipped = cuda_build.library_path(src)
    assert cuda_build.library_path(src, copy) == shipped
    (copy / src).write_text((copy / src).read_text() + "\n// earlier\n")
    other = cuda_build.library_path(src, copy)
    assert other != shipped and other.parent == shipped.parent
    with pytest.raises(RuntimeError, match="no kernel sources"):
        cuda_build.library_path(src, tmp_path / "missing")


@pytest.mark.parametrize("bad,match", [
    ("instance", "instances are"),
    ("dtype", "takes bfloat16"),
    ("head_dim", r"\[B, N, H, 64\]"),
    ("stride", "unit stride"),
    ("cpu", "CUDA device"),
])
def test_kernel_checks_refuse(bad, match):
    q, k, v = _bf16(*_qkv((1, 16, 2, 64), 5))
    instance = (64, 64, True)
    if bad == "instance":
        instance = (32, 64, True)
    elif bad == "dtype":
        q = q.float()
    elif bad == "head_dim":
        q = q[..., :32]
    elif bad == "stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match=match):
        tsweep._check(q, k, v, instance)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", tsweep.INSTANCES,
                         ids=[f"bq{a}_bk{b}_{'f32' if c else 'bf16'}"
                              for a, b, c in tsweep.INSTANCES])
def test_kernel_matches_plain_on_cuda(cuda_device, instance):
    bq, bk, f32 = instance
    q, k, v = sweep_probe.checked_inputs((2, 333, 4, 64), seed=13,
                                         device=cuda_device)
    got = tsweep.attn_sweep(q, k, v, bq, bk, f32)
    torch.cuda.synchronize()
    _within(got, tsweep.attn_sweep_ref(q, k, v, bk, f32))
    if not f32:
        # The control: the same output against the f32-softmax plain version.
        e = sweep_probe.error(got, tsweep.attn_sweep_ref(q, k, v, bk, True))
        assert not e["ok"], e


@pytest.mark.cuda
@pytest.mark.parametrize("softmax_f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("n", [1, 64, 129, 333, 4097])
def test_outputs_do_not_depend_on_block_q_on_cuda(cuda_device, n, block_k,
                                                  softmax_f32):
    """block_q only tiles the rows: the two instances at one block_k and
    softmax give bit-identical outputs, within the limit of the plain
    version."""
    q, k, v = sweep_probe.checked_inputs((2, n, 3, 64), seed=17 + n,
                                         device=cuda_device)
    got = {bq: tsweep.attn_sweep(q, k, v, bq, block_k, softmax_f32)
           for bq in (64, 128)}
    torch.cuda.synchronize()
    assert torch.equal(got[64], got[128])
    _within(got[64], tsweep.attn_sweep_ref(q, k, v, block_k, softmax_f32))


@pytest.mark.cuda
@pytest.mark.parametrize("instance", tsweep.INSTANCES,
                         ids=[f"bq{a}_bk{b}_{'f32' if c else 'bf16'}"
                              for a, b, c in tsweep.INSTANCES])
def test_kernel_takes_head_major_views_on_cuda(cuda_device, instance):
    """q, k, v as [B, N, H, D] views of [B, H, N, D] tensors (head stride
    N D): the tensor maps follow the strides."""
    bq, bk, f32 = instance
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in sweep_probe.checked_inputs((2, 200, 3, 64), seed=19,
                                                   device=cuda_device))
    got = tsweep.attn_sweep(q, k, v, bq, bk, f32)
    torch.cuda.synchronize()
    _within(got, tsweep.attn_sweep_ref(q, k, v, bk, f32))
