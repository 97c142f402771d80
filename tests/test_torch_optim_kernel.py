"""The multi-tensor SGD update and finiteness flag (`ops/optim_kernels.py`,
`csrc/multi_tensor_sgd.cu`).

On the CPU: the route and its refusals (the gate alone, with stand-ins for
CUDA leaves), the tables' layouts as the kernel reads them, and the group
schedules in one tensor. On the card (marker `cuda`): the kernel against the per-leaf update
of train/optim.py over several steps, bit for bit on parameters, trace and
count; the finiteness flag; the refusals; and one step of the 237-leaf SAM
ViT-B detector with no host synchronisation and one launch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_optim_kernel.py

The file imports no JAX, so the `cuda` tests run where JAX is not installed.
"""
import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.ops import optim_kernels as ok
from ovmono3d_tpu_torch.train import optim as toptim

REPO = Path(__file__).resolve().parents[1]
CHUNK_DT = np.dtype([("start", "<i8"), ("leaf", "<i4"), ("len", "<i4")])
LEAF_DT = np.dtype([("p", "<u8"), ("t", "<u8"), ("group", "<i4"),
                    ("wd", "<f4"), ("decay", "<i4"), ("pad", "<i4")])


def _leaf(device="cuda", dtype=torch.float32, contiguous=True):
    """A stand-in for a tensor, as the gate reads one."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 is_contiguous=lambda: contiguous)


CUDA_F32 = [_leaf(), _leaf(), _leaf()]


@pytest.mark.parametrize("kind,leaves,want", [
    ("sgd", CUDA_F32, True),
    ("sgd", [_leaf("cuda:0"), _leaf("cuda:0")], True),
    ("sgd", [torch.zeros(3), torch.zeros(2, 2)], False),
    ("sgd", [_leaf("cpu"), _leaf("cpu")], False),
    ("sgd", [_leaf("cpu"), _leaf("cpu", dtype=torch.bfloat16)], False),
    ("sgd", [_leaf(), _leaf(dtype=torch.bfloat16)], "refused"),
    ("sgd", [_leaf(), _leaf(dtype=torch.float16)], "refused"),
    ("sgd", [_leaf(), _leaf(contiguous=False)], "refused"),
    ("sgd", [_leaf("cuda:0"), _leaf("cuda:1")], "refused"),
    ("sgd", [], False),
    ("adam", CUDA_F32, False),
    ("adamw", CUDA_F32, False),
    ("adam+amsgrad", CUDA_F32, False),
    ("adamw+amsgrad", [_leaf(), _leaf(dtype=torch.bfloat16)], False),
])
def test_route(kind, leaves, want):
    """The kernel for sgd on the card, the per-leaf update for the adam
    kinds and on the CPU (any dtype there); an sgd optimizer on the card
    whose leaf the kernel cannot take is refused, not routed around it."""
    if want == "refused":
        with pytest.raises(ValueError, match="contiguous float32 leaves"):
            ok.use_multi_tensor(kind, leaves)
    else:
        assert ok.use_multi_tensor(kind, leaves) is want


def test_route_refusal_names_the_leaf():
    leaves = [_leaf(), _leaf(), _leaf(dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match=r"head\.w is a contiguous "
                                         r"torch\.bfloat16 tensor on cuda"):
        ok.use_multi_tensor("sgd", leaves, ["a", "b", "head.w"])
    with pytest.raises(ValueError, match="leaf 1 is a non-contiguous"):
        ok.use_multi_tensor("sgd", [_leaf(), _leaf(contiguous=False)])


class _Leaves(nn.Module):
    """Leaves of every group and of awkward sizes: default weights of 1,
    4097 and 5 elements, biases of 3 and 1, a norm (LayerNorm) pair, and an
    `unused` weight that gets no gradient."""

    def __init__(self, big: int = 0):
        super().__init__()
        self.a = nn.Linear(1, 1)                  # weight 1, bias 1
        self.b = nn.Module()
        self.b.weight = nn.Parameter(torch.empty(4097))
        self.b.bias = nn.Parameter(torch.empty(3))
        self.c = nn.Module()
        self.c.weight = nn.Parameter(torch.empty(5))
        self.norm = nn.LayerNorm(5)
        self.unused = nn.Module()
        self.unused.weight = nn.Parameter(torch.empty(7))
        if big:
            self.big = nn.Module()
            self.big.weight = nn.Parameter(torch.empty(big))


@pytest.mark.parametrize("kind", toptim.KINDS)
def test_optimizer_on_the_cpu_keeps_the_per_leaf_update(kind):
    opt = toptim.Optimizer(tcfg.SolverConfig(type=kind), _Leaves())
    assert opt.kernel is None
    assert {*opt.labels} == {*toptim.GROUPS}


@pytest.mark.parametrize("numels,chunk,max_leaves", [
    ([1, 3, 5, 4097, 4 * 2**20 + 3], ok.CHUNK, ok.MAX_LEAVES),
    ([0, 5, 40000, 3, 0, 16384, 16385], 16384, 2),
    ([7] * 11, 4, 4),
    ([0, 0, 0, 12], 8, 3),
])
def test_chunk_plan_covers_every_element_once(numels, chunk, max_leaves):
    table, runs = ok.plan_chunks(numels, chunk, max_leaves)
    rows = table.view(CHUNK_DT).ravel()
    seen = [np.zeros(n, dtype=np.int64) for n in numels]
    for r in rows:
        assert 0 < r["len"] <= chunk and r["start"] % chunk == 0
        seen[r["leaf"]][r["start"]:r["start"] + r["len"]] += 1
    assert all((s == 1).all() for s in seen)
    # The runs partition the table in order, each within its leaves.
    assert [c0 for _, _, c0, _ in runs] == [0] + [c1 for *_, c1 in runs][:-1]
    assert runs[-1][3] == len(rows)
    for leaf0, leaf1, c0, c1 in runs:
        assert 0 < leaf1 - leaf0 <= max_leaves and c1 > c0
        assert all(leaf0 <= r["leaf"] < leaf1 for r in rows[c0:c1])


def test_leaf_table_layout():
    table = ok.leaf_table([2**63 + 16, 256], [512, 2**40], [0, 2],
                          [1e-4, 0.0]).view(LEAF_DT).ravel()
    assert table.tolist() == [(2**63 + 16, 512, 0, np.float32(1e-4), 1, 0),
                              (256, 2**40, 2, 0.0, 0, 0)]


def test_group_schedules_in_one_tensor():
    """The optimizer's one [3] schedule gives each group, bit for bit, its
    own detectron2 schedule (base_lr * the group's factor), across the
    warmup's end and two decays, through `lr` and `groups`."""
    solver = tcfg.SolverConfig(base_lr=0.12, bias_lr_factor=2.0,
                               steps=(5, 9), gamma=0.1, warmup_iters=3,
                               warmup_factor=0.001)
    opt = toptim.Optimizer(solver, _Leaves())
    factors = {"default": 1.0, "bias": 2.0, "norm": 1.0}
    for count in range(12):
        opt.count.fill_(count)
        for label, f in factors.items():
            want = toptim.warmup_multistep(0.12 * f, (5, 9), 0.1, 3,
                                           0.001)(opt.count)
            assert opt.lr(label).view(torch.int32) == want.view(torch.int32)
            got = opt.groups[label][0](opt.count)
            assert got.view(torch.int32) == want.view(torch.int32)


# On the card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


SOLVER = tcfg.SolverConfig(
    base_lr=0.1, momentum=0.9, weight_decay=1e-2, weight_decay_norm=0.0,
    bias_lr_factor=2.0, warmup_iters=2, warmup_factor=0.1, steps=(3,),
    gamma=0.1)


def _pair(device, big, solver=SOLVER):
    """Two optimizers over equal copies of `_Leaves`: the kernel's and the
    per-leaf update's."""
    g = torch.Generator().manual_seed(0)
    mods = [_Leaves(big), _Leaves(big)]
    with torch.no_grad():
        for p, q in zip(mods[0].parameters(), mods[1].parameters()):
            p.copy_(torch.randn(p.shape, generator=g))
            q.copy_(p)
    opts = [toptim.Optimizer(solver, m.to(device)) for m in mods]
    assert opts[0].kernel is not None
    opts[1].kernel = None
    return opts


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().view(torch.int32)


def _grads(opt, step, device):
    """Step `step`'s gradients: even steps separate tensors, odd steps
    views at an odd offset into one flat buffer (as `_all_reduce_flat`
    gives them); `unused` gets None; step 1's hold a NaN and an inf."""
    g = torch.Generator(device=device).manual_seed(100 + step)
    sizes = [p.numel() for p in opt.params]
    flat = torch.randn(1 + sum(sizes), generator=g, device=device)
    if step == 1:
        flat[2] = float("nan")
        flat[-1] = float("inf")
    parts = flat[1:].split(sizes)
    grads = [part.view(p.shape) if step % 2 else part.view(p.shape).clone()
             for part, p in zip(parts, opt.params)]
    return [None if n == "unused.weight" else gr
            for n, gr in zip(opt.names, grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_kernel_matches_the_per_leaf_update_bit_for_bit(cuda_device, clip):
    """Six steps, step 1 skipped (NaN and inf gradients): the count crosses
    the warmup's end (2) and the decay at 3; every leaf's parameters and
    trace equal the per-leaf update's bits after each step, with and
    without global-norm clipping."""
    kern, plain = _pair(cuda_device, big=4 * 2**20 + 3,
                        solver=dataclasses.replace(SOLVER,
                                                   clip_gradients=clip))
    assert kern.labels.count("norm") and kern.labels.count("bias")
    before = ok.sgd_update.launches
    for step in range(6):
        skip = torch.tensor(step == 1, device=cuda_device)
        grads = _grads(kern, step, cuda_device)
        assert bool(kern.all_finite(grads)) == (step != 1)
        for opt in (kern, plain):
            opt.step(grads, skip)
        torch.cuda.synchronize()
        for name, a, b in zip(kern.names, kern.params, plain.params):
            assert torch.equal(_bits(a), _bits(b)), (step, name)
        for name, a, b in zip(kern.names, kern.state["trace"],
                              plain.state["trace"]):
            assert torch.equal(_bits(a), _bits(b)), (step, name)
        assert int(kern.count) == int(plain.count) == step + (step < 1)
    assert ok.sgd_update.launches - before == 6


@pytest.mark.cuda
def test_skip_keeps_every_bit(cuda_device):
    kern, _ = _pair(cuda_device, big=0)
    kern.step(_grads(kern, 0, cuda_device))
    before = [_bits(p).clone() for p in kern.params + kern.state["trace"]]
    kern.step(_grads(kern, 1, cuda_device),
              torch.tensor(True, device=cuda_device))
    after = [_bits(p) for p in kern.params + kern.state["trace"]]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(kern.count) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf"), None])
def test_finiteness_flag(cuda_device, offset, value):
    """One inf or NaN anywhere (the first element, a 16-byte block's
    middle, a leaf's tail) clears the flag, on aligned and unaligned views;
    huge finite values and None gradients do not."""
    kern, _ = _pair(cuda_device, big=40003)
    sizes = [p.numel() for p in kern.params]
    for where in (0, 4097 + 5, sum(sizes) - 1):
        flat = torch.full((offset + sum(sizes),), 3e38, device=cuda_device)
        if value is not None:
            flat[offset + where] = value
        grads = [part.view(p.shape) for part, p in
                 zip(flat[offset:].split(sizes), kern.params)]
        grads[kern.names.index("unused.weight")] = None
        want = value is None or kern.names[
            np.searchsorted(np.cumsum(sizes), where, "right")] == "unused.weight"
        assert bool(kern.all_finite(grads)) is want


@pytest.mark.cuda
def test_refusals(cuda_device):
    kern, _ = _pair(cuda_device, big=0)
    grads = _grads(kern, 0, cuda_device)
    with pytest.raises(ValueError, match="gradients for"):
        kern.step(grads[:-1])
    bad = list(grads)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="float32"):
        kern.step(bad)
    bad[0] = torch.zeros(2, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kern.step(bad)
    # A non-contiguous gradient is copied, not refused.
    w = kern.names.index("b.weight")
    grads[w] = torch.zeros(4097 * 2, device=cuda_device)[::2]
    kern.step(grads)
    with torch.no_grad():
        kern.params[0].data = kern.params[0].data.clone()
    with pytest.raises(RuntimeError, match="moved"):
        kern.step(grads)


@pytest.mark.cuda
def test_sam_step_makes_no_host_sync(cuda_device):
    """One update of the SAM ViT-B detector trained unfrozen: 237 leaves,
    121.17 M parameters, one launch, and no host synchronisation inside
    `Optimizer.step` or the finiteness flag."""
    from ovmono3d_tpu_torch.models.rcnn3d import build_model, freeze_trunk

    cfg = tcfg.load_config(REPO / "configs" / "OVMono3D_sam_SFP.yaml",
                           ["model.backbone.freeze=false"])
    model = build_model(cfg.model, device="meta").to_empty(device=cuda_device)
    freeze_trunk(model, False)
    opt = toptim.Optimizer(cfg.solver, model)
    assert len(opt.params) == 237 and opt.kernel is not None
    assert sum(p.numel() for p in opt.params) == 121_165_911
    with torch.no_grad():
        for p in opt.params:
            p.normal_()
    grads = [torch.randn_like(p) for p in opt.params]
    skip = torch.zeros((), dtype=torch.bool, device=cuda_device)
    torch.cuda.synchronize()
    before = ok.sgd_update.launches + ok.all_finite.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        finite = opt.all_finite(grads)
        opt.step(grads, skip | ~finite)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ok.sgd_update.launches + ok.all_finite.launches - before <= 8
    assert ok.sgd_update.launches + ok.all_finite.launches - before == 2
    assert int(opt.count) == 1
