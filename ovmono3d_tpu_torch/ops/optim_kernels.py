"""The multi-tensor SGD update and gradient finiteness flag on the card
(`csrc/multi_tensor_sgd.cu`).

The eager update (train/optim.py `Optimizer._updates`) runs optax's SGD
arithmetic leaf by leaf, ~12 launches a leaf; here one launch takes every
leaf. No TPU kernel is replaced: the JAX package leaves its optax chain to
XLA's fusion.

- `use_multi_tensor(kind, leaves, names)`: the route, by what the optimizer
  can observe. Kind "sgd" over leaves on a CUDA device takes the kernel;
  the adam kinds and leaves on the CPU keep the per-leaf path. An sgd
  optimizer on the card with a leaf the kernel cannot take (not float32,
  not contiguous, on another device) is refused, not sent back to the
  per-leaf path and its ~12 launches a leaf. No option selects it.
- `MultiTensorSGD(params, traces, groups, wds)`: the static work list of one
  optimizer's leaves, on the device: chunks of `CHUNK` elements and each
  leaf's p and trace pointers, group and weight decay, built once (one copy
  from the host, at construction). `sgd_update` and `all_finite` take the
  gradients (one per leaf, None for an unused one) by their pointers, as
  kernel arguments: a step copies nothing from the host and never waits
  for the device.
- `sgd_update(table, grads, lr, skip, momentum)`: in place, for every leaf,
  u = g + wd * p (g where the group has no decay), trace = u + momentum *
  trace, p = p + trace * (-lr[group]), bit for bit the eager path's; nothing
  is written when the device bool `skip` is true.
- `all_finite(table, grads)`: a device bool, true when no gradient holds an
  inf or a NaN.

Each launch adds one to `sgd_update.launches` or `all_finite.launches`; a
launch carries at most `MAX_LEAVES` gradient pointers, so a model with more
leaves takes one launch per `MAX_LEAVES`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

KERNEL_SOURCES = ["multi_tensor_sgd.cu"]
MAX_LEAVES = 480        # csrc/multi_tensor_sgd.cu kMaxLeaves
CHUNK = 16384           # elements of a work item (a multiple of 4)


def use_multi_tensor(kind: str, leaves, names=None) -> bool:
    """Whether an optimizer of `kind` over `leaves` takes the kernel: "sgd"
    with its first leaf on a CUDA device. Then every leaf has to be a
    contiguous float32 tensor on that device, else ValueError names the
    first that is not (`names`: the leaves' names, for the message)."""
    if kind != "sgd" or not leaves or leaves[0].device.type != "cuda":
        return False
    device = leaves[0].device
    for i, t in enumerate(leaves):
        if (t.device != device or t.dtype != torch.float32
                or not t.is_contiguous()):
            name = names[i] if names else f"leaf {i}"
            layout = "contiguous" if t.is_contiguous() else "non-contiguous"
            raise ValueError(
                f"sgd on {device}: {name} is a {layout} {t.dtype} tensor on "
                f"{t.device}; the multi-tensor update takes contiguous "
                f"float32 leaves on one CUDA device")
    return True


def plan_chunks(numels: list[int], chunk: int = CHUNK,
                max_leaves: int = MAX_LEAVES):
    """The chunk table of leaves of `numels` elements: an int64 array [n, 2]
    holding, per chunk, its start and (leaf | length << 32), the layout of
    the kernel's `Chunk`; and the launches, (leaf0, leaf1, c0, c1) for each
    run of at most `max_leaves` leaves that has a chunk."""
    rows, launches, c0 = [], [], 0
    for leaf0 in range(0, len(numels), max_leaves):
        leaf1 = min(leaf0 + max_leaves, len(numels))
        for leaf in range(leaf0, leaf1):
            for start in range(0, numels[leaf], chunk):
                rows.append((start,
                             leaf | min(chunk, numels[leaf] - start) << 32))
        if len(rows) > c0:
            launches.append((leaf0, leaf1, c0, len(rows)))
        c0 = len(rows)
    return np.array(rows, dtype=np.int64).reshape(-1, 2), launches


def leaf_table(p_ptrs: list[int], t_ptrs: list[int], groups: list[int],
               wds: list[float]) -> np.ndarray:
    """The kernel's `Leaf` table as an int64 array [n, 4]: p, trace, then
    group | f32(wd) bits << 32, then decay (1 where wd is not 0) and pad."""
    table = np.zeros((len(p_ptrs), 4), dtype=np.int64)
    table[:, 0] = np.array(p_ptrs, dtype=np.uint64).view(np.int64)
    table[:, 1] = np.array(t_ptrs, dtype=np.uint64).view(np.int64)
    wd = np.array(wds, dtype=np.float32).view(np.uint32).astype(np.int64)
    table[:, 2] = np.array(groups, dtype=np.int64) | (wd << 32)
    table[:, 3] = [1 if w else 0 for w in wds]
    return table


@functools.cache
def _kernels() -> dict:
    from ovmono3d_tpu_torch.utils import cuda_build

    lib = cuda_build.load(KERNEL_SOURCES)["multi_tensor_sgd.cu"]
    if lib.multi_tensor_max_leaves() != MAX_LEAVES:
        raise RuntimeError("csrc/multi_tensor_sgd.cu kMaxLeaves is not "
                           f"MAX_LEAVES = {MAX_LEAVES}")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    sgd = lib.multi_tensor_sgd
    sgd.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                    + [ptrs, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_void_p])
    finite = lib.multi_tensor_all_finite
    finite.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ptrs, ctypes.c_void_p, ctypes.c_void_p])
    for fn in (sgd, finite):
        fn.restype = ctypes.c_int
    return {"sgd": sgd, "finite": finite}


def build_kernels() -> None:
    """Compile (or load) the library now rather than at the first
    optimizer built on the card."""
    _kernels()


class MultiTensorSGD:
    """The device tables of one optimizer's leaves: `params` and their
    `traces` (float32, contiguous, on one CUDA device; updated in place, so
    neither may move afterwards), `groups` (each leaf's index into the
    learning rates) and `wds` (each leaf's weight decay; 0 adds none)."""

    def __init__(self, params: list[torch.Tensor], traces: list[torch.Tensor],
                 groups: list[int], wds: list[float]):
        leaves = [*params, *traces]
        if not use_multi_tensor("sgd", leaves):
            raise ValueError("the multi-tensor update takes contiguous "
                             "float32 leaves on one CUDA device")
        self.device = params[0].device
        self.n_groups = max(groups) + 1
        self.numels = [p.numel() for p in params]
        self.params, self.traces = params, traces
        self.pointers = self._pointers()
        chunks, self.runs = plan_chunks(self.numels)
        self.chunks = torch.from_numpy(chunks).to(self.device)
        self.leaves = torch.from_numpy(
            leaf_table(*self.pointers, groups, wds)).to(self.device)
        self._fns = _kernels()

    def _pointers(self) -> tuple[list[int], list[int]]:
        return ([p.data_ptr() for p in self.params],
                [t.data_ptr() for t in self.traces])

    def _grad_pointers(self, grads) -> tuple[list[int | None], list]:
        """The gradients' device pointers (None for None), and the
        contiguous copies made of any non-contiguous gradient, which the
        caller holds until the launch is queued."""
        if len(grads) != len(self.numels):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.numels)} leaves")
        ptrs, keep = [], []
        for g, p in zip(grads, self.params):
            if g is None:
                ptrs.append(None)
                continue
            if (g.dtype != torch.float32 or g.shape != p.shape
                    or g.device != self.device):
                raise ValueError(
                    f"a gradient is {g.dtype} {tuple(g.shape)} on "
                    f"{g.device}; its leaf is float32 {tuple(p.shape)} on "
                    f"{self.device}")
            if not g.is_contiguous():
                g = g.contiguous()
                keep.append(g)
            ptrs.append(g.data_ptr())
        return ptrs, keep

    def _launch(self, name: str, grads, *args) -> int:
        """One launch of kernel `name` per run of leaves; returns how many."""
        if self._pointers() != self.pointers:
            raise RuntimeError("a parameter or trace buffer moved after the "
                               "optimizer was built (build it after moving "
                               "or sharding the model)")
        ptrs, _keep = self._grad_pointers(grads)   # alive until queued
        stream = torch.cuda.current_stream(self.device).cuda_stream
        fn = self._fns[name]
        head = ((self.chunks.data_ptr(), self.leaves.data_ptr())
                if name == "sgd" else (self.chunks.data_ptr(),))
        for leaf0, leaf1, c0, c1 in self.runs:
            arr = (ctypes.c_void_p * (leaf1 - leaf0))(*ptrs[leaf0:leaf1])
            rc = fn(*head, c0, c1, leaf0, leaf1 - leaf0, arr, *args, stream)
            if rc != 0:
                raise RuntimeError(f"multi_tensor {name} launch failed with "
                                   f"CUDA error {rc} (chunks {c0}-{c1})")
        return len(self.runs)


def sgd_update(table: MultiTensorSGD, grads, lr: torch.Tensor,
               skip: torch.Tensor, momentum: float) -> None:
    """The SGD-with-trace step on every leaf of `table`, in place: `lr` the
    learning rates by group (float32, on the device), `skip` a bool tensor
    (on a true one nothing is written)."""
    if (lr.dtype != torch.float32 or lr.device != table.device
            or lr.numel() < table.n_groups):
        raise ValueError(f"lr must be {table.n_groups} float32 on "
                         f"{table.device}; got {lr.numel()} {lr.dtype} on "
                         f"{lr.device}")
    if skip.numel() != 1 or skip.dtype != torch.bool:
        raise ValueError(f"skip must be one bool; got {skip.dtype} "
                         f"{tuple(skip.shape)}")
    lr, skip = lr.contiguous(), skip.to(table.device).contiguous()
    sgd_update.launches += table._launch(
        "sgd", grads, lr.data_ptr(), skip.data_ptr(), float(momentum))


sgd_update.launches = 0


def all_finite(table: MultiTensorSGD, grads) -> torch.Tensor:
    """A device bool: no element of any gradient (None: an unused leaf) is
    an inf or a NaN."""
    finite = torch.ones((), dtype=torch.bool, device=table.device)
    all_finite.launches += table._launch("finite", grads, finite.data_ptr())
    return finite


all_finite.launches = 0
