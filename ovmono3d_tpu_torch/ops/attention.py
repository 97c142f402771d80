"""Multi-head attention: the plain PyTorch versions and the Hopper kernels.

Counterpart of ovmono3d_tpu/ops/attention.py for the ViT trunks:

- `attention_ref`: the plain forward, the same math as `attention_xla`
  (f32 logits, f32 softmax, probabilities cast to v's dtype before PV).
  CPU tensors run it when no gradient is needed.
- `attention_lse_ref` / `attention_bwd_ref`: the plain forward with its row
  log-sum-exp and the explicit backward formula, in f32: the plain versions
  of kernels 3 and 4. `attention_bwd_delta_ref` /
  `attention_bwd_stats_ref`: delta = rowsum(do * o) and the padded
  (delta, lse * log2 e) scratch that kernel 4 writes first, the plain
  version of their stats pass (`_bwd_stats` launches it alone, for the
  tests). No model path calls them.
- Kernel wrappers, each launching a hand-written CUDA kernel (sm_90a) or
  raising, and counting its launches in `<wrapper>.launches` (the f32
  instance's in `<wrapper>.launches_f32`), at head dims 32 and 64. They
  take q/k/v as [B, N, H, D] views with any batch/token/head strides, so
  one set of wrappers serves both layouts of the JAX package, whose packed
  ([B, N, H*D]) and head-major ([B*H, N, D]) families exist because the
  TPU's tiling fixes the layout a kernel reads: its head-major kernels 2, 5
  and 6 are these wrappers on head-major strides, with no transposed copy.
  - `flash_attention_packed` (kernel 1, `csrc/flash_attn_fwd.cu`, replacing
    `_flash_kernel_packed`, and `_flash_kernel_single` / `_flash_kernel`):
    the inference forward, bf16 or f32 (the f32 instance computes exact f32
    products on the FP32 pipes, not TF32);
  - `flash_attention_packed_lse` (kernel 3, the same source's lse instance,
    replacing `_flash_kernel_packed_lse` and `_flash_kernel_single_lse`):
    the training forward, which also writes the row log-sum-exp; bf16;
  - `flash_attention_packed_bwd` (kernel 4, `csrc/flash_attn_bwd.cu`,
    replacing `_flash_bwd_packed_kernel`, `_flash_bwd_fused_kernel` and
    the split `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel`): dq, dk
    and dv into one packed gradient; bf16. Each launch computes delta in
    the same source (a stats pass before the dk/dv and dq kernels); bf16
    D = 64 runs the wgmma + TMA design.
  They refuse CPU tensors.
- `train_attention` (`torch.ops.ovmono3d.train_attention`): the training
  forward over the packed qkv tensor as one operator with its autograd
  formula, the JAX package's `_attn_fwd` / `_attn_bwd`: kernels 3 + 4 on
  CUDA, `attention_ref` with its lse + `attention_bwd_ref` on the CPU.
  Being one operator, a selective checkpoint policy can keep its out and
  lse (the JAX package's `checkpoint_name` tags, models/vit.py's
  "dots_attn").
- `dot_product_attention`: the dispatcher, routing on the device and on
  whether a gradient is needed, and on nothing else. With a gradient:
  `train_attention`. Without one: CPU tensors go to `attention_ref`, CUDA
  tensors to kernel 1. Every N and head count the kernels take runs them;
  the JAX package's gate and environment switches, which choose between
  its two TPU families, have no counterpart here. Past N = 6144 the JAX
  package differentiates `attention_xla`, and kernels 3 + 4 give the same
  gradient without its [B, H, N, N] tensors; the JAX kernels' clamped
  softmax (OVMONO3D_ATTN_CLAMP) has no counterpart either, since these
  kernels are exact for every logit. f32 with a gradient, and head dims
  other than 32 and 64, raise. Nothing falls back.

Decomposed relative-position attention (the SAM image encoder's blocks):

- `rel_pos_attention_ref`: the plain version, the same math as the JAX
  package's `_rel_pos_attention_fast(..., clamp=None)`;
  `rel_pos_attention_lse_ref` / `rel_pos_attention_bwd_ref`: the forward
  with its row lse and the explicit backward (dq, dk, dv and the bias
  factors' dqrh, dqrw), in f32 from the factors: the plain versions of the
  training kernels;
- `rel_pos_flash_attention` (`csrc/relpos_flash_fwd.cu`, counted in
  `rel_pos_flash_attention.launches`), replacing the TPU kernel
  `_relpos_flash_kernel`: inference only, bf16, head dim 64 or 80, a
  grid of gh + gw <= 128 (wgmma + TMA, as kernel 1);
  `rel_pos_flash_attention_lse`, the same source's lse instance (training),
  and `rel_pos_flash_attention_bwd` (`csrc/relpos_flash_bwd.cu`, the port's
  own: the JAX package differentiates its XLA path there), bf16, head dim
  64 or 80, gw <= 64; each counted in its own `.launches`;
- `rel_pos_train_attention` (`torch.ops.ovmono3d.rel_pos_train_attention`):
  the training forward over (qkv, qrh, qrw) as one operator with its
  autograd formula, as `train_attention`: those two kernels on CUDA, the
  plain versions on the CPU;
- `rel_pos_attention`: its dispatcher. The bias factors qrh/qrw are
  computed outside the kernels in f32 (`rel_pos_factors`), and autograd
  takes their gradients back to q and the tables. f32 inputs (on any
  device) go to the plain version (the JAX f32 branch is XLA code); bf16
  with a gradient goes to `rel_pos_train_attention` on both devices;
  without one, CPU tensors go to the plain version and CUDA tensors to
  kernel 7. Shapes the kernels do not take raise.

Swin window attention (GroundingDINO's image trunk):

- `window_attention_ref`: the plain version, the same math as the JAX
  package's `window_attention_xla(..., clamp_c=None)`;
- `window_flash_attention` (`csrc/window_attn_fwd.cu`, counted in
  `window_flash_attention.launches`), replacing the TPU kernel
  `_window_kernel`: inference only, bf16, head dim 32; windows of up to 144
  tokens (every Swin-B stage) run the wgmma + TMA design, larger ones (up
  to 1024) the earlier mma.sync one (`window_kernel_instance`);
- `window_attention`: its dispatcher. f32 inputs (on any device) and CPU
  tensors go to the plain version; CUDA bf16 goes to the kernel, and raises
  when a gradient is needed (the JAX window attention is forward-only: the
  Swin trunk is frozen).

Layout: q/k/v [B, N, H, D]; the dispatcher and the Functions take the qkv
projection's output viewed as [B, N, 3, H, D]. lse is [B, H, N] f32 in
natural-log units and unclamped. The JAX head-major lse is log2 of the
denominator of its softmax shifted by the clamp C = 50, laid out
[B*H, 1, n_q] with n_q padded to its q block: lse_ln = lse2 * ln 2 + C on
the first N entries (exact while the row's max logit is within its clamp
window). Rel-pos tables Rh [h, h, D] and Rw [w, w, D] are already gathered
to the (h, w) grid; qrh [B, N, H, h] and qrw [B, N, H, w]. Window attention
runs over BW = B * nw windows of N tokens: bias [H, N, N] f32 and region ids
[nw, N] int32 (window b takes row b % nw), or None.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

KERNEL_SOURCES = ["flash_attn_fwd.cu", "flash_attn_bwd.cu",
                  "relpos_flash_fwd.cu", "relpos_flash_bwd.cu",
                  "window_attn_fwd.cu"]
_HEAD_DIMS = (32, 64)      # csrc/flash_attn_{fwd,bwd}.cu instances
_FWD_DTYPES = (torch.bfloat16, torch.float32)
_REL_POS_HEAD_DIMS = (64, 80)
_REL_POS_MAX_BIAS = 128      # csrc/relpos_flash_fwd.cu kMaxBias: gh + gw
_REL_POS_BWD_MAX_GW = 64     # csrc/relpos_flash_bwd.cu kMaxGw
_WINDOW_HEAD_DIM = 32
_WINDOW_MAX_TOKENS = 1024   # csrc/window_attn_fwd.cu kMaxTokens
_WINDOW_SM90_TOKENS = 144   # csrc/window_attn_fwd.cu w90::kN
_F32_NO_GRAD = ("f32 attention with a gradient on CUDA: the training "
                "kernels (3 and 4) take bfloat16 only; their f32 instance is "
                "ROADMAP queue 2 item 7")


def attention_ref(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v. q/k/v: [B, N, H, D] -> [B, N, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # Products of the input dtype are exact in f32, so f32 operands give the
    # same logits as an f32-accumulating product of the inputs.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward with its row log-sum-exp, all in f32: out [B, N, H, D]
    (f32) and lse = log(sum_j exp(q k_j / sqrt(D))) [B, H, N] (f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out, lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit attention backward in f32, from the forward's output o
    and lse ([B, H, N]) and the output's gradient do:

        p = exp(q k^T / sqrt(D) - lse),  dv = p^T do,  dp = do v^T,
        ds = p * (dp - rowsum(do * o)),  dk = ds^T q / sqrt(D),
        dq = ds k / sqrt(D).

    Returns f32 (dq, dk, dv), each [B, N, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(logits - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = attention_bwd_delta_ref(o, do)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq, dk, dv


def attention_bwd_delta_ref(o: torch.Tensor,
                            do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in f32, [B, N, H, D] -> [B, H, N]: the JAX
    package's delta (computed outside its Pallas kernels)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())


def attention_bwd_stats_ref(o: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor,
                            n_pad: int | None = None) -> torch.Tensor:
    """The plain version of kernel 4's stats pass: f32 [2, B, H,
    n_pad] holding delta = rowsum(do * o) and lse2 = lse * log2(e), and,
    past N, delta = 0 and lse2 = +inf (a padded query row gets p = 0).
    n_pad defaults to N; the kernel's is the last dim of `_bwd_stats`."""
    b, n, h, _ = o.shape
    n_pad = n if n_pad is None else n_pad
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} below N = {n}")
    out = torch.zeros((2, b, h, n_pad), dtype=torch.float32,
                      device=o.device)
    out[1] = math.inf
    out[0, ..., :n] = attention_bwd_delta_ref(o, do)
    out[1, ..., :n] = lse.float() * (1.0 / math.log(2.0))
    return out


@functools.cache
def _kernels() -> dict:
    """The entries of the built libraries, by name."""
    from ovmono3d_tpu_torch.utils import cuda_build

    libs = cuda_build.load(KERNEL_SOURCES)
    strided = [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fns = {
        "fwd": (libs["flash_attn_fwd.cu"].flash_attn_fwd_bf16,
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + strided),
        "fwd_f32": (libs["flash_attn_fwd.cu"].flash_attn_fwd_f32,
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + strided),
        "bwd": (libs["flash_attn_bwd.cu"].flash_attn_bwd_bf16,
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]),
        "bwd_stats": (libs["flash_attn_bwd.cu"].flash_attn_bwd_stats_bf16,
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 2),
        "relpos": (libs["relpos_flash_fwd.cu"].relpos_flash_fwd_bf16,
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + strided),
        "relpos_lse": (libs["relpos_flash_fwd.cu"].relpos_flash_fwd_lse_bf16,
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + strided),
        "relpos_bwd": (libs["relpos_flash_bwd.cu"].relpos_flash_bwd_bf16,
                       [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]),
        "window": (libs["window_attn_fwd.cu"].window_attn_fwd_bf16,
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + strided),
    }
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    scratch = {
        "bwd_scratch": libs["flash_attn_bwd.cu"].flash_attn_bwd_scratch_floats,
        "relpos_bwd_scratch":
            libs["relpos_flash_bwd.cu"].relpos_flash_bwd_scratch_floats}
    for fn in scratch.values():
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    return {**scratch,
            **{name: fn for name, (fn, _) in fns.items()}}


def build_kernels() -> None:
    """Compile (or load) the attention kernel libraries now rather than at
    the first launch."""
    _kernels()


def _layout_error(name: str, x: torch.Tensor, shape,
                  dtypes=(torch.bfloat16,)) -> str | None:
    """Why the kernels cannot take `x` as it is, or None."""
    if x.dtype not in dtypes:
        return (f"{name} is {x.dtype}; the kernel takes "
                + " or ".join(str(t).removeprefix("torch.") for t in dtypes))
    if x.dim() != 4 or tuple(x.shape) != tuple(shape):
        return (f"{name} has shape {tuple(x.shape)}; want [B, N, H, D] equal "
                f"to q's {tuple(shape)}")
    if x.stride(-1) != 1:
        return f"{name} needs a unit stride over D"
    # 16-byte rows: cp.async moves 8 bf16 or 4 f32 at a time, and TMA takes
    # 16-byte aligned addresses and strides.
    per_copy = 16 // x.element_size()
    if x.data_ptr() % 16 or any(s % per_copy for s in x.stride()[:3]):
        return (f"{name}: pointer and batch/token/head strides must be "
                f"16-byte aligned (strides {x.stride()})")
    return None


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *others: tuple[str, torch.Tensor],
                        forward_only: bool = False,
                        dtypes=(torch.bfloat16,),
                        wrapper: str = "flash_attention_packed") -> None:
    """Raise ValueError unless the kernels take q/k/v (and the named
    `others`) as they are: one dtype of `dtypes`, head dim 32 or 64.
    `forward_only` also refuses inputs that need a gradient, for the
    inference kernels (`wrapper` names the refusing one). The device is
    checked last, so the layout checks run on CPU tensors too."""
    if q.dtype == torch.float32 and q.dtype not in dtypes:
        raise ValueError(_F32_NO_GRAD)
    named = [("q", q), ("k", k), ("v", v), *others]
    for name, x in named:
        err = _layout_error(name, x, q.shape, dtypes)
        if err:
            raise ValueError(err)
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q {q.dtype}: the kernel "
                             f"takes all its inputs in one dtype")
        if forward_only and x.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                f"{wrapper} is forward-only; dot_product_attention runs the "
                f"backward kernels through train_attention")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]}; the kernels take "
                         f"{_HEAD_DIMS}: other head dims are ROADMAP queue 2 "
                         f"item 7")
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; the kernel needs "
                             f"all its tensors on one CUDA device")


def _launch_fwd(q, k, v, lse: torch.Tensor | None) -> torch.Tensor:
    """One launch of csrc/flash_attn_fwd.cu's instance for q's dtype, after
    the checks; returns the contiguous [B, N, H, D] output."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    f32 = q.dtype == torch.float32
    name = "flash_attn_fwd_f32" if f32 else "flash_attn_fwd_bf16"
    fn = _kernels()["fwd_f32" if f32 else "fwd"]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if not f32:
        ptrs.append(None if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, b, n, h, d, *strides, 1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed with CUDA error {rc} "
            f"(B={b}, N={n}, H={h}, D={d}, lse={lse is not None})")
    return out


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA flash-attention forward (kernel 1, inference), bf16
    or f32, head dim 32 or 64. [B, N, H, D] -> same.

    q/k/v may be strided views (the qkv projection's [B, N, 3, H, D] output
    unbound along the 3); the result is contiguous, so its [B, N, H*D] view
    is free. Counts each launch in `flash_attention_packed.launches` (bf16)
    or `flash_attention_packed.launches_f32` (the f32 instance).
    """
    check_kernel_inputs(q, k, v, forward_only=True, dtypes=_FWD_DTYPES)
    out = _launch_fwd(q, k, v, None)
    if q.dtype == torch.float32:
        flash_attention_packed.launches_f32 += 1
    else:
        flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0
flash_attention_packed.launches_f32 = 0


def flash_attention_packed_lse(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward that also writes the row log-sum-exp (kernel 3,
    training). Returns out [B, N, H, D] bf16 (contiguous) and lse
    [B, H, N] f32, natural log. Counts each launch in
    `flash_attention_packed_lse.launches`."""
    check_kernel_inputs(q, k, v, wrapper="flash_attention_packed_lse")
    b, n, h, _ = q.shape
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, lse)
    flash_attention_packed_lse.launches += 1
    return out, lse


flash_attention_packed_lse.launches = 0


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    b, n, h, _ = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, n)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous [B, H, N] = {(b, h, n)} "
                         f"f32 tensor; got {lse.dtype} {tuple(lse.shape)}")


def _check_same_device(x: torch.Tensor, name: str, q: torch.Tensor) -> None:
    if x.device != q.device:
        raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _bwd_scratch(q: torch.Tensor) -> torch.Tensor:
    """The f32 scratch of the stats pass, flat: [2, B, H, n_pad] (delta,
    lse2), sized by the library itself."""
    b, n, h, _ = q.shape
    floats = _kernels()["bwd_scratch"](b, n, h)
    return torch.empty(floats, dtype=torch.float32, device=q.device)


def _bwd_stats(o: torch.Tensor, do: torch.Tensor,
               lse: torch.Tensor) -> torch.Tensor:
    """The stats pass of kernel 4 alone (csrc/flash_attn_bwd.cu's
    flash_attn_bwd_stats_bf16): [2, B, H, n_pad] f32 as
    `attention_bwd_stats_ref` lays it out, n_pad the library's. A hook for
    the tests; the backward wrapper runs the pass inside its own launch.
    CPU tensors run `attention_bwd_stats_ref`."""
    if o.device.type == "cpu":
        return attention_bwd_stats_ref(o, do, lse)
    b, n, h, d = o.shape
    for name, x in (("o", o), ("do", do)):
        err = _layout_error(name, x, o.shape)
        if err:
            raise ValueError(err)
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernels take {_HEAD_DIMS}")
    _check_lse(lse, o)
    _check_same_device(do, "do", o)
    _check_same_device(lse, "lse", o)
    scratch = _bwd_scratch(o)
    strides = [s for x in (o, do) for s in x.stride()[:3]]
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = _kernels()["bwd_stats"](
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            b, n, h, d, (ctypes.c_longlong * len(strides))(*strides), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_stats_bf16 launch failed with "
                           f"CUDA error {rc} (B={b}, N={n}, H={h}, D={d})")
    return scratch.view(2, b, h, -1)


def flash_attention_packed_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor
                               ) -> torch.Tensor:
    """Launch the CUDA flash-attention backward (kernel 4).

    q/k/v/o/do: [B, N, H, D] bf16 (strided views welcome), lse: [B, H, N]
    f32 from `flash_attention_packed_lse`. One launch of
    flash_attn_bwd_bf16: the stats pass, then the dk/dv and the dq kernels,
    writing into the three slots of the packed gradient [B, N, 3, H, D]
    bf16 that it returns, the gradient of the qkv projection's output (dq,
    dk, dv). Counts each launch in `flash_attention_packed_bwd.launches`.
    """
    b, n, h, d = q.shape
    _check_lse(lse, q)
    check_kernel_inputs(q, k, v, ("o", o), ("do", do))
    _check_same_device(lse, "lse", q)
    scratch = _bwd_scratch(q)
    grad = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = grad.unbind(2)
    strides = [s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernels()["bwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, n, h, d,
            (ctypes.c_longlong * len(strides))(*strides),
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attn_bwd_bf16 launch failed with CUDA error {rc} "
            f"(B={b}, N={n}, H={h}, D={d})")
    flash_attention_packed_bwd.launches += 1
    return grad


flash_attention_packed_bwd.launches = 0


def _contiguous_do(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return dout.contiguous() if _layout_error("do", dout, out.shape) else dout


@torch.library.custom_op("ovmono3d::train_attention", mutates_args=())
def train_attention(qkv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward over the packed qkv tensor [B, N, 3, H, D]:
    out [B, N, H, D] in qkv's dtype and lse [B, H, N] f32 (natural log).

    One operator (`torch.ops.ovmono3d.train_attention`), so a selective
    checkpoint policy can name it and keep its outputs (models/vit.py's
    "dots_attn", the JAX package's checkpoint_name tags on the flash
    forward's out and lse). On CUDA it launches kernel 3; on the CPU it is
    `attention_ref` with the rows' lse (`attention_lse_ref`'s), and
    `_train_attention_cpu.runs` counts its runs. Its backward is kernel 4
    on CUDA and `attention_bwd_ref` on the CPU."""
    raise NotImplementedError(f"no training attention on {qkv.device}")


@train_attention.register_kernel("cpu")
def _train_attention_cpu(qkv: torch.Tensor):
    # attention_ref's math (probabilities in v's dtype before PV, as the JAX
    # package's attention_xla that its CPU training differentiates), with
    # the row log-sum-exp of the same logits.
    _train_attention_cpu.runs += 1
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype), torch.logsumexp(logits, dim=-1)


_train_attention_cpu.runs = 0


@train_attention.register_kernel("cuda")
def _train_attention_cuda(qkv: torch.Tensor):
    return flash_attention_packed_lse(*qkv.unbind(2))


def _train_attention_setup(ctx, inputs, output) -> None:
    qkv, = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(qkv, out, lse)


def _train_attention_bwd(ctx, dout: torch.Tensor, _dlse):
    """The gradient of qkv, [B, N, 3, H, D] in qkv's dtype."""
    qkv, out, lse = ctx.saved_tensors
    q, k, v = qkv.unbind(2)
    if qkv.device.type == "cpu":
        grads = attention_bwd_ref(q, k, v, out, lse, dout)
        return torch.stack(grads, dim=2).to(qkv.dtype)
    return flash_attention_packed_bwd(q, k, v, out, lse,
                                      _contiguous_do(dout, out))


train_attention.register_autograd(_train_attention_bwd,
                                  setup_context=_train_attention_setup)


def dot_product_attention(qkv: torch.Tensor) -> torch.Tensor:
    """Attention for the ViT trunks: the qkv projection's output viewed as
    [B, N, 3, H, D] -> [B, N, H, D], routed as the module docstring says."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        if qkv.device.type == "cuda" and qkv.dtype == torch.float32:
            raise NotImplementedError(_F32_NO_GRAD)
        return train_attention(qkv)[0]
    if qkv.device.type == "cpu":
        return attention_ref(*qkv.unbind(2))
    return flash_attention_packed(*qkv.unbind(2))


_REL_POS_FWD_ONLY = ("rel_pos_flash_attention is forward-only; "
                     "rel_pos_attention runs the training kernels (kernel "
                     "7's lse instance and relpos_flash_bwd.cu) through "
                     "rel_pos_train_attention")


def rel_pos_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          Rh: torch.Tensor, Rw: torch.Tensor,
                          grid_hw: tuple[int, int]) -> torch.Tensor:
    """softmax(scale q k^T + bias_h + bias_w) v over an (h, w) token grid.

    q/k/v: [B, h*w, H, D]; Rh [h, h, D], Rw [w, w, D] (cast to q's dtype
    first). bias_h[i, j] = q_i . Rh[r_i, r_j] and bias_w[i, j] = q_i .
    Rw[c_i, c_j] with f32 accumulation; f32 logits and softmax;
    probabilities cast to v's dtype before PV; output in q's dtype. With f32
    inputs this is the JAX package's exact f32 branch (vit.py)."""
    B, N, H, D = q.shape
    h, w = grid_hw
    scale = 1.0 / math.sqrt(D)
    q32 = q.float()
    q_tok = q32.reshape(B, h, w, H, D)
    bias_h = torch.einsum("brcnd,rkd->bnrck", q_tok, Rh.to(q.dtype).float())
    bias_w = torch.einsum("brcnd,ckd->bnrck", q_tok, Rw.to(q.dtype).float())
    logits = torch.einsum("bqhd,bkhd->bhqk", q32, k.float()) * scale
    logits = logits.view(B, H, h, w, h, w) + (bias_h[..., :, None]
                                              + bias_w[..., None, :])
    probs = torch.softmax(logits.view(B, H, N, N), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _rel_pos_logits(q: torch.Tensor, k: torch.Tensor, qrh: torch.Tensor,
                    qrw: torch.Tensor, grid_hw: tuple[int, int]
                    ) -> torch.Tensor:
    """f32 [B, H, N, N]: scale q_i.k_j + qrh[i, j // w] + qrw[i, j % w]."""
    B, N, H, D = q.shape
    h, w = grid_hw
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(D))
    bias = (qrh.float().permute(0, 2, 1, 3)[..., :, None]
            + qrw.float().permute(0, 2, 1, 3)[..., None, :])
    return (logits.view(B, H, N, h, w) + bias).view(B, H, N, N)


def rel_pos_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, qrh: torch.Tensor,
                              qrw: torch.Tensor, grid_hw: tuple[int, int]
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rel-pos forward with its row log-sum-exp, all in f32, from the
    bias factors (`rel_pos_factors`): out [B, N, H, D] (f32) and lse =
    log(sum_j exp(s_ij)) [B, H, N] (f32), s the biased logits. The plain
    version of kernel 7's lse instance."""
    logits = _rel_pos_logits(q, k, qrh, qrw, grid_hw)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()), lse


def rel_pos_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              qrh: torch.Tensor, qrw: torch.Tensor,
                              grid_hw: tuple[int, int]) -> tuple:
    """The explicit rel-pos attention backward in f32, from the forward's
    output o and lse ([B, H, N]) and the output's gradient do; with s the
    biased logits (`rel_pos_attention_lse_ref`):

        p = exp(s - lse),  dv = p^T do,  dS = p * (do v^T - rowsum(do * o)),
        dk = dS^T q / sqrt(D),  dq = dS k / sqrt(D),
        dqrh[i, a] = sum_{j in key row a} dS_ij,
        dqrw[i, c] = sum_{j in key column c} dS_ij.

    Returns f32 (dq, dk, dv) [B, N, H, D] and (dqrh, dqrw), the factors'
    shapes. The plain version of csrc/relpos_flash_bwd.cu."""
    B, N, H, D = q.shape
    h, w = grid_hw
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.exp(_rel_pos_logits(q, k, qrh, qrw, grid_hw)
                  - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - attention_bwd_delta_ref(o, do)[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    ds = ds.view(B, H, N, h, w)
    dqrh = ds.sum(-1).permute(0, 2, 1, 3).contiguous()
    dqrw = ds.sum(-2).permute(0, 2, 1, 3).contiguous()
    return dq, dk, dv, dqrh, dqrw


def rel_pos_factors(q: torch.Tensor, Rh: torch.Tensor, Rw: torch.Tensor,
                    grid_hw: tuple[int, int]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's bias factors qrh [B, N, H, h] = q_i . Rh[r_i, a] and
    qrw [B, N, H, w] = q_i . Rw[c_i, a]: q and the tables in q's dtype,
    products and sums in f32, contiguous f32 results (the JAX package's
    einsums before its kernel, without the TPU's bf16 cast). Under autograd
    the factors' gradients flow back to q, Rh and Rw through these einsums,
    as the JAX package's vjp does."""
    B, N, H, D = q.shape
    h, w = grid_hw
    q_tok = q.float().reshape(B, h, w, H, D)
    qrh = torch.einsum("brcnd,rkd->brcnk", q_tok, Rh.to(q.dtype).float())
    qrw = torch.einsum("brcnd,ckd->brcnk", q_tok, Rw.to(q.dtype).float())
    return (qrh.reshape(B, N, H, h).contiguous(),
            qrw.reshape(B, N, H, w).contiguous())


def check_rel_pos_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         qrh: torch.Tensor, qrw: torch.Tensor,
                         grid_hw: tuple[int, int], *others,
                         forward_only: bool = True,
                         backward: bool = False) -> None:
    """Raise ValueError unless the rel-pos kernels take these inputs as
    they are: kernel 7 (`forward_only` also refuses inputs that need a
    gradient, for its inference instance) and, with `backward`,
    csrc/relpos_flash_bwd.cu (gw <= 64 too). `others` are (name, tensor)
    pairs laid out as q. The device is checked last, so the layout checks
    run on CPU tensors too."""
    h, w = grid_hw
    b, n, heads, d = q.shape
    if h * w != n:
        raise ValueError(f"grid {grid_hw} has {h * w} tokens, q has {n}")
    for name, x in (("q", q), ("k", k), ("v", v), *others):
        err = _layout_error(name, x, q.shape)
        if err:
            raise ValueError(err)
    if d not in _REL_POS_HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernel takes "
                         f"{_REL_POS_HEAD_DIMS}")
    if h + w > _REL_POS_MAX_BIAS:
        raise ValueError(f"grid {grid_hw}: the kernel keeps gh + gw <= "
                         f"{_REL_POS_MAX_BIAS} bias terms a row")
    if backward and w > _REL_POS_BWD_MAX_GW:
        raise ValueError(f"grid {grid_hw}: the rel-pos backward takes grid "
                         f"rows of at most {_REL_POS_BWD_MAX_GW} tokens (one "
                         f"key tile)")
    for name, x, width in (("qrh", qrh, h), ("qrw", qrw, w)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, n, heads, width)
                or not x.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous f32 [B, N, H, {width}] = "
                f"{(b, n, heads, width)} tensor; got {x.dtype} "
                f"{tuple(x.shape)}")
    named = (("q", q), ("k", k), ("v", v), ("qrh", qrh), ("qrw", qrw),
             *others)
    if (forward_only and torch.is_grad_enabled()
            and any(x.requires_grad for _, x in named)):
        raise ValueError(_REL_POS_FWD_ONLY)
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; the kernel needs "
                             f"all its tensors on one CUDA device")


def _launch_relpos_fwd(q, k, v, qrh, qrw, grid_hw,
                       lse: torch.Tensor | None) -> torch.Tensor:
    """One launch of csrc/relpos_flash_fwd.cu's inference instance, or its
    lse instance writing `lse`, after the checks; returns the contiguous
    [B, N, H, D] output."""
    b, n, heads, d = q.shape
    h, w = grid_hw
    out = torch.empty((b, n, heads, d), dtype=q.dtype, device=q.device)
    name = "relpos_flash_fwd_bf16" if lse is None else \
        "relpos_flash_fwd_lse_bf16"
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), qrh.data_ptr(),
            qrw.data_ptr(), out.data_ptr()]
    if lse is not None:
        ptrs.append(lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernels()["relpos" if lse is None else "relpos_lse"](
            *ptrs, b, n, heads, d, h, w, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], 1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed with CUDA error {rc} "
            f"(B={b}, N={n}, H={heads}, D={d}, grid={grid_hw})")
    return out


def rel_pos_flash_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, qrh: torch.Tensor,
                            qrw: torch.Tensor, grid_hw: tuple[int, int]
                            ) -> torch.Tensor:
    """Launch the CUDA decomposed-rel-pos attention forward (kernel 7).

    q/k/v: [B, h*w, H, D] bf16, D in {64, 80}, strided views welcome;
    qrh/qrw: contiguous f32 [B, N, H, h] / [B, N, H, w] (`rel_pos_factors`).
    Returns a contiguous [B, N, H, D] bf16. Counts each launch in
    `rel_pos_flash_attention.launches`."""
    check_rel_pos_inputs(q, k, v, qrh, qrw, grid_hw)
    out = _launch_relpos_fwd(q, k, v, qrh, qrw, grid_hw, None)
    rel_pos_flash_attention.launches += 1
    return out


rel_pos_flash_attention.launches = 0


def rel_pos_flash_attention_lse(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, qrh: torch.Tensor,
                                qrw: torch.Tensor, grid_hw: tuple[int, int]
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 7's lse instance (training): out [B, N, H, D] bf16
    (contiguous) and the row log-sum-exp of the biased logits, lse [B, H,
    N] f32, natural log and unclamped (kernel 3's unit). Inputs as
    `rel_pos_flash_attention`'s, with gw <= 64 (the backward's limit,
    checked here so a step does not fail only in its backward). Counts each
    launch in `rel_pos_flash_attention_lse.launches`."""
    check_rel_pos_inputs(q, k, v, qrh, qrw, grid_hw, forward_only=False,
                         backward=True)
    b, n, heads, _ = q.shape
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    out = _launch_relpos_fwd(q, k, v, qrh, qrw, grid_hw, lse)
    rel_pos_flash_attention_lse.launches += 1
    return out, lse


rel_pos_flash_attention_lse.launches = 0


def rel_pos_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                lse: torch.Tensor, do: torch.Tensor,
                                qrh: torch.Tensor, qrw: torch.Tensor,
                                grid_hw: tuple[int, int]
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Launch the CUDA rel-pos attention backward (csrc/relpos_flash_bwd.cu:
    a stats pass, then the dk/dv and the dq kernels; the dq kernel also
    reduces dqrh and dqrw, deterministically).

    q/k/v/o/do: [B, N, H, D] bf16 (strided views welcome), lse [B, H, N]
    f32 from `rel_pos_flash_attention_lse`, qrh/qrw as the forward took
    them. Returns the packed gradient [B, N, 3, H, D] bf16 (slots dq, dk,
    dv: the gradient of the qkv output, as kernel 4's) and dqrh, dqrw (f32,
    contiguous, the factors' shapes). Counts each launch in
    `rel_pos_flash_attention_bwd.launches`."""
    _check_lse(lse, q)
    _check_same_device(lse, "lse", q)
    check_rel_pos_inputs(q, k, v, qrh, qrw, grid_hw, ("o", o), ("do", do),
                         forward_only=False, backward=True)
    b, n, heads, d = q.shape
    h, w = grid_hw
    kernels = _kernels()
    scratch = torch.empty(kernels["relpos_bwd_scratch"](b, n, heads),
                          dtype=torch.float32, device=q.device)
    grad = torch.empty((b, n, 3, heads, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = grad.unbind(2)
    dqrh = torch.empty_like(qrh)
    dqrw = torch.empty_like(qrw)
    strides = [s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernels["relpos_bwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), qrh.data_ptr(), qrw.data_ptr(), lse.data_ptr(),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dqrh.data_ptr(), dqrw.data_ptr(), b, n, heads, d, h, w,
            (ctypes.c_longlong * len(strides))(*strides),
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(
            f"relpos_flash_bwd_bf16 launch failed with CUDA error {rc} "
            f"(B={b}, N={n}, H={heads}, D={d}, grid={grid_hw})")
    rel_pos_flash_attention_bwd.launches += 1
    return grad, dqrh, dqrw


rel_pos_flash_attention_bwd.launches = 0


@torch.library.custom_op("ovmono3d::rel_pos_train_attention", mutates_args=())
def rel_pos_train_attention(qkv: torch.Tensor, qrh: torch.Tensor,
                            qrw: torch.Tensor, gh: int, gw: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rel-pos training forward over the packed qkv tensor [B, N, 3,
    H, D] and the bias factors qrh [B, N, H, gh], qrw [B, N, H, gw] (f32):
    out [B, N, H, D] in qkv's dtype and lse [B, H, N] f32 (natural log).

    One operator (`torch.ops.ovmono3d.rel_pos_train_attention`) with its
    autograd formula, as `train_attention`: on CUDA kernel 7's lse instance
    forward and csrc/relpos_flash_bwd.cu backward; on the CPU
    rel_pos_attention_ref's math with the rows' lse
    (`_rel_pos_train_cpu.runs` counts its runs) and
    `rel_pos_attention_bwd_ref`. The backward gives the gradient of qkv
    (dq, dk, dv in its slots) and of qrh and qrw; autograd takes the
    latter back to q, Rh and Rw through `rel_pos_factors`."""
    raise NotImplementedError(f"no rel-pos training attention on "
                              f"{qkv.device}")


@rel_pos_train_attention.register_kernel("cpu")
def _rel_pos_train_cpu(qkv: torch.Tensor, qrh: torch.Tensor,
                       qrw: torch.Tensor, gh: int, gw: int):
    # rel_pos_attention_ref's math (probabilities in v's dtype before PV,
    # as the JAX package's _rel_pos_attention_fast that its CPU training
    # differentiates), with the row log-sum-exp of the same logits.
    _rel_pos_train_cpu.runs += 1
    q, k, v = qkv.unbind(2)
    logits = _rel_pos_logits(q, k, qrh, qrw, (gh, gw))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype), torch.logsumexp(logits, dim=-1)


_rel_pos_train_cpu.runs = 0


@rel_pos_train_attention.register_kernel("cuda")
def _rel_pos_train_cuda(qkv: torch.Tensor, qrh: torch.Tensor,
                        qrw: torch.Tensor, gh: int, gw: int):
    q, k, v = qkv.unbind(2)
    return rel_pos_flash_attention_lse(q, k, v, qrh, qrw, (gh, gw))


def _rel_pos_train_setup(ctx, inputs, output) -> None:
    qkv, qrh, qrw, gh, gw = inputs
    out, lse = output
    ctx.grid = (gh, gw)
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(qkv, qrh, qrw, out, lse)


def _rel_pos_train_bwd(ctx, dout: torch.Tensor, _dlse):
    """The gradients of qkv ([B, N, 3, H, D], qkv's dtype), qrh and qrw
    (f32)."""
    qkv, qrh, qrw, out, lse = ctx.saved_tensors
    q, k, v = qkv.unbind(2)
    if qkv.device.type == "cpu":
        dq, dk, dv, dqrh, dqrw = rel_pos_attention_bwd_ref(
            q, k, v, out, lse, dout, qrh, qrw, ctx.grid)
        return (torch.stack((dq, dk, dv), dim=2).to(qkv.dtype), dqrh, dqrw,
                None, None)
    grad, dqrh, dqrw = rel_pos_flash_attention_bwd(
        q, k, v, out, lse, _contiguous_do(dout, out), qrh, qrw, ctx.grid)
    return grad, dqrh, dqrw, None, None


rel_pos_train_attention.register_autograd(_rel_pos_train_bwd,
                                          setup_context=_rel_pos_train_setup)


def rel_pos_attention(qkv: torch.Tensor, Rh: torch.Tensor, Rw: torch.Tensor,
                      grid_hw: tuple[int, int]) -> torch.Tensor:
    """Rel-pos attention for the SAM encoder's blocks: the qkv projection's
    output viewed as [B, h*w, 3, H, D] -> [B, h*w, H, D], routed as the
    module docstring says."""
    q, k, v = qkv.unbind(2)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rel-pos attention path for device {qkv.device}")
    if qkv.dtype == torch.float32:
        return rel_pos_attention_ref(q, k, v, Rh, Rw, grid_hw)
    grad = torch.is_grad_enabled() and (qkv.requires_grad or Rh.requires_grad
                                        or Rw.requires_grad)
    if not grad and qkv.device.type == "cpu":
        return rel_pos_attention_ref(q, k, v, Rh, Rw, grid_hw)
    qrh, qrw = rel_pos_factors(q, Rh, Rw, grid_hw)
    if not grad:
        return rel_pos_flash_attention(q, k, v, qrh, qrw, grid_hw)
    return rel_pos_train_attention(qkv, qrh, qrw, *grid_hw)[0]


_WINDOW_NO_GRAD = ("window attention on CUDA is inference-only, as the JAX "
                   "package's is (the Swin trunk is frozen); run under "
                   "torch.no_grad() / inference_mode()")


def window_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor,
                         ids: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(scale q k^T + bias[h] + mask) v over each window.

    q/k/v: [BW, N, H, D]; bias [H, N, N] f32; ids [nw, N] region ids or
    None, window b taking ids[b % nw] and pairs of unequal ids getting -1e9.
    f32 logits and softmax; probabilities cast to v's dtype before PV, which
    accumulates in f32; output in q's dtype."""
    bw, n, h, d = q.shape
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(),
                          k.float()) * (1.0 / math.sqrt(d))
    logits = logits + bias.float()[None]
    if ids is not None:
        nw = ids.shape[0]
        mask = torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -1e9)
        logits = (logits.view(bw // nw, nw, h, n, n)
                  + mask[None, :, None]).view(bw, h, n, n)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def check_window_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, ids: torch.Tensor | None) -> None:
    """Raise ValueError unless kernel 8 takes these inputs as they are. The
    device is checked last, so the layout checks run on CPU tensors too."""
    bw, n, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        err = _layout_error(name, x, q.shape)
        if err:
            raise ValueError(err)
    if d != _WINDOW_HEAD_DIM:
        raise ValueError(f"head dim {d}; the kernel takes {_WINDOW_HEAD_DIM}")
    if not 0 < n <= _WINDOW_MAX_TOKENS:
        raise ValueError(f"{n} tokens a window; the kernel takes 1 to "
                         f"{_WINDOW_MAX_TOKENS}")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (h, n, n)
            or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous f32 [H, N, N] = "
                         f"{(h, n, n)} tensor; got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    named = [("q", q), ("k", k), ("v", v), ("bias", bias)]
    if ids is not None:
        if (ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[1] != n
                or bw % ids.shape[0] or not ids.is_contiguous()):
            raise ValueError(f"ids must be a contiguous int32 [nw, N] tensor "
                             f"with nw dividing {bw} windows; got "
                             f"{ids.dtype} {tuple(ids.shape)}")
        named.append(("ids", ids))
    if torch.is_grad_enabled() and any(x.requires_grad for _, x in named):
        raise ValueError(_WINDOW_NO_GRAD)
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; the kernel needs "
                             f"all its tensors on one CUDA device")


def window_kernel_instance(n: int) -> str:
    """The kernel that window_attn_fwd_bf16 runs for windows of n tokens
    (the C entry chooses by n alone): the wgmma + TMA design up to 144
    tokens, the mma.sync one past that."""
    if not 0 < n <= _WINDOW_MAX_TOKENS:
        raise ValueError(f"{n} tokens a window; the kernel takes 1 to "
                         f"{_WINDOW_MAX_TOKENS}")
    return ("window_fwd_sm90_kernel" if n <= _WINDOW_SM90_TOKENS
            else "window_fwd_kernel")


def window_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           ids: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA Swin window-attention forward (kernel 8).

    q/k/v: [BW, N, H, 32] bf16, strided views welcome; bias: contiguous
    [H, N, N] f32; ids: contiguous [nw, N] int32 or None. Returns a
    contiguous [BW, N, H, 32] bf16. Counts each launch in
    `window_flash_attention.launches`."""
    check_window_inputs(q, k, v, bias, ids)
    bw, n, h, d = q.shape
    out = torch.empty((bw, n, h, d), dtype=q.dtype, device=q.device)
    window = _kernels()["window"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = window(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    None if ids is None else ids.data_ptr(), out.data_ptr(),
                    bw, n, h, d, 0 if ids is None else ids.shape[0],
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(
            f"window_attn_fwd_bf16 launch failed with CUDA error {rc} "
            f"(BW={bw}, N={n}, H={h}, D={d}, ids={ids is not None}, "
            f"{window_kernel_instance(n)})")
    window_flash_attention.launches += 1
    return out


window_flash_attention.launches = 0


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     ids: torch.Tensor | None = None) -> torch.Tensor:
    """Window attention for the Swin blocks: the qkv projection's output
    viewed as [BW, N, 3, H, D] -> [BW, N, H, D]."""
    q, k, v = qkv.unbind(2)
    if qkv.dtype == torch.float32 or qkv.device.type == "cpu":
        return window_attention_ref(q, k, v, bias, ids)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window attention path for device {qkv.device}")
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        raise NotImplementedError(_WINDOW_NO_GRAD)
    return window_flash_attention(q, k, v, bias, ids)
