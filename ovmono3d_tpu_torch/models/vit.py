"""Vision Transformer trunks in PyTorch: the detector trunks (DINOv2, CLIP,
MAE, MiDaS, SAM), SAM's image encoder and Depth-Pro's encoders.

Counterpart of ovmono3d_tpu/models/vit.py: f32 parameters, activations and
products in the compute dtype (bf16 by default), LayerNorm statistics in
f32. Options ported:

- DINOv2 (the defaults): cls token, the learned position table bicubically
  resized to the runtime grid with DINOv2's +0.1 offset, LayerScale, the
  depth-fusion 1x1 conv after the last block;
- the other trunks' options: the size-based bicubic resize of the table
  (`pos_interp_offset=0`, CLIP, SAM and MiDaS), CLIP's `pre_ln` (its ln_pre,
  eps 1e-5) and `quick_gelu` MLPs, MAE's fixed 2D sin-cos table rebuilt at
  the runtime grid (`pos_sincos`, no learned table), and `norm_eps`;
- SAM's image encoder: no cls token (`use_cls_token=False`), windowed
  blocks (`window_size`, with global attention in `global_blocks`),
  decomposed relative-position attention (`use_rel_pos`) and the
  256-channel conv neck (`neck_channels`);
- Depth-Pro's encoders: `final_norm` (DINOv2's trailing `norm`) and
  `out_layers` (the pre-norm features of those blocks as `feat{i}`).

Attention goes through `dot_product_attention` and the rel-pos blocks
through `rel_pos_attention` (kernel 7); on the CPU both run their plain
versions. On the card `dot_product_attention` runs kernel 1 at every
shape (its bf16 instance, or its f32 one for an f32 trunk such as the JAX
GEO CLI's default Depth-Pro).

Serving options of every trunk: `quant="int8"` runs each block's qkv, proj,
fc1 and fc2 as W8A8 products (ops/quant.py `QDense`: CUDA kernel 10 on the
card; SERVING-only, it raises when autograd would need it), and
`gelu="tanh"` the MLPs' approximate GELU. The defaults ("none", "erf") are
the released models' ops.

Training: when the trunk needs gradients, attention runs through
ops/attention.py's `train_attention` operator: kernels 3 and 4; bf16 only
(an f32 trunk with gradients raises on the card). Rel-pos blocks run the
`rel_pos_train_attention` operator: kernel 7's lse instance and the rel-pos
backward (csrc/relpos_flash_bwd.cu), the bias factors' gradients taken back
to q and the tables by autograd (an f32 SAM trunk trains through the plain
version, as the JAX f32 branch is XLA code). Under no_grad /
inference_mode it runs the inference kernels. Freezing the trunk
(`BackboneConfig.freeze`) is done by `build_model`, which sets
requires_grad=False on this module's parameters.
`remat` checkpoints each plain block (`torch.utils.checkpoint`, the JAX
package's nn.remat) under `remat_policy`, which says what a block keeps for
its backward (`remat_context`): "full" only its input, "dots" also the
outputs of its dense products with no batch dimensions (qkv, proj, fc1,
fc2), "dots_attn" those and the attention's out and lse, so the backward
runs no attention forward again. Windowed and rel-pos blocks are not
wrapped, as in the JAX package.

Submodules carry the JAX package's parameter names (`block0.attn.qkv`,
`block0.attn.rel_pos_h`, `neck_conv1`, `ln_pre`, `norm`, ...) so
utils/flax_bridge.py maps the two trees mechanically.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ovmono3d_tpu_torch.models.layers import conv_norm_pair, lecun_normal_
from ovmono3d_tpu_torch.ops.attention import (dot_product_attention,
                                              rel_pos_attention)
from ovmono3d_tpu_torch.ops.quant import QDense

# DINOv2 interpolate_pos_encoding's scale-factor offset (the JAX package's
# "dinov2" preset, pos_interp_offset=0.1).
DINOV2_POS_OFFSET = 0.1


REMAT_POLICIES = ("full", "dots", "dots_attn")
# The dense products with no batch dimensions: F.linear on the blocks'
# [B, N, C] activations dispatches one of these (qkv, proj, fc1, fc2), what
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_context(policy: str):
    """The `context_fn` of torch.utils.checkpoint for a remat policy: None
    for "full" (a block keeps only its input and runs its whole forward
    again in the backward), else a selective-checkpoint context that keeps
    the outputs of `_DOT_OPS` ("dots") and also those of the attention's
    `train_attention` operator ("dots_attn") and recomputes the rest."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={policy!r}; expected one of "
                         f"{REMAT_POLICIES}")
    if policy == "full":
        return None
    kept = set(_DOT_OPS)
    if policy == "dots_attn":
        kept.add(torch.ops.ovmono3d.train_attention.default)

    def keep(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in kept
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, keep)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as space-to-depth + matmul.

    The weight is the conv's OIHW [E, C, p, p]; the patches are flattened in
    (p_h, p_w, c) order, so this equals a stride-p Conv2d. Returns
    [B, h*w, E] tokens.
    """

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        p = patch_size
        self.patch_size = p
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(embed_dim, in_chans, p, p, device=device))
        self.bias = nn.Parameter(torch.empty(embed_dim, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch_size
        h, w = H // p, W // p
        x = images.to(self.dtype).reshape(B, h, p, w, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, h * w, p * p * C)
        w2d = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(x, w2d.to(self.dtype), self.bias.to(self.dtype))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)


class LayerNormBf16Out(nn.Module):
    """LayerNorm with f32 statistics and output in the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(self.dtype)

    def init_weights(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.init_value = init_value
        self.dtype = dtype
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(self.dtype)

    def init_weights(self) -> None:
        nn.init.constant_(self.gamma, self.init_value)


GELUS = {"erf": "none", "tanh": "tanh"}   # gelu option -> F.gelu approximate


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2. `gelu` is "erf" (exact, the released models' op)
    or "tanh" (the approximate form, jax.nn.gelu(approximate=True): the JAX
    package's opt-in serving epilogue, not bit-identical). `quick_gelu`
    (OpenAI CLIP's towers) replaces either with x * sigmoid(1.702 x) on
    fc1's output, with int8 products too. `quant` is the products' int8
    serving option (ops/quant.py)."""

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.bfloat16,
                 device=None, quant: str = "none", gelu: str = "erf",
                 quick_gelu: bool = False):
        super().__init__()
        if gelu not in GELUS:
            raise ValueError(f"gelu={gelu!r}; the port takes {tuple(GELUS)}")
        self.approximate = GELUS[gelu]
        self.quick_gelu = quick_gelu
        self.fc1 = QDense(dim, hidden_dim, dtype, device=device, quant=quant)
        self.fc2 = QDense(hidden_dim, dim, dtype, device=device, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.quick_gelu:
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h, approximate=self.approximate)
        return self.fc2(h)


def _resize_rel_pos(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """Linear-resize a decomposed rel-pos table [L, D] to 2*size-1 rows as
    segment_anything's get_rel_pos does (F.interpolate mode="linear", which
    does not antialias)."""
    target = 2 * size - 1
    if rel_pos.shape[0] == target:
        return rel_pos
    out = F.interpolate(rel_pos.T[None], size=target, mode="linear",
                        align_corners=False)
    return out[0].T


class Attention(nn.Module):
    """Multi-head self-attention, global or with SAM's decomposed rel-pos
    bias (`use_rel_pos`; tables of 2*rel_pos_size-1 rows).

    `attn_fn` is the attention on the qkv output viewed as [B, N, 3, H, D],
    returning [B, N, H, D]: `dot_product_attention(qkv)` by default (on the
    card kernel 1 in bf16 or f32, and kernels 3 + 4 under autograd), and
    `rel_pos_attention(qkv, Rh, Rw, grid_hw)` with rel-pos. `quant` is the
    qkv and proj products' int8 serving option (ops/quant.py).
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16,
                 device=None, use_rel_pos: bool = False,
                 rel_pos_size: int = 0, quant: str = "none"):
        super().__init__()
        self.num_heads = num_heads
        self.use_rel_pos = use_rel_pos
        self.qkv = QDense(dim, 3 * dim, dtype, device=device, quant=quant)
        self.proj = QDense(dim, dim, dtype, device=device, quant=quant)
        if use_rel_pos:
            n_rel = 2 * rel_pos_size - 1
            self.rel_pos_h = nn.Parameter(
                torch.empty(n_rel, dim // num_heads, device=device))
            self.rel_pos_w = nn.Parameter(
                torch.empty(n_rel, dim // num_heads, device=device))
            self.attn_fn = rel_pos_attention
        else:
            self.attn_fn = dot_product_attention

    def rel_tables(self, grid_hw: tuple[int, int]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Rh [h, h, D] and Rw [w, w, D]: the tables resized to the grid and
        gathered at r_i - r_j + h - 1 (and likewise for columns), f32."""
        return self.gather_tables(self.rel_pos_h, self.rel_pos_w, grid_hw)

    @staticmethod
    def gather_tables(rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                      grid_hw: tuple[int, int]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """`rel_tables` of the given tables (a tensor-parallel rank passes
        them through its group's gradient all-reduce first)."""
        h, w = grid_hw
        rh = _resize_rel_pos(rel_pos_h, h)
        rw = _resize_rel_pos(rel_pos_w, w)
        dev = rh.device
        idx_h = (torch.arange(h, device=dev)[:, None]
                 - torch.arange(h, device=dev)[None, :] + h - 1)
        idx_w = (torch.arange(w, device=dev)[:, None]
                 - torch.arange(w, device=dev)[None, :] + w - 1)
        return rh[idx_h], rw[idx_w]

    def forward(self, x: torch.Tensor,
                grid_hw: tuple[int, int] | None = None) -> torch.Tensor:
        B, N, C = x.shape
        # The heads this module holds: all, or a tensor-parallel rank's
        # share (parallel/tensor_parallel.py splits qkv by head).
        qkv = self.qkv(x).view(B, N, 3, -1, C // self.num_heads)
        if self.use_rel_pos:
            out = self.attn_fn(qkv, *self.rel_tables(grid_hw), grid_hw)
        else:
            out = self.attn_fn(qkv)          # [B, N, H, D]
        return self.proj(out.reshape(B, N, -1))


class Block(nn.Module):
    """Pre-norm transformer block. With `window` > 0 (SAM's windowed
    blocks) the attention runs over window x window tiles of the token grid:
    the grid is padded with zeros AFTER norm1 (segment_anything's order), so
    the padded tokens are real keys of value proj(b_v), not LN(0)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layerscale: bool = True, dtype=torch.bfloat16,
                 norm_eps: float = 1e-6, device=None,
                 use_rel_pos: bool = False, rel_pos_size: int = 0,
                 window: int = 0, quant: str = "none", gelu: str = "erf",
                 quick_gelu: bool = False):
        super().__init__()
        self.window = window
        self.norm1 = LayerNormBf16Out(dim, norm_eps, dtype, device)
        self.attn = Attention(dim, num_heads, dtype, device, use_rel_pos,
                              rel_pos_size, quant)
        self.norm2 = LayerNormBf16Out(dim, norm_eps, dtype, device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, device, quant, gelu,
                       quick_gelu)
        if layerscale:
            self.ls1 = LayerScale(dim, dtype=dtype, device=device)
            self.ls2 = LayerScale(dim, dtype=dtype, device=device)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor,
                grid_hw: tuple[int, int] | None = None) -> torch.Tensor:
        h = self.norm1(x)
        if self.window > 0:
            h = self._windowed_attn(h, grid_hw)
        else:
            h = self.attn(h, grid_hw)
        x = x + self.ls1(h)
        return x + self.ls2(self.mlp(self.norm2(x)))

    def _windowed_attn(self, h: torch.Tensor,
                       grid_hw: tuple[int, int]) -> torch.Tensor:
        B, N, C = h.shape
        H, W = grid_hw
        win = self.window
        hp, wp = -(-H // win) * win, -(-W // win) * win
        g = F.pad(h.view(B, H, W, C), (0, 0, 0, wp - W, 0, hp - H))
        g = g.view(B, hp // win, win, wp // win, win, C)
        g = g.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C)
        g = self.attn(g, (win, win))
        g = g.view(B, hp // win, wp // win, win, win, C)
        g = g.permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)
        return g[:, :H, :W].reshape(B, N, C)


def _bicubic_matrix(src: int, dst: int, device,
                    offset: float = DINOV2_POS_OFFSET) -> torch.Tensor:
    """[dst, src] matrix of torch's 1-D bicubic resize (align_corners=False,
    border taps clamped): F.interpolate applied to the src basis vectors, so
    the weights are torch's own. With an `offset` it is DINOv2's mapping,
    scale_factor = (dst + offset) / src; with 0 the size-based one
    (F.interpolate(size=...), source position (i + 0.5) * src / dst - 0.5)
    of the CLIP, SAM and MiDaS resize helpers."""
    basis = torch.eye(src, device=device).reshape(1, src, src, 1)
    how = (dict(scale_factor=((dst + offset) / src, 1.0)) if offset
           else dict(size=(dst, 1)))
    out = F.interpolate(basis, mode="bicubic", align_corners=False, **how)
    if out.shape[2] != dst:
        raise ValueError(f"bicubic resize gave {out.shape[2]} rows, not {dst}")
    return out[0, :, :, 0].T


def sincos_pos_embed_2d(dim: int, grid_hw: tuple[int, int],
                        device=None) -> torch.Tensor:
    """MAE's fixed 2D sin-cos position table at the (h, w) grid, [h*w, dim]
    f32, row-major (transformers vit_mae get_2d_sincos_pos_embed as the
    reference rebuilds it, mae.py:152-179): the FIRST half of the channels
    encodes the column, each half [sin, cos] of pos * 10000^(-k / (dim/4))."""
    h, w = grid_hw
    quarter = dim // 4
    omega = 1.0 / 10000 ** (torch.arange(quarter, dtype=torch.float32,
                                         device=device) / quarter)

    def one_d(pos: torch.Tensor) -> torch.Tensor:
        x = pos[:, None] * omega[None]
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)

    cols = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    rows = torch.arange(h, dtype=torch.float32,
                        device=device).repeat_interleave(w)
    return torch.cat([one_d(cols), one_d(rows)], dim=-1)


def resize_pos_embed(pos_embed: torch.Tensor, grid_hw: tuple[int, int],
                     interpolate_offset: float = DINOV2_POS_OFFSET
                     ) -> torch.Tensor:
    """Bicubic-resize a [1, 1 + G*G, C] table (cls first) to the (h, w) grid
    as torch's F.interpolate(mode="bicubic", align_corners=False) does:
    with DINOv2's interpolate_pos_encoding mapping, scale_factor =
    ((h + 0.1) / G, (w + 0.1) / G), or with `interpolate_offset` 0 the
    size-based mapping of the other trunks (size=(h, w)).

    Bicubic resizing is separable, so it runs as two f32 products with the
    per-axis matrices: on an H100, F.interpolate on the 768-channel table
    itself took 4.6 ms per call, more than the attention of all 12 ViT-B
    blocks at 896^2. Returns [1, 1 + h*w, C].
    """
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    g = int(round(math.sqrt(patch_pe.shape[1])))
    c = patch_pe.shape[-1]
    h, w = grid_hw
    if (g, g) != (h, w):
        wy = _bicubic_matrix(g, h, pos_embed.device, interpolate_offset)
        wx = _bicubic_matrix(g, w, pos_embed.device, interpolate_offset)
        x = torch.einsum("hg,gkc->hkc", wy, patch_pe.reshape(g, g, c))
        x = torch.einsum("wk,hkc->hwc", wx, x)
        patch_pe = x.reshape(1, h * w, c)
    return torch.cat([cls_pe, patch_pe], dim=1)


class VisionTransformer(nn.Module):
    """ViT trunk: NHWC image -> {'last_feat': [B, h, w, C'] f32,
    'cls': [B, C] f32, 'feat{i}': [B, h, w, C] for i in out_layers}.
    Defaults are DINOv2 ViT-B/14; C' is neck_channels when there is a neck.
    `pos_interp_offset` is DINOv2's +0.1 by default (the JAX module's is 0:
    its callers pass the preset's); `pre_ln`, `quick_gelu`, `pos_sincos`
    and `norm_eps` are the CLIP and MAE presets' options.
    """

    def __init__(self, patch_size: int = 14, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 pretrain_grid: int = 37, layerscale: bool = True,
                 use_depth_fusion: bool = True, norm_eps: float = 1e-6, dtype=torch.bfloat16, device=None,
                 *, use_cls_token: bool = True,
                 pos_interp_offset: float = DINOV2_POS_OFFSET,
                 window_size: int = 0, global_blocks=(),
                 use_rel_pos: bool = False, neck_channels: int = 0,
                 out_layers=(), final_norm: bool = False,
                 pre_ln: bool = False, pos_sincos: bool = False,
                 quick_gelu: bool = False,
                 remat: bool = False, remat_policy: str = "dots_attn",
                 quant: str = "none", gelu: str = "erf"):
        super().__init__()
        self.remat = remat
        self.remat_context = remat_context(remat_policy)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.pos_interp_offset = pos_interp_offset
        self.n_prefix = 1 if use_cls_token else 0
        self.out_layers = tuple(out_layers)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, 3, dtype, device)
        self.pos_sincos = pos_sincos
        self.pos_embed = (None if pos_sincos else nn.Parameter(torch.empty(
            1, self.n_prefix + pretrain_grid**2, embed_dim, device=device)))
        self.ln_pre = (nn.LayerNorm(embed_dim, eps=1e-5, device=device)
                       if pre_ln else None)
        self.cls_token = (nn.Parameter(
            torch.empty(1, 1, embed_dim, device=device))
            if use_cls_token else None)
        self.depth = depth
        for i in range(depth):
            windowed = window_size > 0 and i not in global_blocks
            self.add_module(f"block{i}", Block(
                embed_dim, num_heads, mlp_ratio, layerscale, dtype, norm_eps,
                device, use_rel_pos=use_rel_pos,
                rel_pos_size=window_size if windowed else pretrain_grid,
                window=window_size if windowed else 0, quant=quant,
                gelu=gelu, quick_gelu=quick_gelu))
        self.depth_fusion = (
            nn.Conv2d(embed_dim + 1, embed_dim, 1, device=device)
            if use_depth_fusion else None)
        self.norm = (nn.LayerNorm(embed_dim, eps=1e-6, device=device)
                     if final_norm else None)
        if neck_channels > 0:
            self.neck_conv1 = nn.Conv2d(embed_dim, neck_channels, 1,
                                        bias=False, device=device)
            self.neck_norm1 = nn.LayerNorm(neck_channels, eps=1e-6,
                                           device=device)
            self.neck_conv2 = nn.Conv2d(neck_channels, neck_channels, 3,
                                        padding=1, bias=False, device=device)
            self.neck_norm2 = nn.LayerNorm(neck_channels, eps=1e-6,
                                           device=device)
        self.neck_channels = neck_channels

    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def forward(self, images: torch.Tensor,
                prompt_depth: torch.Tensor | None = None,
                neck: bool = True) -> dict:
        """images: [B, H, W, 3] normalized; prompt_depth: [B, H', W', 1].
        `neck=False` leaves SAM's neck to the caller (`self.neck`):
        last_feat is then the trunk's map in the compute dtype."""
        B, H, W, _ = images.shape
        h, w = H // self.patch_size, W // self.patch_size
        p = self.n_prefix
        x = self.patch_embed(images)
        if self.cls_token is not None:
            cls = self.cls_token.expand(B, 1, self.embed_dim).to(x.dtype)
            x = torch.cat([cls, x], dim=1)
        x = x + self._pos_table(h, w).to(x.dtype)
        if self.ln_pre is not None:
            # CLIP's ln_pre: f32 statistics, back to the compute dtype.
            x = self.ln_pre(x.float()).to(self.dtype)
        extra = {}
        for i, blk in enumerate(self.blocks()):
            if blk.window > 0 and p:
                # Prefix tokens bypass a windowed block.
                x = torch.cat([x[:, :p], blk(x[:, p:], (h, w))], dim=1)
            elif (self.remat and torch.is_grad_enabled() and blk.window == 0
                  and not blk.attn.use_rel_pos):
                x = checkpoint(blk, x, (h, w), use_reentrant=False,
                               **({} if self.remat_context is None else
                                  {"context_fn": self.remat_context}))
            else:
                x = blk(x, (h, w))
            if i == self.depth - 1 and self.depth_fusion is not None:
                x = self._fuse_depth(x, prompt_depth, B, h, w)
            if i in self.out_layers:
                extra[f"feat{i}"] = x[:, p:].reshape(B, h, w, self.embed_dim)
        if self.norm is not None:
            x = self.norm(x.float()).to(x.dtype)
        feat = x[:, p:].reshape(B, h, w, self.embed_dim)
        cls = x[:, 0] if p else x.mean(dim=1)
        if self.neck_channels > 0:
            if not neck:
                return {"last_feat": feat, "cls": cls.float(), **extra}
            feat = self.neck(feat)
        return {"last_feat": feat.float(), "cls": cls.float(), **extra}

    def neck(self, feat: torch.Tensor) -> torch.Tensor:
        """SAM's neck on the trunk's [B, h, w, C] map (output f32)."""
        return conv_norm_pair(feat, self.neck_conv1, self.neck_norm1,
                              self.neck_conv2, self.neck_norm2, self.dtype)

    def _pos_table(self, h: int, w: int) -> torch.Tensor:
        """[1, n_prefix + h*w, C] f32: MAE's sin-cos table built at the grid
        (zero for the cls slot), or the learned table resized to it (a
        table without a cls row gets a zero one for the resize, as
        the JAX module does)."""
        if self.pos_sincos:
            pe = sincos_pos_embed_2d(self.embed_dim, (h, w),
                                     self.patch_embed.weight.device)[None]
            return F.pad(pe, (0, 0, self.n_prefix, 0))
        if self.n_prefix:
            return resize_pos_embed(self.pos_embed, (h, w),
                                    self.pos_interp_offset)
        zero = self.pos_embed.new_zeros(1, 1, self.embed_dim)
        return resize_pos_embed(torch.cat([zero, self.pos_embed], dim=1),
                                (h, w), self.pos_interp_offset)[:, 1:]

    def _fuse_depth(self, x, prompt_depth, B, h, w):
        """Depth-prompt fusion after the last block (reference
        dino.py:91-105): a 1x1 conv over [patch tokens, depth]. Without a
        depth map the depth channel is zero and contributes nothing, so only
        the first C input channels are applied."""
        C = self.embed_dim
        p = self.n_prefix
        wt = self.depth_fusion.weight[:, :, 0, 0].to(self.dtype)   # [C, C+1]
        fused = F.linear(x[:, p:], wt[:, :C],
                         self.depth_fusion.bias.to(self.dtype))
        if prompt_depth is not None:
            # F.interpolate bilinear, half-pixel, no antialiasing (dino.py:85).
            d = F.interpolate(prompt_depth.permute(0, 3, 1, 2).to(self.dtype),
                              size=(h, w), mode="bilinear",
                              align_corners=False)
            fused = fused + d.reshape(B, h * w, 1) * wt[:, C]
        return torch.cat([x[:, :p], fused], dim=1)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: lecun-normal kernels, zero biases, normal(0.02)
        position table, zero cls token and rel-pos tables, LayerScale 1e-5,
        unit LayerNorms."""
        self.patch_embed.init_weights(generator)
        if self.pos_embed is not None:
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        if self.cls_token is not None:
            nn.init.zeros_(self.cls_token)
        for blk in self.blocks():
            blk.norm1.init_weights()
            blk.norm2.init_weights()
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                lin.init_lecun(generator)
            for ls in (blk.ls1, blk.ls2):
                if isinstance(ls, LayerScale):
                    ls.init_weights()
            if blk.attn.use_rel_pos:
                nn.init.zeros_(blk.attn.rel_pos_h)
                nn.init.zeros_(blk.attn.rel_pos_w)
        if self.depth_fusion is not None:
            lecun_normal_(self.depth_fusion.weight, self.embed_dim + 1,
                          generator)
            nn.init.zeros_(self.depth_fusion.bias)
        norms = [self.norm, self.ln_pre]
        if self.neck_channels > 0:
            for conv in (self.neck_conv1, self.neck_conv2):
                lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            norms += [self.neck_norm1, self.neck_norm2]
        for norm in norms:
            if norm is not None:
                nn.init.ones_(norm.weight)
                nn.init.zeros_(norm.bias)


def _preset(patch_size: int, embed_dim: int, depth: int, num_heads: int,
            kw: dict) -> VisionTransformer:
    """A preset with the JAX module's defaults where the port's differ
    (pos_interp_offset 0, remat_policy "full"), so a preset built with the
    same keywords in both packages is the same trunk."""
    kw = {"pos_interp_offset": 0.0, "remat_policy": "full", **kw}
    return VisionTransformer(patch_size=patch_size, embed_dim=embed_dim,
                             depth=depth, num_heads=num_heads, **kw)


def vit_base_14(**kw) -> VisionTransformer:
    return _preset(14, 768, 12, 12, kw)


def vit_large_14(**kw) -> VisionTransformer:
    return _preset(14, 1024, 24, 16, kw)
