"""Swin Transformer in PyTorch: GroundingDINO's image trunk.

Counterpart of ovmono3d_tpu/models/gdino/swin.py (swin_B_384_22k through
groundingdino's build_model). Swin-B: embed 128, depths (2, 2, 18, 2), heads
(4, 8, 16, 32), window 12; features at strides 8/16/32 with 256/512/1024
channels (stages 1, 2, 3), f32.

Dtypes follow the JAX module: LayerNorms in f32, the products and the
window partition in the compute dtype (bf16). Stage 0's residual stream is
f32 (it starts at the f32 patch norm); after each patch merging it is in the
compute dtype, because the merge's reduction returns it.

Window attention goes through `ops.attention.window_attention` (CUDA kernel
8 for bf16 on the card, the plain version on the CPU and in f32). Every
block's relative-position bias [H, w^2, w^2] is expanded from its table once
per set of weights (`SwinTransformer.rel_biases`), not in every forward; it
is expanded anew when the tables change (a load or a move bumps their
version or storage). A map no larger than the window is one window with no
shift, and its block expands the centred part of its table in the forward.

Submodules carry the JAX package's parameter names (`patch_embed`,
`stage0_block1.attn.rel_pos_bias`, `merge0.reduction`, `out_norm1`, ...) for
utils/flax_bridge.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import (Dense, LayerNorm,
                                              init_flax_defaults)
from ovmono3d_tpu_torch.models.vit import PatchEmbed
from ovmono3d_tpu_torch.ops.attention import window_attention


def _rel_pos_index(table_window: int, window: int | None = None,
                   device=None) -> torch.Tensor:
    """[w^2, w^2] index into a bias table built for `table_window`. For a
    smaller effective window `w` the same packing indexes the centred part
    of the table."""
    window = window or table_window
    r = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    return ((rel[:, :, 0] + table_window - 1) * (2 * table_window - 1)
            + rel[:, :, 1] + table_window - 1)


def _shift_region_ids(hp: int, wp: int, window: int, shift: int
                      ) -> np.ndarray:
    """Per-window region ids of the shifted-window mask: [num_windows, w^2]
    int32 (equal ids attend, others get -1e9)."""
    img_mask = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mask = img_mask.reshape(hp // window, window, wp // window, window)
    mask = mask.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return mask.astype(np.int32)


@functools.cache
def _region_ids(hp: int, wp: int, window: int, shift: int,
                device: torch.device) -> torch.Tensor:
    """`_shift_region_ids` on `device`, made once per shape: a copy in every
    forward would synchronise the host with the card."""
    with torch.inference_mode(False):
        return torch.from_numpy(_shift_region_ids(hp, wp, window, shift)
                                ).to(device)


def expand_rel_pos_bias(table: torch.Tensor, table_window: int,
                        window: int | None = None) -> torch.Tensor:
    """Table [(2W-1)^2, H] -> bias [H, w^2, w^2] f32 for window w <= W."""
    window = window or table_window
    n = window * window
    idx = _rel_pos_index(table_window, window, table.device).reshape(-1)
    return table[idx].reshape(n, n, -1).permute(2, 0, 1).float().contiguous()


class WindowAttention(nn.Module):
    """qkv -> windowed attention with the bias (and the shift mask) ->
    proj. `attn_fn(qkv [BW, N, 3, H, D], bias, ids)` is
    `window_attention` by default."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = Dense(dim, 3 * dim, dtype, device=device)
        self.proj = Dense(dim, dim, dtype, device=device)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads, device=device))
        self.attn_fn = window_attention

    def forward(self, x: torch.Tensor, ids: torch.Tensor | None,
                bias: torch.Tensor) -> torch.Tensor:
        """x [BW, N, C]; ids [nw, N] int32 or None; bias [H, N, N] f32."""
        bw, n, c = x.shape
        qkv = self.qkv(x).view(bw, n, 3, self.num_heads, c // self.num_heads)
        return self.proj(self.attn_fn(qkv, bias, ids).reshape(bw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.window, self.shift, self.dtype = window, shift, dtype
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttention(dim, num_heads, window, dtype, device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), dtype, device=device)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, dtype, device=device)

    def forward(self, x: torch.Tensor, hw: tuple[int, int],
                bias: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H*W, C]; bias: this block's hoisted [H, w^2, w^2] bias for
        the table window, or None to expand it here."""
        H, W = hw
        B, _, C = x.shape
        # Swin's rule: a map no larger than the window is one window, with
        # no shift.
        win, shift = self.window, self.shift
        if min(H, W) <= win:
            win, shift = min(H, W), 0
        if bias is None or win != self.window:
            bias = expand_rel_pos_bias(self.attn.rel_pos_bias, self.window,
                                       win)
        shortcut = x
        h = self.norm1(x).to(self.dtype).view(B, H, W, C)
        hp, wp = -(-H // win) * win, -(-W // win) * win
        h = F.pad(h, (0, 0, 0, wp - W, 0, hp - H))
        ids = None
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            ids = _region_ids(hp, wp, win, shift, x.device)
        h = h.view(B, hp // win, win, wp // win, win, C)
        h = h.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C)
        h = self.attn(h, ids, bias)
        h = h.view(B, hp // win, wp // win, win, win, C)
        h = h.permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = shortcut + h[:, :H, :W].reshape(B, H * W, C)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, dtype, bias=False,
                               device=device)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]
                ) -> tuple[torch.Tensor, tuple[int, int]]:
        H, W = hw
        B, _, C = x.shape
        x = F.pad(x.view(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        # Concatenation order x0, x1, x2, x3 as the JAX module (and Swin).
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        hp, wp = x.shape[1], x.shape[2]
        x = self.reduction(self.norm(x.reshape(B, hp * wp, 4 * C)))
        return x, (hp, wp)


class SwinTransformer(nn.Module):
    """Swin-B by default; returns {'s1': /8, 's2': /16, 's3': /32} f32
    [B, h, w, C] features."""

    def __init__(self, embed_dim: int = 128, depths=(2, 2, 18, 2),
                 num_heads=(4, 8, 16, 32), window: int = 12,
                 out_indices=(1, 2, 3), dtype=torch.bfloat16, device=None):
        super().__init__()
        self.depths, self.window = tuple(depths), window
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(4, embed_dim, dtype=dtype, device=device)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5, device=device)
        dim = embed_dim
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", SwinBlock(
                    dim, num_heads[si], window,
                    shift=0 if bi % 2 == 0 else window // 2, dtype=dtype,
                    device=device))
            if si in self.out_indices:
                self.add_module(f"out_norm{si}",
                                LayerNorm(dim, eps=1e-5, device=device))
            if si < len(self.depths) - 1:
                self.add_module(f"merge{si}", PatchMerging(dim, dtype, device))
                dim *= 2
        self._bias_cache: tuple | None = None

    def blocks(self) -> dict[str, SwinBlock]:
        return {f"stage{si}_block{bi}": getattr(self, f"stage{si}_block{bi}")
                for si, depth in enumerate(self.depths)
                for bi in range(depth)}

    def rel_biases(self) -> dict[str, torch.Tensor]:
        """{block name: [H, W^2, W^2] f32} for the table window W: each
        block's bias expanded once per set of weights (the JAX package's
        expand_rel_pos_biases, held on the tables' device). Expanded anew
        when a table's storage or version changes."""
        tables = {name: blk.attn.rel_pos_bias
                  for name, blk in self.blocks().items()}
        key = tuple((t.data_ptr(), t._version, t.device)
                    for t in tables.values())
        if self._bias_cache is None or self._bias_cache[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                biases = {name: expand_rel_pos_bias(t, self.window)
                          for name, t in tables.items()}
            self._bias_cache = (key, biases)
        return self._bias_cache[1]

    def forward(self, images: torch.Tensor,
                rel_biases: dict[str, torch.Tensor] | None = None
                ) -> dict[str, torch.Tensor]:
        """images [B, H, W, 3] normalized, H and W multiples of 4;
        rel_biases from `rel_biases()`, or None to expand every block's
        bias in the forward (the path gradients need)."""
        B, H, W, _ = images.shape
        if H % 4 or W % 4:
            raise ValueError(f"SwinTransformer input H, W must be multiples "
                             f"of 4 (got {H}x{W}); pad the canvas first")
        hw = (H // 4, W // 4)
        x = self.patch_norm(self.patch_embed(images))
        outs = {}
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                name = f"stage{si}_block{bi}"
                x = getattr(self, name)(
                    x, hw, None if rel_biases is None else rel_biases[name])
            if si in self.out_indices:
                feat = getattr(self, f"out_norm{si}")(x)
                outs[f"s{si}"] = feat.view(B, hw[0], hw[1], -1)
            if si < len(self.depths) - 1:
                x, hw = getattr(self, f"merge{si}")(x, hw)
        return outs

    def init_weights(self, generator: torch.Generator) -> None:
        init_flax_defaults(self, generator)
        self.patch_embed.init_weights(generator)
        for blk in self.blocks().values():
            nn.init.normal_(blk.attn.rel_pos_bias, 0.0, 0.02,
                            generator=generator)
