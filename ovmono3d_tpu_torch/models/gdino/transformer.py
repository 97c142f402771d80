"""GroundingDINO's cross-modality transformer layers in PyTorch.

Counterpart of ovmono3d_tpu/models/gdino/transformer.py: the feature
enhancer's layers (bi-directional image <-> text fusion, the text
self-attention layer, the image deformable layer), the decoder layer with
text cross-attention, the box MLP and the sine embeddings.

Dtypes follow the JAX modules: the layers' products in their `dtype` (the
model's compute dtype, bf16 when serving), attention logits, softmax and the
products' accumulation in f32, LayerNorms in f32. The attentions here are
plain PyTorch, as they are XLA einsums in the JAX package. The JAX modules'
ablation knobs (`debug_skip`, `sample_levels`) are not carried over.

Submodules carry the JAX package's parameter names for
utils/flax_bridge.py.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.gdino.deformable import (
    deformable_attention_core)
from ovmono3d_tpu_torch.models.layers import Dense, LayerNorm


def _dim_t(half: int, temperature: float, device) -> torch.Tensor:
    i = torch.arange(half, dtype=torch.float32, device=device)
    return temperature ** (2 * (i // 2) / half)


def sine_position_embedding(spatial_shapes: list[tuple[int, int]],
                            dim: int = 256, temperature: float = 20.0,
                            device=None) -> torch.Tensor:
    """DETR's normalized 2D sine embedding of every token of every level,
    concatenated: [S, dim] (pos(y) then pos(x), sin/cos interleaved)."""
    half = dim // 2
    dim_t = _dim_t(half, temperature, device)
    outs = []
    for h, w in spatial_shapes:
        ys = torch.arange(h, dtype=torch.float32, device=device) + 1.0
        xs = torch.arange(w, dtype=torch.float32, device=device) + 1.0
        ys = ys / (h + 1e-6) * 2 * math.pi
        xs = xs / (w + 1e-6) * 2 * math.pi
        pos_x = xs[:, None] / dim_t[None]
        pos_y = ys[:, None] / dim_t[None]
        pos_x = torch.stack([pos_x[:, 0::2].sin(), pos_x[:, 1::2].cos()],
                            2).reshape(w, -1)
        pos_y = torch.stack([pos_y[:, 0::2].sin(), pos_y[:, 1::2].cos()],
                            2).reshape(h, -1)
        grid = torch.cat([pos_y[:, None, :].expand(h, w, half),
                          pos_x[None, :, :].expand(h, w, half)], -1)
        outs.append(grid.reshape(h * w, dim))
    return torch.cat(outs, 0)


def coordinate_sine_embedding(coords: torch.Tensor, dim: int = 256,
                              temperature: float = 10000.0,
                              exchange_xy: bool = False) -> torch.Tensor:
    """DINO's get_sine_pos_embed of [..., n] coordinates -> [..., n * dim/2]
    (dim/2 features each, sin/cos interleaved). `exchange_xy` puts the
    second coordinate's block first: [pos(y), pos(x), ...]."""
    half = dim // 2
    dim_t = _dim_t(half, temperature, coords.device)
    x = coords[..., None] * 2 * math.pi / dim_t              # [..., n, half]
    emb = torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()],
                      -1).reshape(*coords.shape, half)
    if exchange_xy and coords.shape[-1] >= 2:
        emb = torch.cat([emb[..., 1:2, :], emb[..., 0:1, :],
                         emb[..., 2:, :]], -2)
    return emb.reshape(*coords.shape[:-1], coords.shape[-1] * half)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, 0.0, -1e9)


class MHA(nn.Module):
    """Multi-head attention with an optional additive bias."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads = heads
        self.q = Dense(dim, dim, dtype, device=device)
        self.k = Dense(dim, dim, dtype, device=device)
        self.v = Dense(dim, dim, dtype, device=device)
        self.out = Dense(dim, dim, dtype, device=device)

    def forward(self, q, k, v, bias: torch.Tensor | None = None
                ) -> torch.Tensor:
        b, nq, c = q.shape
        hd = c // self.heads
        qh = self.q(q).reshape(b, nq, self.heads, hd)
        kh = self.k(k).reshape(b, -1, self.heads, hd)
        vh = self.v(v).reshape(b, -1, self.heads, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", qh.float(),
                            kh.float()) / hd ** 0.5
        if bias is not None:
            attn = attn + bias
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.to(vh.dtype).float(),
                           vh.float()).reshape(b, nq, c)
        return self.out(out)


class BiAttentionBlock(nn.Module):
    """GLIP-style bi-directional image <-> text fusion with layer scale."""

    def __init__(self, dim: int = 256, fusion_dim: int = 1024, heads: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.fusion_dim = heads, fusion_dim
        self.ln_v = LayerNorm(dim, eps=1e-5, device=device)
        self.ln_l = LayerNorm(dim, eps=1e-5, device=device)
        for name in ("v_proj", "l_proj", "values_v", "values_l"):
            self.add_module(name, Dense(dim, fusion_dim, dtype, device=device))
        self.out_v = Dense(fusion_dim, dim, dtype, device=device)
        self.out_l = Dense(fusion_dim, dim, dtype, device=device)
        self.gamma_v = nn.Parameter(torch.empty(dim, device=device))
        self.gamma_l = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, img: torch.Tensor, txt: torch.Tensor,
                txt_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """img [B, S, C]; txt [B, T, C]; txt_mask [B, T] bool."""
        vi, li = self.ln_v(img), self.ln_l(txt)
        b, s, _ = vi.shape
        t = li.shape[1]
        hd = self.fusion_dim // self.heads
        qv = self.v_proj(vi).reshape(b, s, self.heads, hd)
        ql = self.l_proj(li).reshape(b, t, self.heads, hd)
        vv = self.values_v(vi).reshape(b, s, self.heads, hd)
        vl = self.values_l(li).reshape(b, t, self.heads, hd)
        attn = torch.einsum("bshd,bthd->bhst", qv.float(),
                            ql.float()) / hd ** 0.5
        attn = torch.where(txt_mask[:, None, None, :], attn, -1e9)
        # image -> text (softmax over the text) and text -> image (softmax
        # over the image tokens, taken on the transpose: a softmax over a
        # strided axis of 16,660 image tokens took 18 ms a layer on an H100).
        a_v = torch.softmax(attn, dim=-1)
        a_l = torch.softmax(attn.transpose(-1, -2), dim=-1)     # [B, H, T, S]
        dv = torch.einsum("bhst,bthd->bshd", a_v.to(vl.dtype).float(),
                          vl.float()).reshape(b, s, self.fusion_dim)
        dl = torch.einsum("bhts,bshd->bthd", a_l.to(vv.dtype).float(),
                          vv.float()).reshape(b, t, self.fusion_dim)
        # The residual adds onto the layer-normed streams (fuse_modules.py
        # BiAttentionBlock).
        return (vi + self.out_v(dv) * self.gamma_v,
                li + self.out_l(dl) * self.gamma_l)


class DeformableLayer(nn.Module):
    """Encoder image layer: deformable self-attention + FFN."""

    def __init__(self, dim: int = 256, heads: int = 8, points: int = 4,
                 levels: int = 4, ffn: int = 2048, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.points, self.levels = heads, points, levels
        self.value_proj = Dense(dim, dim, dtype, device=device)
        self.sampling_offsets = Dense(dim, heads * levels * points * 2, dtype,
                                      device=device)
        self.attention_weights = Dense(dim, heads * levels * points, dtype,
                                       device=device)
        self.output_proj = Dense(dim, dim, dtype, device=device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.ffn1 = Dense(dim, ffn, dtype, device=device)
        self.ffn2 = Dense(ffn, dim, dtype, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, x, pos, ref_points, spatial_shapes, level_wh):
        """x [B, S, C]; pos [S, C]; ref_points [S, L, 2]; level_wh [L, 2]
        each level's (w, h) as f32."""
        b, s, c = x.shape
        q = x + pos[None]
        value = self.value_proj(x).reshape(b, s, self.heads, c // self.heads)
        off = self.sampling_offsets(q).reshape(b, s, self.heads, self.levels,
                                               self.points, 2)
        attw = torch.softmax(self.attention_weights(q).reshape(
            b, s, self.heads, self.levels * self.points), dim=-1)
        attw = attw.reshape(b, s, self.heads, self.levels, self.points)
        loc = (ref_points[None, :, None, :, None, :]
               + off / level_wh[None, None, None, :, None, :])
        sampled = deformable_attention_core(value, spatial_shapes, loc, attw)
        x = self.norm1(x + self.output_proj(sampled))
        h = self.ffn2(F.relu(self.ffn1(x)))
        return self.norm2(x + h)


class TextEnhancerLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 4, ffn: int = 1024,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = MHA(dim, heads, dtype, device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.ffn1 = Dense(dim, ffn, dtype, device=device)
        self.ffn2 = Dense(ffn, dim, dtype, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, txt: torch.Tensor, txt_mask: torch.Tensor,
                pos: torch.Tensor | None = None) -> torch.Tensor:
        """txt [B, T, C]; txt_mask [B, T] padding mask or [B, T, T] pair
        mask; pos [B, T, C] sine embeddings of the position ids, added to q
        and k only."""
        if txt_mask.dim() == 3:
            bias = _mask_bias(txt_mask)[:, None]
        else:
            bias = _mask_bias(txt_mask)[:, None, None, :]
        q = txt if pos is None else txt + pos
        txt = self.norm1(txt + self.self_attn(q, q, txt, bias))
        h = self.ffn2(F.relu(self.ffn1(txt)))
        return self.norm2(txt + h)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, points: int = 4,
                 levels: int = 4, ffn: int = 2048, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.points, self.levels = heads, points, levels
        self.self_attn = MHA(dim, heads, dtype, device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.text_cross = MHA(dim, heads, dtype, device)
        self.norm_text = LayerNorm(dim, eps=1e-5, device=device)
        self.value_proj = Dense(dim, dim, dtype, device=device)
        self.sampling_offsets = Dense(dim, heads * levels * points * 2, dtype,
                                      device=device)
        self.attention_weights = Dense(dim, heads * levels * points, dtype,
                                       device=device)
        self.output_proj = Dense(dim, dim, dtype, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.ffn1 = Dense(dim, ffn, dtype, device=device)
        self.ffn2 = Dense(ffn, dim, dtype, device=device)
        self.norm3 = LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, tgt, query_pos, memory, txt, txt_mask, ref_points,
                spatial_shapes):
        """tgt [B, Q, C]; ref_points [B, Q, 4] (cx, cy, w, h) in sigmoid
        space."""
        b, nq, c = tgt.shape
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        h = self.text_cross(tgt + query_pos, txt, txt,
                            _mask_bias(txt_mask)[:, None, None, :])
        tgt = self.norm_text(tgt + h)
        value = self.value_proj(memory).reshape(b, -1, self.heads,
                                                c // self.heads)
        qd = tgt + query_pos
        off = self.sampling_offsets(qd).reshape(b, nq, self.heads,
                                                self.levels, self.points, 2)
        attw = torch.softmax(self.attention_weights(qd).reshape(
            b, nq, self.heads, self.levels * self.points), dim=-1)
        attw = attw.reshape(b, nq, self.heads, self.levels, self.points)
        # Offsets scaled by the reference box's size over the points.
        center = ref_points[:, :, None, None, None, :2]
        size = ref_points[:, :, None, None, None, 2:]
        loc = center + off / self.points * size * 0.5
        sampled = deformable_attention_core(value, spatial_shapes, loc, attw)
        tgt = self.norm2(tgt + self.output_proj(sampled))
        h = self.ffn2(F.relu(self.ffn1(tgt)))
        return self.norm3(tgt + h)


class BoxMLP(nn.Module):
    """`layers` f32 Dense layers of width `dim` with ReLUs between, from
    `in_dim` to `out`; the last one's kernel starts at zero."""

    def __init__(self, in_dim: int = 256, dim: int = 256, out: int = 4,
                 layers: int = 3, device=None):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"l{i}", Dense(
                in_dim if i == 0 else dim, out if i == layers - 1 else dim,
                torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"l{i}")(x))
        return getattr(self, f"l{self.layers - 1}")(x)
