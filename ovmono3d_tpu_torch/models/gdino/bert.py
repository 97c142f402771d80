"""BERT-base text encoder in PyTorch: GroundingDINO's language trunk.

Counterpart of ovmono3d_tpu/models/gdino/bert.py (the `bert-base-uncased`
encoder GroundingDINO runs through HF transformers). f32 throughout, as the
JAX module is: LayerNorm eps 1e-12, erf GELU, and an additive pair mask of
-1e9. GroundingDINO feeds a sub-sentence mask that keeps each category
phrase between '.' separators to itself, with position ids restarting at
every phrase (`build_subsentence_masks`, host-side numpy).

Submodules carry the JAX package's parameter names (`word_embeddings`,
`layer0.q`, `layer0.attn_norm`, ...) for utils/flax_bridge.py.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import (Dense, LayerNorm,
                                              init_flax_defaults)


def init_embeddings(module: nn.Module, generator: torch.Generator) -> None:
    """flax nn.Embed's default init over every Embedding of `module`: a
    normal of variance 1 / embedding width, truncated at two std."""
    for mod in module.modules():
        if isinstance(mod, nn.Embedding):
            std = mod.embedding_dim ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)


class BertLayer(nn.Module):
    def __init__(self, hidden: int = 768, heads: int = 12,
                 intermediate: int = 3072, dtype=torch.float32, device=None):
        super().__init__()
        self.heads = heads
        self.q = Dense(hidden, hidden, dtype, device=device)
        self.k = Dense(hidden, hidden, dtype, device=device)
        self.v = Dense(hidden, hidden, dtype, device=device)
        self.attn_out = Dense(hidden, hidden, dtype, device=device)
        self.attn_norm = LayerNorm(hidden, eps=1e-12, device=device)
        self.inter = Dense(hidden, intermediate, dtype, device=device)
        self.out = Dense(intermediate, hidden, dtype, device=device)
        self.out_norm = LayerNorm(hidden, eps=1e-12, device=device)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor
                ) -> torch.Tensor:
        """x [B, N, C]; attn_bias [B, N, N] f32 additive."""
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = (f(x).reshape(b, n, self.heads, hd)
                   for f in (self.q, self.k, self.v))
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(),
                            k.float()) / hd ** 0.5
        attn = torch.softmax(attn + attn_bias[:, None], dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype).float(),
                           v.float()).reshape(b, n, c)
        x = self.attn_norm(x + self.attn_out(out))
        h = self.out(F.gelu(self.inter(x)))
        return self.out_norm(x + h)


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_position: int = 512, type_vocab: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.layers = layers
        self.word_embeddings = nn.Embedding(vocab_size, hidden, device=device)
        self.position_embeddings = nn.Embedding(max_position, hidden,
                                                device=device)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden,
                                                  device=device)
        self.embed_norm = LayerNorm(hidden, eps=1e-12, device=device)
        for i in range(layers):
            self.add_module(f"layer{i}", BertLayer(hidden, heads, intermediate,
                                                   dtype, device))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids [B, N]; attention_mask [B, N] valid tokens or [B, N, N]
        pair mask (bool); position_ids [B, N] or None for 0..N-1."""
        n = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(n, device=input_ids.device)[None]
        x = self.embed_norm(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids)
                            + self.token_type_embeddings(
                                torch.zeros_like(input_ids)))
        if attention_mask.dim() == 2:
            pair = attention_mask[:, None, :] & attention_mask[:, :, None]
        else:
            pair = attention_mask
        bias = torch.where(pair, 0.0, -1e9)
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x, bias)
        return x

    def init_weights(self, generator: torch.Generator) -> None:
        init_flax_defaults(self, generator)
        init_embeddings(self, generator)


def build_subsentence_masks(input_ids, special_ids=(101, 102, 1012, 1029)):
    """GroundingDINO's generate_masks_with_special_tokens_and_transfer_map
    (host-side numpy, a copy of the JAX package's): tokens between special
    tokens ([CLS], [SEP], '.', '?') attend only within their own phrase;
    every token attends to itself; each phrase span is a dense block whose
    position ids restart at 0 (special tokens at column 0 or the last column
    reset to self-only, every other special token closes the block
    [prev + 1, col]; PAD is not a delimiter: padding rows keep only the
    diagonal).

    Returns (attn_mask [B, N, N] bool, position_ids [B, N] int32)."""
    ids = np.asarray(input_ids)
    b_count, n = ids.shape
    special = np.isin(ids, np.asarray(special_ids))
    attn = np.zeros((b_count, n, n), bool)
    attn[:, np.arange(n), np.arange(n)] = True
    pos = np.zeros((b_count, n), np.int64)
    for b in range(b_count):
        prev = 0
        for col in np.where(special[b])[0]:
            if col == 0 or col == n - 1:
                attn[b, col, col] = True
                pos[b, col] = 0
            else:
                attn[b, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[b, prev + 1:col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos.astype(np.int32)
