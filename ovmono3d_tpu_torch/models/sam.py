"""SAM promptable segmentation in PyTorch: prompt encoder and two-way mask
decoder.

Counterpart of ovmono3d_tpu/models/sam.py (segment_anything's SamPredictor
path that OVMono3D-GEO runs: a box prompt in, three candidate masks and
their IoU scores out; the GEO pipeline takes mask index 2, the largest).
The image encoder is the SAM trunk of models/vit.py.

Everything is f32 with plain torch attention, as the JAX module's attention
is XLA code there. Unlike the JAX module, `SamSegmenter` takes one image's
embedding with all its boxes at once: every box's decoder math is
independent, so M boxes run as a batch of M.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import (ConvTranspose,
                                              init_flax_defaults)


class RandomFourierPE(nn.Module):
    """SAM's PositionEmbeddingRandom: coords in [0, 1]^2 -> [2F] features."""

    def __init__(self, num_feats: int = 128, device=None):
        super().__init__()
        self.gaussian_matrix = nn.Parameter(
            torch.empty(2, num_feats, device=device))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        x = (2.0 * coords - 1.0) @ self.gaussian_matrix * (2.0 * math.pi)
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.pe = RandomFourierPE(embed_dim // 2, device)
        self.point_embeddings = nn.Parameter(
            torch.empty(2, embed_dim, device=device))
        # Added to the image embedding when no mask prompt is given (the
        # predictor's box-only path always uses it).
        self.no_mask_embed = nn.Parameter(
            torch.empty(embed_dim, device=device))

    def forward(self, boxes: torch.Tensor, image_size: float) -> torch.Tensor:
        """boxes: [M, 4] xyxy in image pixels -> [M, 2, C] corner-point
        embeddings with their per-corner type embeddings."""
        tl = (boxes[:, 0:2] + 0.5) / image_size
        br = (boxes[:, 2:4] + 0.5) / image_size
        emb = torch.stack([self.pe(tl), self.pe(br)], dim=1)
        return emb + self.point_embeddings[None]

    def dense_pe(self, grid_hw: tuple[int, int]) -> torch.Tensor:
        """Positional encoding of the image grid: [h, w, C]."""
        h, w = grid_hw
        dev = self.pe.gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
        return self.pe(coords).reshape(h, w, self.embed_dim)


class _Attention(nn.Module):
    """The decoder's attention, with the inner width divided by
    `downsample`: softmax(q k^T / sqrt(d)) v over [B, N, C] tokens."""

    def __init__(self, dim: int, heads: int, downsample: int = 1,
                 device=None):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q = nn.Linear(dim, inner, device=device)
        self.k = nn.Linear(dim, inner, device=device)
        self.v = nn.Linear(dim, inner, device=device)
        self.out = nn.Linear(inner, dim, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        B, Nq, _ = q.shape
        qh = self.q(q).view(B, Nq, self.heads, -1)
        kh = self.k(k).view(B, k.shape[1], self.heads, -1)
        vh = self.v(v).view(B, v.shape[1], self.heads, -1)
        attn = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / math.sqrt(
            qh.shape[-1])
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, vh).reshape(B, Nq, -1)
        return self.out(out)


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, mlp_dim: int = 2048,
                 skip_first_pe: bool = False, device=None):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = _Attention(dim, heads, device=device)
        self.t2i = _Attention(dim, heads, 2, device)
        self.i2t = _Attention(dim, heads, 2, device)
        self.mlp1 = nn.Linear(dim, mlp_dim, device=device)
        self.mlp2 = nn.Linear(mlp_dim, dim, device=device)
        for i in range(1, 5):
            self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=1e-6,
                                                     device=device))

    def forward(self, tokens, image, token_pe, image_pe):
        # Self attention on the tokens; in the first layer its output
        # REPLACES the tokens (no residual).
        q = tokens if self.skip_first_pe else tokens + token_pe
        att = self.self_attn(q, q, tokens)
        tokens = self.norm1(att if self.skip_first_pe else tokens + att)
        # Token -> image cross attention.
        tokens = self.norm2(tokens + self.t2i(tokens + token_pe,
                                              image + image_pe, image))
        tokens = self.norm3(tokens + self.mlp2(F.relu(self.mlp1(tokens))))
        # Image -> token cross attention.
        image = self.norm4(image + self.i2t(image + image_pe,
                                            tokens + token_pe, tokens))
        return tokens, image


class MaskDecoder(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, depth: int = 2,
                 num_masks: int = 3, mlp_dim: int = 2048, device=None):
        super().__init__()
        self.depth = depth
        self.num_masks = num_masks
        self.iou_token = nn.Parameter(torch.empty(1, dim, device=device))
        self.mask_tokens = nn.Parameter(
            torch.empty(num_masks + 1, dim, device=device))
        for i in range(depth):
            self.add_module(f"block{i}", TwoWayBlock(
                dim, heads, mlp_dim, skip_first_pe=(i == 0), device=device))
        self.final_t2i = _Attention(dim, heads, 2, device)
        self.final_norm = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.up1 = ConvTranspose(dim, dim // 4, device=device)
        self.up_norm = nn.LayerNorm(dim // 4, eps=1e-6, device=device)
        self.up2 = ConvTranspose(dim // 4, dim // 8, device=device)
        for i in range(num_masks + 1):
            self.add_module(f"hyper{i}_l0", nn.Linear(dim, dim, device=device))
            self.add_module(f"hyper{i}_l1", nn.Linear(dim, dim, device=device))
            self.add_module(f"hyper{i}_out", nn.Linear(dim, dim // 8,
                                                       device=device))
        self.iou_l0 = nn.Linear(dim, dim, device=device)
        self.iou_l1 = nn.Linear(dim, dim, device=device)
        self.iou_out = nn.Linear(dim, num_masks + 1, device=device)

    def forward(self, image_feat: torch.Tensor, image_pe: torch.Tensor,
                prompt_tokens: torch.Tensor):
        """image_feat: [B, H, W, C]; image_pe: [H, W, C]; prompt_tokens:
        [B, P, C]. Returns (masks [B, num_masks, 4H, 4W], iou_pred
        [B, num_masks])."""
        B, H, W, C = image_feat.shape
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([out_tokens.expand(B, *out_tokens.shape),
                            prompt_tokens], dim=1)
        image = image_feat.reshape(B, H * W, C)
        pe = image_pe.reshape(1, H * W, C).expand(B, H * W, C)
        t, img = tokens, image
        for i in range(self.depth):
            t, img = getattr(self, f"block{i}")(t, img, tokens, pe)
        t = self.final_norm(t + self.final_t2i(t + tokens, img + pe, img))
        iou_out = t[:, 0]
        mask_out = t[:, 1:2 + self.num_masks]

        up = self.up_norm(self.up1(img.reshape(B, H, W, C)))
        up = F.gelu(self.up2(F.gelu(up)))             # [B, 4H, 4W, C/8]
        hyper = []
        for i in range(self.num_masks + 1):
            h = mask_out[:, i]
            h = F.relu(getattr(self, f"hyper{i}_l0")(h))
            h = F.relu(getattr(self, f"hyper{i}_l1")(h))
            hyper.append(getattr(self, f"hyper{i}_out")(h))
        masks = torch.einsum("bmc,bhwc->bmhw", torch.stack(hyper, dim=1), up)
        h = F.relu(self.iou_l1(F.relu(self.iou_l0(iou_out))))
        iou_pred = self.iou_out(h)
        # Slot 0 is the single-mask output; GEO uses the multimask slots.
        return masks[:, 1:], iou_pred[:, 1:]


class SamSegmenter(nn.Module):
    """Prompt encoder + mask decoder over a precomputed image embedding
    (SamPredictor.predict(box=...)): 3 candidate masks at 4x the embedding's
    resolution; callers upsample them to the image and take index 2."""

    def __init__(self, embed_dim: int = 256, decoder_mlp_dim: int = 2048,
                 device=None):
        super().__init__()
        self.prompt_encoder = PromptEncoder(embed_dim, device)
        self.mask_decoder = MaskDecoder(embed_dim, mlp_dim=decoder_mlp_dim,
                                        device=device)

    def forward(self, image_embed: torch.Tensor, boxes: torch.Tensor,
                image_size: float):
        """image_embed: [1, H, W, C] (one image, for all its boxes) or
        [M, H, W, C] (one per box); boxes: [M, 4] xyxy in pixels of the
        encoder's input. Returns (masks [M, 3, 4H, 4W], iou [M, 3])."""
        sparse = self.prompt_encoder(boxes, image_size)
        dense_pe = self.prompt_encoder.dense_pe(image_embed.shape[1:3])
        src = image_embed + self.prompt_encoder.no_mask_embed
        src = src.expand(boxes.shape[0], *src.shape[1:])
        return self.mask_decoder(src, dense_pe, sparse)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: the embeddings and tokens unit normals, the
        rest flax's defaults."""
        init_flax_defaults(self, generator)
        pe = self.prompt_encoder
        for p in (pe.pe.gaussian_matrix, pe.point_embeddings,
                  pe.no_mask_embed, self.mask_decoder.iou_token,
                  self.mask_decoder.mask_tokens):
            nn.init.normal_(p, 0.0, 1.0, generator=generator)
