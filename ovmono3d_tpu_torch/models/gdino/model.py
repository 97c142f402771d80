"""GroundingDINO in PyTorch: Swin-B + BERT + cross-modality deformable DETR.

Counterpart of ovmono3d_tpu/models/gdino/model.py, the reference's SwinB
configuration (configs/GroundingDINO_SwinB_cfg.py): 4 feature levels (Swin
stages 1-3 projected to 256 plus one stride-2 extra level), 6 enhancer
layers (fusion, text enhancer, image deformable), the standard two-stage
query selection (the top 900 encoder tokens by their best text logit), 6
decoder layers with text cross-attention, contrastive classification against
the projected text features, and iterative box refinement in sigmoid space.

Outputs raw `pred_logits` [B, Q, max_text_len] and `pred_boxes` [B, Q, 4]
(cx, cy, w, h normalized), the contract the inference glue reads, the
selection's `query_index` [B, Q] (the encoder tokens the queries start
from), so that a check can hold a reference to the same discrete choice,
the prompt's `text_features` [B, T, C] (BERT mapped to the width, the
f32 island every later text product reads), the encoder's output
`memory` [B, S, C] (the image tokens the selection and the decoder read)
and the decoder's normed output `hs` [B, Q, C] (what the logits and boxes
are read from).

Spans (`utils/trace.py`): `gdino.bert`, `gdino.swin`, `gdino.encoder` (the
six enhancer layers), `gdino.decoder` (the query selection, the decoder and
the heads) and, inside the last two, `gdino.deformable` around each
deformable sampling call.

The heavy layers compute in `compute_dtype` (bf16 when serving); BERT, the
input projections, the heads and the logits are f32. The two f32 logit
products are the JAX package's Precision.HIGHEST: on the card keep
torch.backends.cuda.matmul.allow_tf32 False. The top-900 selection breaks
ties by the lower index, as jax.lax.top_k does (`stable_topk`).

Submodules carry the JAX package's parameter names (`backbone`, `bert`,
`input_proj0`, `fusion0`, `dec0`, `level_embed`, `tgt_embed`, ...) for
utils/flax_bridge.py.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.gdino.bert import BertEncoder, init_embeddings
from ovmono3d_tpu_torch.models.gdino.deformable import make_reference_points
from ovmono3d_tpu_torch.models.gdino.swin import SwinTransformer
from ovmono3d_tpu_torch.models.gdino.transformer import (
    BiAttentionBlock, BoxMLP, DecoderLayer, DeformableLayer,
    TextEnhancerLayer, coordinate_sine_embedding, inverse_sigmoid,
    sine_position_embedding)
from ovmono3d_tpu_torch.models.layers import (Conv, Dense, GroupNorm,
                                              init_flax_defaults)
from ovmono3d_tpu_torch.ops.nms import stable_topk
from ovmono3d_tpu_torch.utils.device import device_constant
from ovmono3d_tpu_torch.utils.trace import span


class GroundingDINO(nn.Module):
    def __init__(self, hidden_dim: int = 256, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6,
                 num_queries: int = 900, num_levels: int = 4,
                 enc_points: int = 4, dec_points: int = 4,
                 max_text_len: int = 256, ffn_dim: int = 2048,
                 swin_embed_dim: int = 128, swin_depths=(2, 2, 18, 2),
                 swin_heads=(4, 8, 16, 32), swin_window: int = 12,
                 bert_layers: int = 12, bert_hidden: int = 768,
                 bert_heads: int = 12, bert_intermediate: int = 3072,
                 bert_vocab: int = 30522, bert_max_position: int = 512,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        if num_levels != 4:
            raise ValueError("GroundingDINO builds 3 Swin levels and one "
                             f"extra level; num_levels={num_levels}")
        c = hidden_dim
        self.hidden_dim, self.num_queries = hidden_dim, num_queries
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.max_text_len, self.swin_window = max_text_len, swin_window
        self.backbone = SwinTransformer(swin_embed_dim, swin_depths,
                                        swin_heads, swin_window,
                                        dtype=compute_dtype, device=device)
        self.bert = BertEncoder(bert_vocab, bert_hidden, bert_layers,
                                bert_heads, bert_intermediate,
                                bert_max_position, device=device)
        self.feat_map = Dense(bert_hidden, c, torch.float32, device=device)
        for i in range(3):
            self.add_module(f"input_proj{i}", Conv(
                swin_embed_dim * 2 ** (i + 1), c, 1, device=device))
            self.add_module(f"input_proj_norm{i}",
                            GroupNorm(32, c, eps=1e-5, device=device))
        self.extra_proj = Conv(swin_embed_dim * 8, c, 3, stride=2, padding=1,
                               device=device)
        self.extra_norm = GroupNorm(32, c, eps=1e-5, device=device)
        self.level_embed = nn.Parameter(torch.empty(num_levels, c,
                                                    device=device))
        for i in range(enc_layers):
            self.add_module(f"fusion{i}", BiAttentionBlock(
                c, dtype=compute_dtype, device=device))
            self.add_module(f"text_enh{i}", TextEnhancerLayer(
                c, dtype=compute_dtype, device=device))
            self.add_module(f"img_enc{i}", DeformableLayer(
                c, nheads, enc_points, num_levels, ffn_dim,
                dtype=compute_dtype, device=device))
        self.enc_output = Dense(c, c, torch.float32, device=device)
        self.enc_output_norm = nn.LayerNorm(c, eps=1e-5, device=device)
        self.enc_bbox_head = BoxMLP(c, c, device=device)
        self.tgt_embed = nn.Parameter(torch.empty(num_queries, c,
                                                  device=device))
        self.ref_point_head = BoxMLP(2 * c, c, out=c, layers=2,
                                     device=device)
        for i in range(dec_layers):
            self.add_module(f"dec{i}", DecoderLayer(
                c, nheads, dec_points, num_levels, ffn_dim,
                dtype=compute_dtype, device=device))
        self.decoder_norm = nn.LayerNorm(c, eps=1e-5, device=device)
        self.bbox_head = BoxMLP(c, c, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: lecun-normal kernels and zero biases, unit
        norms, the Embeds' and the Swin tables' own, level and query
        embeddings ~N(0, 1), the fusion layer scales at 1e-4, and zeros for
        the deformable offset and weight kernels and every box MLP's last
        kernel."""
        init_flax_defaults(self, generator)
        init_embeddings(self, generator)
        self.backbone.init_weights(generator)
        nn.init.normal_(self.level_embed, 0.0, 1.0, generator=generator)
        nn.init.normal_(self.tgt_embed, 0.0, 1.0, generator=generator)
        for i in range(self.enc_layers):
            fusion = getattr(self, f"fusion{i}")
            nn.init.constant_(fusion.gamma_v, 1e-4)
            nn.init.constant_(fusion.gamma_l, 1e-4)
        deform = [getattr(self, f"img_enc{i}") for i in range(self.enc_layers)]
        deform += [getattr(self, f"dec{i}") for i in range(self.dec_layers)]
        for layer in deform:
            nn.init.zeros_(layer.sampling_offsets.weight)
            nn.init.zeros_(layer.attention_weights.weight)
        for head in (self.enc_bbox_head, self.ref_point_head,
                     self.bbox_head):
            nn.init.zeros_(getattr(head, f"l{head.layers - 1}").weight)

    def encode_text(self, input_ids, text_mask, self_attn_mask=None,
                    position_ids=None) -> torch.Tensor:
        """input_ids [B, T]; text_mask [B, T]; optional [B, T, T]
        sub-sentence mask and per-span position ids -> [B, T, C]."""
        mask = self_attn_mask if self_attn_mask is not None else text_mask
        return self.feat_map(self.bert(input_ids, mask, position_ids))

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                text_mask: torch.Tensor,
                text_self_mask: torch.Tensor | None = None,
                text_position_ids: torch.Tensor | None = None,
                rel_biases: dict[str, torch.Tensor] | None = None) -> dict:
        """images [B, H, W, 3] normalized, H and W multiples of 32. Returns
        {"pred_logits": [B, Q, max_text_len] raw, "pred_boxes": [B, Q, 4],
        "query_index": [B, Q] the selected encoder tokens, "text_features":
        [B, T, C] the encoded prompt, "memory": [B, S, C] the encoder's
        output, "hs": [B, Q, C] the decoder's normed output}.
        `rel_biases` are the Swin biases (`backbone.rel_biases()`, on the
        images' device); None takes them from the trunk's cache without
        gradients, and expands them in the forward with gradients."""
        b = images.shape[0]
        dev = images.device
        c = self.hidden_dim
        with span("gdino.bert"):
            txt = self.encode_text(input_ids, text_mask, text_self_mask,
                                   text_position_ids)
        t = txt.shape[1]
        with span("gdino.swin"):
            if rel_biases is None and not torch.is_grad_enabled():
                rel_biases = self.backbone.rel_biases()
            feats = self.backbone(images, rel_biases)
        srcs = [getattr(self, f"input_proj_norm{i}")(
                    getattr(self, f"input_proj{i}")(feats[key]))
                for i, key in enumerate(("s1", "s2", "s3"))]
        srcs.append(self.extra_norm(self.extra_proj(feats["s3"])))
        shapes = [(s.shape[1], s.shape[2]) for s in srcs]
        src = torch.cat([s.reshape(b, -1, c) for s in srcs], 1)   # [B, S, C]
        lvl = torch.cat([self.level_embed[i].expand(h * w, c)
                         for i, (h, w) in enumerate(shapes)])
        pos = sine_position_embedding(shapes, c, device=dev) + lvl
        refs = make_reference_points(shapes, dev)
        level_wh = device_constant(tuple((w, h) for h, w in shapes), dev)

        # Feature enhancer. The text layers' q/k get sine embeddings of the
        # per-span position ids, and their self-attention the sub-sentence
        # mask.
        pos_ids = (text_position_ids if text_position_ids is not None
                   else torch.arange(t, device=dev)[None])
        text_pos = coordinate_sine_embedding(pos_ids[..., None].float(),
                                             2 * c)
        enh_mask = text_self_mask if text_self_mask is not None else text_mask
        img, text = src, txt
        with span("gdino.encoder"):
            for i in range(self.enc_layers):
                img, text = getattr(self, f"fusion{i}")(img, text, text_mask)
                text = getattr(self, f"text_enh{i}")(text, enh_mask, text_pos)
                img = getattr(self, f"img_enc{i}")(img, pos, refs, shapes,
                                                   level_wh)
        memory = img
        with span("gdino.decoder"):
            out = self._select_and_decode(memory, text, text_mask, refs,
                                          shapes)
        out["text_features"] = txt
        out["memory"] = memory
        return out

    def _select_and_decode(self, memory, text, text_mask, refs, shapes
                           ) -> dict:
        """The two-stage query selection, the decoder and the heads over
        the enhanced memory [B, S, C] and text [B, T, C]."""
        b, _, c = memory.shape
        dev = memory.device

        # Two-stage query selection. Proposals at every token's centre with
        # a per-level size; those with a coordinate outside (0.01, 0.99)
        # get zeroed memory and +inf box logits (sigmoid 1).
        wh = torch.cat([torch.full((h * w, 2), 0.05 * 2.0 ** i, device=dev)
                        for i, (h, w) in enumerate(shapes)])
        prop = torch.cat([refs[:, 0, :], wh], -1)                 # [S, 4]
        prop_valid = ((prop > 0.01) & (prop < 0.99)).all(-1)
        mem_masked = torch.where(prop_valid[None, :, None], memory, 0.0)
        out_mem = self.enc_output_norm(self.enc_output(mem_masked))
        txt_masked = torch.where(text_mask[..., None], text, 0.0)
        enc_logits = torch.einsum("bsc,btc->bst", out_mem, txt_masked)
        enc_logits = torch.where(text_mask[:, None, :], enc_logits, -1e9)
        enc_scores = enc_logits.amax(-1)                          # [B, S]
        delta = self.enc_bbox_head(out_mem)
        prop_logits = torch.where(prop_valid[:, None], inverse_sigmoid(prop),
                                  torch.inf)
        boxes_all = torch.sigmoid(prop_logits[None] + delta)
        _, top_idx = stable_topk(enc_scores, self.num_queries)   # [B, Q]
        ref = torch.gather(boxes_all, 1,
                           top_idx[..., None].expand(b, self.num_queries, 4))
        tgt = self.tgt_embed[None].expand(b, self.num_queries, c)

        # Decoder. The in-loop refinement reads the raw layer output; the
        # final boxes come from the normed state plus the reference that
        # entered the last layer.
        ref_in = ref
        for i in range(self.dec_layers):
            query_pos = self.ref_point_head(
                coordinate_sine_embedding(ref, c, exchange_xy=True))
            tgt = getattr(self, f"dec{i}")(tgt, query_pos, memory, text,
                                           text_mask, ref, shapes)
            ref_in = ref
            ref = torch.sigmoid(inverse_sigmoid(ref) + self.bbox_head(tgt))
        hs = self.decoder_norm(tgt)
        out_boxes = torch.sigmoid(self.bbox_head(hs) + inverse_sigmoid(ref_in))
        logits = torch.einsum("bqc,btc->bqt", hs, txt_masked)
        logits = torch.where(text_mask[:, None, :], logits, -1e9)
        pad = self.max_text_len - logits.shape[-1]
        if pad > 0:
            logits = F.pad(logits, (0, pad), value=-1e9)
        elif pad < 0:
            logits = logits[..., :self.max_text_len]
        return {"pred_logits": logits, "pred_boxes": out_boxes,
                "query_index": top_idx, "hs": hs}
