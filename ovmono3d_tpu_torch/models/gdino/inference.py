"""GroundingDINO's open-vocabulary inference glue: prompts -> padded 2D
detections.

Counterpart of ovmono3d_tpu/models/gdino/inference.py (the reference's
grounding_dino_inference_detector, roi_heads_gdino.py:174-294): caption =
' . '.join(categories) -> tokens -> model -> sigmoid token logits [Q, 256]
-> per-phrase scores, the sum of each phrase's token probabilities -> the
best phrase is the score and class -> box threshold -> cxcywh to xyxy ->
class-agnostic NMS at 0.5 -> top-k. Fixed shapes on the device; the host
only builds token ids and spans.
"""
from __future__ import annotations

import numpy as np
import torch

from ovmono3d_tpu_torch.models.gdino.bert import build_subsentence_masks
from ovmono3d_tpu_torch.models.gdino.tokenizer import (BertTokenizer,
                                                       phrase_token_spans)
from ovmono3d_tpu_torch.ops.nms import nms_mask_parallel, stable_topk

BOX_THRESHOLD = 0.001   # roi_heads_gdino.py:148
NMS_THRESHOLD = 0.5     # roi_heads_gdino.py:254


def build_text_inputs(tok: BertTokenizer, categories: list[str],
                      max_len: int = 256, max_phrases: int = 64) -> dict:
    """Host-side prompt prep. Returns numpy arrays: input_ids [1, T],
    text_mask [1, T], text_self_mask [1, T, T], position_ids [1, T],
    span_matrix [P, T] (row c: the indicator of category c's tokens) and
    span_valid [P]."""
    if len(categories) > max_phrases:
        raise ValueError(
            f"{len(categories)} categories > max_phrases={max_phrases}; pass "
            "max_phrases=len(categories) (dropping the rest would zero their "
            "detections)")
    ids, spans = phrase_token_spans(tok, categories, max_len)
    n = len(ids)
    input_ids = np.full((1, max_len), tok.pad_id, np.int32)
    input_ids[0, :n] = ids
    text_mask = np.zeros((1, max_len), bool)
    text_mask[0, :n] = True
    self_mask, position_ids = build_subsentence_masks(
        input_ids, special_ids=(tok.cls_id, tok.sep_id, tok.period_id,
                                tok.question_id))
    span_matrix = np.zeros((max_phrases, max_len), np.float32)
    span_valid = np.zeros((max_phrases,), bool)
    for c, span in enumerate(spans[:max_phrases]):
        span_matrix[c, span] = 1.0
        span_valid[c] = len(span) > 0
    return {"input_ids": input_ids, "text_mask": text_mask,
            "text_self_mask": self_mask, "position_ids": position_ids,
            "span_matrix": span_matrix, "span_valid": span_valid}


def postprocess_grounding(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                          span_matrix: torch.Tensor, span_valid: torch.Tensor,
                          im_hw: tuple[float, float], topk: int = 100,
                          box_threshold: float = BOX_THRESHOLD,
                          nms_threshold: float = NMS_THRESHOLD):
    """Token logits [Q, T] and boxes [Q, 4] (cxcywh, normalized) of one
    image -> (boxes [k, 4] xyxy in pixels of an image of `im_hw` (h, w),
    scores [k], classes [k] int32, valid [k]), k = min(topk, Q). f32 (keep
    TF32 off on the card: the JAX package pins Precision.HIGHEST here)."""
    probs = torch.sigmoid(pred_logits)
    phrase_logits = probs @ span_matrix.T                     # [Q, P] sums
    phrase_logits = torch.where(span_valid[None, :], phrase_logits, -1e9)
    scores, classes = phrase_logits.max(dim=1)
    h, w = im_hw
    cx, cy = pred_boxes[:, 0] * w, pred_boxes[:, 1] * h
    bw, bh = pred_boxes[:, 2] * w, pred_boxes[:, 3] * h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        -1)
    valid = scores > box_threshold
    keep = nms_mask_parallel(boxes, scores, nms_threshold, valid)
    masked = torch.where(keep, scores, torch.finfo(scores.dtype).min)
    top_scores, idx = stable_topk(masked, min(topk, masked.shape[0]))
    out_valid = top_scores > box_threshold
    return (boxes[idx], torch.where(out_valid, top_scores, 0.0),
            classes[idx].to(torch.int32), out_valid)
