"""GroundingDINO's spans and selected query indices, and the stream's row
capture, at a tiny size on the CPU: the detector's spans open in order
under `trace.recording()`, the returned `query_index` is `stable_topk` of
the encoder scores (recomputed from the encoder's output and the enhanced
text), a `predict_stream` whose rows are captured yields Detections bit
for bit those of one without, its captures holding what the row computed,
and the postprocess of a batch is that of each of its rows.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.eval.oracle2d import category_tokenizer
from ovmono3d_tpu_torch.models import ovmono3d as tov
from ovmono3d_tpu_torch.models.gdino.inference import (build_text_inputs,
                                                       postprocess_grounding)
from ovmono3d_tpu_torch.ops.nms import stable_topk
from ovmono3d_tpu_torch.utils import trace

torch.set_num_threads(2)

CATS = ["chair", "cup", "traffic cone", "night stand"]
GDINO = dict(hidden_dim=32, nheads=2, enc_layers=2, dec_layers=2,
             num_queries=16, enc_points=2, dec_points=2, max_text_len=32,
             ffn_dim=64, swin_embed_dim=8, swin_depths=(1, 2, 1, 1),
             swin_heads=(1, 2, 4, 8), swin_window=4, bert_layers=1,
             bert_hidden=32, bert_heads=2, bert_intermediate=64,
             bert_vocab=64, compute_dtype=torch.float32)
SIDE = 112


def _config() -> tcfg.Config:
    cfg = tcfg.Config()
    bb = dataclasses.replace(cfg.model.backbone, embed_dim=32, depth=1,
                             num_heads=2, patch_size=14, pretrain_grid=8,
                             out_channels=32, square_pad=SIDE)
    model = dataclasses.replace(
        cfg.model, backbone=bb, num_classes=5,
        roi_box=dataclasses.replace(cfg.model.roi_box, fc_dim=32),
        cube=dataclasses.replace(cfg.model.cube, fc_dim=32))
    return dataclasses.replace(cfg, model=model, input=dataclasses.replace(
        cfg.input, min_size_test=84, max_size_test=SIDE))


@pytest.fixture(scope="module")
def pipe():
    return tov.OVMono3DLift.build(_config(), category_tokenizer(CATS),
                                  gdino_kwargs=GDINO, device="cpu", seed=3)


def _inputs(pipe, seed=0):
    tok = pipe.tokenizer
    text = build_text_inputs(tok, CATS, max_len=GDINO["max_text_len"])
    image = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, SIDE, SIDE, 3)).astype(np.float32))
    return image, tuple(torch.from_numpy(text[k]) for k in (
        "input_ids", "text_mask", "text_self_mask", "position_ids"))


def test_spans_open_in_order(pipe):
    image, (ids, mask, self_mask, pos) = _inputs(pipe)
    with trace.recording() as got, torch.inference_mode():
        pipe.gdino(image, ids.long(), mask, self_mask, pos.long())
    rows = trace.read(got)
    names = [r["name"] for r in rows]
    enc, dec = GDINO["enc_layers"], GDINO["dec_layers"]
    assert names == (["gdino.bert", "gdino.swin", "gdino.encoder"]
                     + ["gdino.deformable"] * enc + ["gdino.decoder"]
                     + ["gdino.deformable"] * dec)
    ids_of = {r["name"]: r["id"] for r in rows
              if r["name"] != "gdino.deformable"}
    parents = [r["parent"] for r in rows if r["name"] == "gdino.deformable"]
    assert parents == ([ids_of["gdino.encoder"]] * enc
                       + [ids_of["gdino.decoder"]] * dec)


def test_query_index_is_the_top_of_the_encoder_scores(pipe):
    model = pipe.gdino
    image, (ids, mask, self_mask, pos) = _inputs(pipe, seed=1)
    seen = {}
    hooks = [model.enc_output_norm.register_forward_hook(
        lambda m, a, out: seen.__setitem__("memory", out)),
        getattr(model, f"text_enh{GDINO['enc_layers'] - 1}")
        .register_forward_hook(lambda m, a, out: seen.__setitem__("text",
                                                                  out))]
    try:
        with torch.inference_mode():
            out = model(image, ids.long(), mask, self_mask, pos.long())
    finally:
        for h in hooks:
            h.remove()
    text = torch.where(mask[..., None], seen["text"], 0.0)
    scores = torch.where(mask[:, None, :], torch.einsum(
        "bsc,btc->bst", seen["memory"], text), -1e9).amax(-1)
    want = stable_topk(scores, GDINO["num_queries"])[1]
    assert out["query_index"].shape == (1, GDINO["num_queries"])
    assert torch.equal(out["query_index"], want)


def test_captured_stream_equals_the_plain_stream(pipe):
    rng = np.random.default_rng(5)
    items = [((rng.random((h, w, 3)) * 255).astype(np.uint8),
              tov.default_focal_K(h, w))
             for h, w in ((120, 160), (112, 112), (150, 100))]
    plain = list(pipe.predict_stream(items, CATS, chunk=2))
    caps = {}
    captured = list(pipe.predict_stream(
        items, CATS, chunk=2,
        capture=lambda i: caps.setdefault(i, {}) if i != 1 else None))
    assert sorted(caps) == [0, 2]
    for got, want in zip(captured, plain):
        for (k, g), (_, w) in zip(got.items(), want.items()):
            assert torch.equal(g, w), k
    for i, cap in caps.items():
        assert cap["canvas"].shape == (SIDE, SIDE, 3)
        assert cap["K"].shape == (1, 3, 3) and cap["hw"].shape == (1, 2)
        assert cap["query_index"].shape == (GDINO["num_queries"],)
        assert cap["pred_boxes"].shape == (GDINO["num_queries"], 4)
        assert cap["text_features"].shape == (32, GDINO["hidden_dim"])
        assert cap["memory"].ndim == 2
        assert cap["memory"].shape[1] == GDINO["hidden_dim"]
        assert cap["hs"].shape == (GDINO["num_queries"], GDINO["hidden_dim"])
        slots = cap["slots"]
        assert torch.equal(slots["valid"].cpu(), captured[i].valid)
        assert torch.equal(slots["scores"].cpu() > 0, captured[i].valid)


def test_postprocess_of_a_batch_is_that_of_each_row():
    """Three images' raw outputs [3, Q, T] at once against each alone: the
    same slots, classes and validity, boxes and scores to 1e-6 (the phrase
    sums are one product over the batch); the boxes overlap, so NMS
    suppresses."""
    g = torch.Generator().manual_seed(4)
    Q, T, P = 40, 32, 6
    logits = torch.randn(3, Q, T, generator=g) * 3
    boxes = torch.cat([0.3 + 0.4 * torch.rand(3, Q, 2, generator=g),
                       0.3 + 0.1 * torch.rand(3, Q, 2, generator=g)], -1)
    span = (torch.rand(P, T, generator=g) < 0.1).float()
    valid = torch.tensor([True] * 5 + [False])
    got = postprocess_grounding(logits, boxes, span, valid, (80.0, 96.0),
                                topk=16)
    assert got[3].any() and not got[3].all()
    for i in range(3):
        want = postprocess_grounding(logits[i], boxes[i], span, valid,
                                     (80.0, 96.0), topk=16)
        assert torch.equal(got[2][i], want[2])
        assert torch.equal(got[3][i], want[3])
        torch.testing.assert_close(got[0][i], want[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[1][i], want[1], rtol=1e-6, atol=1e-6)
