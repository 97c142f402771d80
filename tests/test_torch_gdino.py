"""The port's GroundingDINO against the JAX package's at matched weights, on
the CPU: the tokenizer copy, the prompt inputs and sub-sentence masks, BERT,
the deformable attention core, the sine embeddings, every transformer layer,
the tiny GroundingDINO's raw outputs (the sizes of
tests/test_ovmono3d_lift.py) and the postprocess on identical raw outputs.

Weights are the JAX modules' inits redrawn from numpy seeds (flax starts the
deformable offsets and weights, the box heads' last layers and the fusion
layer scales at zero or 1e-4, which would leave their paths unchecked), then
loaded into the port through utils/flax_bridge.py. Everything is f32 unless
a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmono3d_tpu.models.gdino import bert as jbert
from ovmono3d_tpu.models.gdino import deformable as jdeform
from ovmono3d_tpu.models.gdino import inference as jinf
from ovmono3d_tpu.models.gdino import tokenizer as jtok
from ovmono3d_tpu.models.gdino import transformer as jtr
from ovmono3d_tpu.models.gdino.model import GroundingDINO as JaxGroundingDINO
from ovmono3d_tpu_torch.models.gdino import bert as tbert
from ovmono3d_tpu_torch.models.gdino import deformable as tdeform
from ovmono3d_tpu_torch.models.gdino import inference as tinf
from ovmono3d_tpu_torch.models.gdino import tokenizer as ttok
from ovmono3d_tpu_torch.models.gdino import transformer as ttr
from ovmono3d_tpu_torch.models.ovmono3d import build_gdino
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

torch.set_num_threads(2)

VOCAB = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, ".": 4, "?": 5,
         "chair": 6, "cup": 7, "laptop": 8, "traffic": 9, "cone": 10,
         "##s": 11, "shoe": 12, "cereal": 13, "box": 14, "bicycle": 15}
CATEGORIES = ["chair", "Cup", "traffic cone", "shoes", "cereal box",
              "bicycle", "unicorn"]
GDINO_KWARGS = dict(
    hidden_dim=32, nheads=2, enc_layers=1, dec_layers=1, num_queries=16,
    enc_points=2, dec_points=2, max_text_len=32, ffn_dim=64,
    swin_embed_dim=8, swin_depths=(1, 1, 1, 1), swin_heads=(1, 2, 4, 8),
    swin_window=4, bert_layers=1)


def _t(x):
    return torch.from_numpy(np.array(x))


def redraw(params, seed: int, std: float = 0.2):
    """Every leaf redrawn from a numpy seed: scales ~1 + N(0, std^2) (the
    LayerNorm and GroupNorm scales), everything else ~N(0, std^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        noise = rng.standard_normal(np.shape(x)).astype(np.float32) * std
        return noise + 1.0 if getattr(path[-1], "key", "") == "scale" \
            else noise

    return jax.tree_util.tree_map_with_path(draw, params)


def _pair(jax_module, port_module, *inputs, seed=0, static=()):
    """Init the JAX module on `inputs` (numpy; `static` python values passed
    after them), redraw its weights, load them into the port module, and
    return (JAX outputs, port outputs)."""
    params = redraw(jax.jit(lambda key, *a: jax_module.init(key, *a, *static))(
        jax.random.PRNGKey(seed), *map(jnp.asarray, inputs)), seed + 1)
    want = jax.jit(lambda p, *a: jax_module.apply(p, *a, *static))(
        params, *map(jnp.asarray, inputs))
    load_flax_params(port_module, params)
    with torch.inference_mode():
        got = port_module(*map(_t, inputs), *static)
    return want, got


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=tol, atol=tol)


# -- tokenizer and prompts -------------------------------------------------


@pytest.mark.parametrize("text", [
    "chair . cup .", "Traffic Cones, shoes?", "café  au\tlait", "unicorn",
    "x" * 120, "数学 chair"])
def test_tokenizer_copy_matches_jax(text):
    mine, theirs = ttok.BertTokenizer(VOCAB), jtok.BertTokenizer(VOCAB)
    assert mine.tokenize_ids(text) == theirs.tokenize_ids(text)
    assert mine.encode(text, 16) == theirs.encode(text, 16)


def test_caption_and_spans_match_jax():
    tok = ttok.BertTokenizer(VOCAB)
    assert ttok.build_caption(CATEGORIES) == jtok.build_caption(CATEGORIES)
    assert ttok.phrase_token_spans(tok, CATEGORIES) == \
        jtok.phrase_token_spans(jtok.BertTokenizer(VOCAB), CATEGORIES)
    with pytest.raises(ValueError, match="max_text_len"):
        ttok.phrase_token_spans(tok, CATEGORIES, max_len=8)


def test_text_inputs_match_jax():
    mine = tinf.build_text_inputs(ttok.BertTokenizer(VOCAB), CATEGORIES, 32,
                                  max_phrases=8)
    theirs = jinf.build_text_inputs(jtok.BertTokenizer(VOCAB), CATEGORIES,
                                    32, max_phrases=8)
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        np.testing.assert_array_equal(mine[key], theirs[key])
    with pytest.raises(ValueError, match="max_phrases"):
        tinf.build_text_inputs(ttok.BertTokenizer(VOCAB), CATEGORIES,
                               max_phrases=3)


# -- BERT -------------------------------------------------------------------


def test_bert_with_subsentence_masks_matches_jax():
    kw = dict(vocab_size=16, hidden=32, layers=2, heads=2, intermediate=64,
              max_position=40)
    text = jinf.build_text_inputs(jtok.BertTokenizer(VOCAB), CATEGORIES, 32)
    ids, mask, pos = (text["input_ids"], text["text_self_mask"],
                      text["position_ids"])
    assert pos.max() > 0 and not mask.all()
    want, got = _pair(jbert.BertEncoder(**kw), tbert.BertEncoder(**kw), ids,
                      mask, pos)
    _close(got, want, 1e-4)


def test_bert_padding_mask_matches_jax():
    kw = dict(vocab_size=16, hidden=32, layers=1, heads=4, intermediate=64,
              max_position=40)
    ids = np.random.default_rng(2).integers(0, 16, (2, 12)).astype(np.int32)
    valid = np.arange(12)[None] < np.array([[12], [7]])
    want, got = _pair(jbert.BertEncoder(**kw), tbert.BertEncoder(**kw), ids,
                      valid)
    _close(got, want, 1e-4)


def test_subsentence_masks_match_jax():
    ids = np.array([[2, 6, 4, 9, 10, 4, 3, 0, 0],
                    [2, 7, 5, 12, 11, 4, 13, 4, 3]], np.int32)
    specials = (2, 3, 4, 5)
    for a, b in zip(tbert.build_subsentence_masks(ids, specials),
                    jbert.build_subsentence_masks(ids, specials)):
        np.testing.assert_array_equal(a, b)


# -- deformable attention ---------------------------------------------------

SHAPES = [(9, 11), (5, 6), (3, 3), (1, 2)]


def _deform_inputs(seed=0, b=2, q=13, h=2, d=8, p=3):
    rng = np.random.default_rng(seed)
    s = sum(hh * ww for hh, ww in SHAPES)
    value = rng.standard_normal((b, s, h, d)).astype(np.float32)
    # Locations reaching past the map on every side (zero padding).
    loc = rng.uniform(-0.2, 1.2, (b, q, h, len(SHAPES), p, 2)).astype(
        np.float32)
    w = rng.uniform(0, 1, (b, q, h, len(SHAPES), p)).astype(np.float32)
    return value, loc, w / w.sum(axis=(3, 4), keepdims=True)


def test_deformable_core_matches_jax_f32():
    value, loc, w = _deform_inputs()
    want = jdeform.deformable_attention_core(jnp.asarray(value), SHAPES,
                                             jnp.asarray(loc), jnp.asarray(w))
    got = tdeform.deformable_attention_core(_t(value), SHAPES, _t(loc), _t(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    # f32 on both sides: the JAX gather and exact one-hot matmul paths.
    _close(got, want, 1e-5)


def test_deformable_core_matches_jax_bf16():
    """The JAX bf16 path rounds its one-hot weights and its accumulation to
    bf16; the port samples the bf16 values in f32 and rounds once. Both sit
    within a few bf16 ulps of the f32 result: 2e-2 of values ~1."""
    value, loc, w = _deform_inputs(seed=1)
    want = jdeform.deformable_attention_core(
        jnp.asarray(value).astype(jnp.bfloat16), SHAPES, jnp.asarray(loc),
        jnp.asarray(w))
    got = tdeform.deformable_attention_core(
        _t(value).to(torch.bfloat16), SHAPES, _t(loc), _t(w))
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), 2e-2)


def test_reference_points_and_sine_embeddings_match_jax():
    _close(tdeform.make_reference_points(SHAPES),
           jdeform.make_reference_points(SHAPES), 1e-6)
    _close(ttr.sine_position_embedding(SHAPES, 32),
           jtr.sine_position_embedding(SHAPES, 32), 1e-5)
    coords = np.random.default_rng(3).uniform(0, 1, (2, 5, 4)).astype(
        np.float32)
    for exchange in (False, True):
        _close(ttr.coordinate_sine_embedding(_t(coords), 32,
                                             exchange_xy=exchange),
               jtr.coordinate_sine_embedding(jnp.asarray(coords), 32,
                                             exchange_xy=exchange), 1e-5)
    x = np.array([0.0, 1e-4, 0.3, 0.999, 1.0], np.float32)
    _close(ttr.inverse_sigmoid(_t(x)), jtr.inverse_sigmoid(jnp.asarray(x)),
           1e-6)


# -- transformer layers -----------------------------------------------------

C, T, NQ = 32, 9, 7


def _rng_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_mha_matches_jax():
    q, k = _rng_inputs(4, (2, NQ, C), (2, T, C))
    bias = np.where(np.arange(T)[None, None, None] < 6, 0.0,
                    -1e9).astype(np.float32)
    want, got = _pair(jtr.MHA(C, 4), ttr.MHA(C, 4), q, k, k, bias)
    _close(got, want)


def test_bi_attention_block_matches_jax():
    img, txt = _rng_inputs(5, (2, 20, C), (2, T, C))
    mask = np.arange(T)[None] < np.array([[T], [5]])
    want, got = _pair(jtr.BiAttentionBlock(C, 64, 4),
                      ttr.BiAttentionBlock(C, 64, 4), img, txt, mask)
    for w, g in zip(want, got):
        _close(g, w)


def test_text_enhancer_layer_matches_jax():
    txt, pos = _rng_inputs(6, (2, T, C), (2, T, C))
    mask = np.tril(np.ones((T, T), bool))[None].repeat(2, 0)
    want, got = _pair(jtr.TextEnhancerLayer(C, 4, 48),
                      ttr.TextEnhancerLayer(C, 4, 48), txt, mask, pos)
    _close(got, want)


def test_deformable_layer_matches_jax():
    s = sum(h * w for h, w in SHAPES)
    x, pos = _rng_inputs(7, (2, s, C), (s, C))
    refs = np.asarray(jdeform.make_reference_points(SHAPES))
    jl = jtr.DeformableLayer(C, 2, 3, len(SHAPES), 48)
    tl = ttr.DeformableLayer(C, 2, 3, len(SHAPES), 48)
    params = redraw(jax.jit(lambda key, *a: jl.init(key, *a, SHAPES))(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(refs)), 1)
    want = jax.jit(lambda p, *a: jl.apply(p, *a, SHAPES))(
        params, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(refs))
    load_flax_params(tl, params)
    level_wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32)
    with torch.inference_mode():
        got = tl(_t(x), _t(pos), _t(refs), SHAPES, level_wh)
    _close(got, want)


def test_decoder_layer_matches_jax():
    s = sum(h * w for h, w in SHAPES)
    tgt, qpos, memory, txt = _rng_inputs(8, (2, NQ, C), (2, NQ, C),
                                         (2, s, C), (2, T, C))
    mask = np.arange(T)[None] < np.array([[T], [4]])
    ref = np.random.default_rng(9).uniform(0.1, 0.9, (2, NQ, 4)).astype(
        np.float32)
    jl = jtr.DecoderLayer(C, 2, 3, len(SHAPES), 48)
    tl = ttr.DecoderLayer(C, 2, 3, len(SHAPES), 48)
    args = (tgt, qpos, memory, np.zeros((s, C), np.float32), txt, mask, ref)
    params = redraw(jax.jit(lambda key, *a: jl.init(key, *a, SHAPES))(
        jax.random.PRNGKey(0), *map(jnp.asarray, args)), 1)
    want = jax.jit(lambda p, *a: jl.apply(p, *a, SHAPES))(
        params, *map(jnp.asarray, args))
    load_flax_params(tl, params)
    with torch.inference_mode():
        got = tl(_t(tgt), _t(qpos), _t(memory), _t(txt), _t(mask), _t(ref),
                 SHAPES)
    _close(got, want, 2e-5)


def test_box_mlp_matches_jax():
    (x,) = _rng_inputs(10, (2, NQ, 2 * C))
    want, got = _pair(jtr.BoxMLP(C, out=C, layers=2),
                      ttr.BoxMLP(2 * C, C, out=C, layers=2), x)
    _close(got, want)


# -- the whole detector -----------------------------------------------------


@pytest.fixture(scope="module")
def tiny_gdino():
    """The tiny GroundingDINO's raw outputs from both frameworks, f32, on a
    96^2 image (Swin maps 24, 12, 6 padded to 8, and 3: one window) with a
    3-category prompt."""
    tok = jtok.BertTokenizer(VOCAB)
    text = jinf.build_text_inputs(tok, ["chair", "traffic cone", "shoes"], 32)
    args = [np.random.default_rng(11).standard_normal((1, 96, 96, 3)).astype(
        np.float32), text["input_ids"], text["text_mask"],
        text["text_self_mask"], text["position_ids"]]
    model = JaxGroundingDINO(**GDINO_KWARGS, compute_dtype=jnp.float32)
    params = redraw(jax.jit(model.init)(jax.random.PRNGKey(0),
                                        *map(jnp.asarray, args)), 12)
    want = jax.jit(model.apply)(params, *map(jnp.asarray, args))
    port = build_gdino({**GDINO_KWARGS, "compute_dtype": torch.float32},
                       device="cpu")
    load_flax_params(port, params)
    with torch.inference_mode():
        got = port(*map(_t, args))
    return want, got, text


def test_gdino_raw_outputs_match_jax(tiny_gdino):
    want, got, text = tiny_gdino
    wl, gl = np.asarray(want["pred_logits"]), got["pred_logits"].numpy()
    assert gl.shape == wl.shape == (1, 16, 32)
    live = text["text_mask"][0]
    # Masked text positions are -1e9 in both; live ones f32 products of the
    # same weights (the 900 -> 16 top-k picked the same tokens, or the boxes
    # below would differ).
    np.testing.assert_array_equal(gl[..., ~live], wl[..., ~live])
    np.testing.assert_allclose(gl[..., live], wl[..., live], rtol=1e-4,
                               atol=1e-4 * np.abs(wl[..., live]).max())
    np.testing.assert_allclose(got["pred_boxes"].numpy(),
                               np.asarray(want["pred_boxes"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("threshold,topk", [(0.001, 16), (1.0, 16),
                                             (0.001, 5)])
def test_postprocess_matches_jax(tiny_gdino, threshold, topk):
    """The same raw outputs through both postprocesses: the default
    threshold, one that drops some boxes, and fewer slots than queries."""
    want, _, text = tiny_gdino
    logits = np.asarray(want["pred_logits"][0])
    boxes = np.asarray(want["pred_boxes"][0])
    args = (logits, boxes, text["span_matrix"], text["span_valid"])
    jout = jinf.postprocess_grounding(*map(jnp.asarray, args),
                                      jnp.asarray([96.0, 80.0]), topk=topk,
                                      box_threshold=threshold)
    tout = tinf.postprocess_grounding(*map(_t, args), (96.0, 80.0),
                                      topk=topk, box_threshold=threshold)
    n_valid = int(tout[3].sum())
    assert 0 < n_valid and (n_valid < topk or threshold < 1.0)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


def test_gdino_rejects_other_level_counts():
    with pytest.raises(ValueError, match="num_levels"):
        build_gdino({**GDINO_KWARGS, "num_levels": 3}, device="meta")
