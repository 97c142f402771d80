"""Released-checkpoint loading through the port's `utils/load.py` against the
JAX package's `utils/load.py`, as tests/test_load.py drives it: one seeded
state dict in the released key layout (utils/release_states.py) written once
with torch.save (or np.savez), loaded by both packages; every port parameter
equal, bit for bit, to the JAX-loaded tree put through the bridge's rule;
and the outputs within the parity tests' tolerances (tests/test_torch_rcnn3d
.py, test_torch_gdino.py, test_torch_sam.py, test_torch_depth.py). Also the
containers load_torch_state unwraps, the int8 weights re-quantized by a load
after serving, `--trunk-ckpt`'s partial load and the bridge's keep-list."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model import tiny_config
from test_torch_convert import chw_to_hwc_rows
from test_torch_rcnn3d import _inputs, port_config
from test_torch_trunks import (assert_trunk_equal, jax_init_tree,  # noqa: F401
                               tiny_presets, trunk_model_config, trunk_state)

from ovmono3d_tpu.models import depth as jdepth
from ovmono3d_tpu.models.gdino.model import GroundingDINO as JaxGDINO
from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
from ovmono3d_tpu.models.sam import SamSegmenter as JaxSamSegmenter
from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
from ovmono3d_tpu.utils import cnn_convert as jcnn
from ovmono3d_tpu.utils import load as jload
from ovmono3d_tpu.utils.checkpoint_convert import merge_into_params
from ovmono3d_tpu.utils.depth_convert import convert_depth_pro
from ovmono3d_tpu_torch.models import depth as tdepth
from ovmono3d_tpu_torch.models.ovmono3d import build_gdino
from ovmono3d_tpu_torch.models.rcnn3d import build_model
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils import cnn_convert as tcnn
from ovmono3d_tpu_torch.utils import flax_bridge
from ovmono3d_tpu_torch.utils import load as tload
from ovmono3d_tpu_torch.utils import release_states as rs

torch.set_num_threads(2)

IDENTITY_6D = np.array([1, 0, 0, 0, 1, 0], np.float32)


def save(path, state, wrap=None, prefix=""):
    obj = {prefix + k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    torch.save({wrap: obj, "iteration": 7} if wrap else obj, path)
    return path


def assert_bridged_equal(port, jax_params, keep=()):
    """Every port parameter equals the JAX-loaded tree's leaf under the
    bridge's rule (transpose, deconv flip), bit for bit."""
    ref = dict(port.named_parameters())
    want = flax_bridge.torch_arrays(port, jax.tree.map(np.asarray,
                                                       jax_params), keep)
    assert len(want) == len(ref) - len(tuple(keep))
    for name, arr in want.items():
        np.testing.assert_array_equal(ref[name].detach().numpy(), arr,
                                      err_msg=name)


def init_tree(module, *args, **kw):
    """The module's init tree as numpy zeros, traced but not compiled (the
    loaders replace every leaf)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kw))
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)


def close(got, want, tol, scale=None):
    w = np.asarray(want)
    g = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    assert g.shape == w.shape and np.isfinite(g).all()
    np.testing.assert_allclose(
        g, w, rtol=tol, atol=tol * (scale or float(np.abs(w).max())))


# -- load_torch_state -------------------------------------------------------

@pytest.mark.parametrize("wrap,prefix", [
    (None, ""), ("model", ""), ("state_dict", "module."),
    ("ema_state_dict", "")])
def test_load_torch_state_matches_jax(tmp_path, wrap, prefix):
    state = rs.sam_state(embed_dim=16, depth=1, num_heads=2, global_blocks=(),
                         window_size=2, grid=2, patch=8, neck=8,
                         decoder_dim=16, decoder_mlp=16)
    path = save(tmp_path / "w.pth", state, wrap, prefix)
    got, want = tload.load_torch_state(path), jload.load_torch_state(path)
    assert sorted(got) == sorted(want) == sorted(state)
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


# -- LIFT (ovmono3d_lift.pth) ----------------------------------------------

def lift_release_state(pcfg, seed=3):
    state = rs.lift_state(pcfg, seed=seed)
    state["roi_heads.cube_head.bbox_3D_pose.bias"] = IDENTITY_6D.copy()
    return state


def hwc_fc1(variables, pcfg):
    """The JAX-loaded tree with the box and cube heads' fc1 rows in the
    pooled grid's (H, W, C) order: the port converter's one departure from
    the JAX one (tests/test_torch_convert.py FC1_KEYS); both sides then
    compute detectron2's heads."""
    params = jax.tree.map(np.asarray, variables["params"])
    cube = pcfg.cube
    params["box_head"]["fc1"]["kernel"] = chw_to_hwc_rows(
        params["box_head"]["fc1"]["kernel"], pcfg.roi_box.pooler_resolution)
    names = (("shared",) if cube.shared_fc
             else ("xy", "dims", "pose", "z", "conf"))
    for n in names:
        leaf = params["cube_head"][f"{n}_fc1"]
        leaf["kernel"] = chw_to_hwc_rows(leaf["kernel"],
                                         cube.pooler_resolution)
    return {**variables, "params": params}


@pytest.fixture(scope="module")
def lift_pair(tmp_path_factory):
    jcfg = tiny_config().model
    pcfg = port_config(jcfg)
    path = save(tmp_path_factory.mktemp("lift") / "ovmono3d_lift.pth",
                lift_release_state(pcfg), wrap="model")
    image, K, im_hw, ratio, boxes, classes, scores, valid = _inputs()
    jmodel = jax_build_model(jcfg)
    args = tuple(map(jnp.asarray, (image, K, im_hw, ratio)))
    jparams = hwc_fc1(jload.load_rcnn_params(init_tree(jmodel, *args), path,
                                             jcfg), pcfg)
    port = build_model(pcfg, device="cpu")
    tload.load_rcnn_params(port, path, pcfg)
    oracle = dict(oracle_boxes=boxes, oracle_classes=classes,
                  oracle_scores=scores, oracle_valid=valid)
    want = jax.jit(jmodel.apply)(jparams, *args,
                                 **{k: jnp.asarray(v)
                                    for k, v in oracle.items()})
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in (image, K, im_hw, ratio)),
                   **{k: torch.from_numpy(v) for k, v in oracle.items()})
    return port, jparams, want, got, path, pcfg


def test_rcnn_load_matches_jax_bit_for_bit(lift_pair):
    port, jparams, *_ = lift_pair
    assert_bridged_equal(port, jparams)


@pytest.mark.parametrize("field", ["center_cam", "dimensions", "pose",
                                   "corners3d", "scores"])
def test_rcnn_loaded_outputs_match_jax(lift_pair, field):
    _, _, want, got, *_ = lift_pair
    # bf16 trunk and ROI pooling on both sides: 2e-2 of the field's scale.
    close(getattr(got, field), getattr(want, field), 2e-2)


def test_rcnn_load_raises_where_jax_raises(lift_pair, tmp_path):
    """A missing tensor raises KeyError, a misshapen one ValueError, in both
    packages; an extra key is ignored by both."""
    port, _, _, _, path, pcfg = lift_pair
    jcfg = tiny_config().model
    state = tload.load_torch_state(path)
    jp = init_tree(jax_build_model(jcfg), *map(jnp.asarray, _inputs()[:4]))
    for name, bad, exc in (
            ("missing", {k: v for k, v in state.items()
                         if k != "roi_heads.box_head.fc2.weight"}, KeyError),
            ("shape", {**state, "roi_heads.box_head.fc2.bias":
                       np.zeros(3, np.float32)}, ValueError),
            ("extra", {**state, "roi_heads.extra.weight":
                       np.zeros(3, np.float32)}, None)):
        f = save(tmp_path / f"{name}.pth", bad)
        for fn in (lambda: jload.load_rcnn_params(jp, f, jcfg),
                   lambda: tload.load_rcnn_params(port, f, pcfg)):
            if exc is None:
                fn()
            else:
                with pytest.raises(exc):
                    fn()


def test_rcnn_priors_come_from_the_file(lift_pair):
    """extract_priors recovers the file's priors, and a model built with
    them decodes with them (dims_priors_enabled, 3 depth clusters)."""
    from ovmono3d_tpu_torch.utils.lift_convert import extract_priors

    *_, path, pcfg = lift_pair
    cfg = dataclasses.replace(pcfg, cube=dataclasses.replace(
        pcfg.cube, dims_priors_enabled=True, cluster_bins=3,
        z_type="clusters"))
    state = rs.lift_state(cfg, seed=4)
    priors = extract_priors(state)
    np.testing.assert_array_equal(priors["dims"],
                                  state["roi_heads.priors_dims_per_cat"][0])
    model = build_model(cfg, priors={k: torch.from_numpy(v)
                                     for k, v in priors.items()},
                        device="cpu")
    tload.load_rcnn_params(model, state, cfg)
    image, K, im_hw, ratio, boxes, classes, scores, valid = _inputs()
    with torch.inference_mode():
        det = model(*(torch.from_numpy(a) for a in (image, K, im_hw, ratio)),
                    oracle_boxes=torch.from_numpy(boxes),
                    oracle_classes=torch.from_numpy(classes),
                    oracle_scores=torch.from_numpy(scores),
                    oracle_valid=torch.from_numpy(valid))
    assert torch.isfinite(det.dimensions[torch.from_numpy(valid)]).all()


@pytest.mark.parametrize("where", ["no_grad", "inference_mode"])
def test_int8_serving_requantizes_after_a_load(lift_pair, where):
    """An int8 model that has served, then loads the file (also from inside
    an inference_mode block), serves as a model loaded before it served:
    QDense's quantization follows the weight's version."""
    *_, path, pcfg = lift_pair
    cfg = dataclasses.replace(pcfg, backbone=dataclasses.replace(
        pcfg.backbone, quant="int8"))
    image, K, im_hw, ratio, boxes, classes, scores, valid = _inputs()
    args = [torch.from_numpy(a) for a in (image, K, im_hw, ratio)]
    oracle = dict(oracle_boxes=torch.from_numpy(boxes),
                  oracle_classes=torch.from_numpy(classes),
                  oracle_scores=torch.from_numpy(scores),
                  oracle_valid=torch.from_numpy(valid))
    served = build_model(cfg, device="cpu").eval()
    fresh = build_model(cfg, device="cpu", seed=5).eval()
    tload.load_rcnn_params(fresh, path, cfg)
    with torch.inference_mode():
        before = served(*args, **oracle).corners3d.clone()
        ctx = (torch.inference_mode() if where == "inference_mode"
               else contextlib.nullcontext())
        with ctx:
            tload.load_rcnn_params(served, path, cfg)
        got = served(*args, **oracle).corners3d
        want = fresh(*args, **oracle).corners3d
    assert not torch.equal(before, want)
    assert torch.equal(got, want)


def test_load_into_inference_tensors_raises(lift_pair):
    """Parameters made in inference mode have no version for the caches to
    follow: the bridge refuses to write them."""
    *_, path, pcfg = lift_pair
    with torch.inference_mode():
        model = build_model(pcfg, device="cpu")
    with pytest.raises(RuntimeError, match="[Ii]nference"):
        tload.load_rcnn_params(model, path, pcfg)


# -- GroundingDINO -----------------------------------------------------------

GDINO_KW = dict(hidden_dim=32, nheads=2, enc_layers=1, dec_layers=1,
                num_queries=16, enc_points=2, dec_points=2, max_text_len=32,
                ffn_dim=64, swin_embed_dim=8, swin_depths=(1, 1, 1, 1),
                swin_heads=(1, 2, 4, 8), swin_window=4, bert_layers=1,
                bert_hidden=32, bert_heads=4, bert_intermediate=64,
                bert_vocab=40, bert_max_position=64)


@pytest.fixture(scope="module")
def gdino_pair(tmp_path_factory):
    from ovmono3d_tpu.models.gdino import inference as jinf
    from ovmono3d_tpu.models.gdino import tokenizer as jtok

    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, ".": 4,
             "chair": 5, "cup": 6, "traffic": 7, "cone": 8}
    text = jinf.build_text_inputs(jtok.BertTokenizer(vocab),
                                  ["chair", "traffic cone", "cup"], 32)
    args = [np.random.default_rng(11).standard_normal((1, 96, 96, 3)).astype(
        np.float32), text["input_ids"], text["text_mask"],
        text["text_self_mask"], text["position_ids"]]
    # The original release wraps as {'model': ...} with 'module.' prefixes.
    path = save(tmp_path_factory.mktemp("gdino") / "gdino.pth",
                rs.gdino_state(seed=5, **GDINO_KW), "model", "module.")
    jmodel = JaxGDINO(**GDINO_KW, compute_dtype=jnp.float32)
    jparams = jload.load_gdino_params(
        init_tree(jmodel, *map(jnp.asarray, args)), path)
    want = jax.jit(jmodel.apply)(jparams, *map(jnp.asarray, args))
    port = build_gdino({**GDINO_KW, "compute_dtype": torch.float32},
                       device="cpu")
    tload.load_gdino_params(port, path)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(np.asarray(a)) for a in args))
    return port, jparams, want, got, text


def test_gdino_load_matches_jax_bit_for_bit(gdino_pair):
    port, jparams, *_ = gdino_pair
    assert_bridged_equal(port, jparams)


def test_gdino_loaded_outputs_match_jax(gdino_pair):
    _, _, want, got, text = gdino_pair
    live = text["text_mask"][0]
    wl, gl = np.asarray(want["pred_logits"]), got["pred_logits"].numpy()
    np.testing.assert_array_equal(gl[..., ~live], wl[..., ~live])
    # tests/test_torch_gdino.py's limits: f32 in both packages.
    np.testing.assert_allclose(gl[..., live], wl[..., live], rtol=1e-4,
                               atol=1e-4 * np.abs(wl[..., live]).max())
    np.testing.assert_allclose(got["pred_boxes"].numpy(),
                               np.asarray(want["pred_boxes"]), rtol=1e-5,
                               atol=1e-5)


# -- SAM ---------------------------------------------------------------------

SAM_KW = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2,
              pretrain_grid=6, layerscale=False, use_depth_fusion=False,
              use_cls_token=False, window_size=4, global_blocks=(1,),
              neck_channels=16, use_rel_pos=True)
SEG_KW = dict(embed_dim=32, decoder_mlp_dim=64)


@pytest.fixture(scope="module")
def sam_pair(tmp_path_factory):
    path = save(tmp_path_factory.mktemp("sam") / "sam_vit_t.pth",
                rs.sam_state(embed_dim=32, depth=3, num_heads=2,
                             global_blocks=(1,), window_size=4, grid=6,
                             patch=8, neck=16, decoder_dim=32,
                             decoder_mlp=64, seed=6))
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    embed = rng.normal(size=(1, 6, 6, 32)).astype(np.float32)
    box = np.array([[4.0, 6.0, 30.0, 40.0]], np.float32)
    jenc, jseg = JaxViT(dtype=jnp.float32, **SAM_KW), JaxSamSegmenter(**SEG_KW)
    p_enc, p_seg = jload.load_sam_params(
        init_tree(jenc, jnp.asarray(image)),
        init_tree(jseg, jnp.asarray(embed), jnp.asarray(box), 48.0), path,
        depth=3)
    want = (jax.jit(jenc.apply)(p_enc, jnp.asarray(image))["last_feat"],
            jax.jit(jseg.apply, static_argnums=(3,))(
                p_seg, jnp.asarray(embed), jnp.asarray(box), 48.0))
    enc = VisionTransformer(dtype=torch.float32, pos_interp_offset=0.0,
                            **SAM_KW)
    seg = SamSegmenter(**SEG_KW)
    tload.load_sam_params(enc, seg, path, depth=3)
    with torch.inference_mode():
        got = (enc(torch.from_numpy(image))["last_feat"],
               seg(torch.from_numpy(embed), torch.from_numpy(box), 48.0))
    return (enc, seg), (p_enc, p_seg), want, got


@pytest.mark.parametrize("part", [0, 1], ids=["encoder", "segmenter"])
def test_sam_load_matches_jax_bit_for_bit(sam_pair, part):
    ports, jparams, *_ = sam_pair
    assert_bridged_equal(ports[part], jparams[part])


def test_sam_loaded_outputs_match_jax(sam_pair):
    *_, want, got = sam_pair
    # f32: the same math summed in another order (tests/test_torch_sam.py).
    close(got[0], want[0], 1e-4)
    for g, w in zip(got[1], want[1]):
        close(g, w, 1e-4)


# -- Depth-Pro (.pth in the HF layout, and a flat .npz) -----------------------

DEPTH_KW = dict(patch_size=8, encoder_size=32, vit_dim=32, vit_depth=2,
                vit_heads=4, scaled_dims=(16, 16, 8), hook_ids=(1,),
                hook_dims=(8,), fusion_dim=8, merge_padding=1)


@pytest.fixture(scope="module")
def depth_files(tmp_path_factory):
    """The HF-layout .pth, and the .npz the JAX package writes of the tree
    it loaded from it; the JAX params loaded each way."""
    tmp = tmp_path_factory.mktemp("depth")
    state = rs.depth_pro_state(seed=7, **DEPTH_KW)
    state["head.layers.4.bias"] = np.full(1, 0.5, np.float32)
    pth = save(tmp / "depth_pro.pth", state)
    jmodel = jdepth.DepthPro(dtype=jnp.float32, **DEPTH_KW)
    img = np.random.default_rng(3).normal(size=(1, 128, 128, 3)).astype(
        np.float32)
    params = init_tree(jmodel, jnp.asarray(img))
    from_pth = merge_into_params(
        params, convert_depth_pro(jload.load_torch_state(pth)), ("params",))
    leaves = jax.tree_util.tree_flatten_with_path(from_pth)[0]
    npz = tmp / "depth_pro.npz"
    np.savez(npz, **{"/".join(str(k.key) for k in p): np.asarray(v)
                     for p, v in leaves})
    from_npz = jload.load_npz_params(params, npz)
    return {"pth": (pth, from_pth), "npz": (npz, from_npz)}, jmodel, img


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_depth_pro_load_matches_jax(depth_files, fmt):
    files, jmodel, img = depth_files
    path, jparams = files[fmt]
    port = tdepth.DepthPro(dtype=torch.float32, **DEPTH_KW)
    tload.load_depth_params(port, path)
    assert_bridged_equal(port, jparams)
    want = jax.jit(jmodel.apply)(jparams, jnp.asarray(img))
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    assert (np.asarray(want["canonical_inverse_depth"]) > 0).mean() > 0.5
    # tests/test_torch_depth.py's limits: f32 through three trunks.
    for key in ("canonical_inverse_depth", "fov_deg"):
        close(got[key], want[key], 1e-4)


def test_npz_with_a_missing_param_raises(depth_files, tmp_path):
    files, *_ = depth_files
    with np.load(files["npz"][0]) as f:
        flat = {k: f[k] for k in f.files}
    flat.pop(sorted(flat)[3])
    np.savez(tmp_path / "short.npz", **flat)
    with pytest.raises(KeyError):
        tload.load_npz_params(tdepth.DepthPro(dtype=torch.float32,
                                              **DEPTH_KW),
                              tmp_path / "short.npz")


# -- --trunk-ckpt: a torch.hub DINOv2 into the trunk -------------------------

def test_dinov2_trunk_load_matches_jax(tmp_path):
    """The trunk's parameters equal the JAX graft's; the depth-fusion conv
    keeps the model's own initialization on both sides."""
    jcfg = tiny_config().model
    pcfg = port_config(jcfg)
    bb = pcfg.backbone
    path = save(tmp_path / "dinov2.pth", rs.dinov2_hub_state(
        bb.embed_dim, bb.depth, bb.patch_size, bb.pretrain_grid, seed=8))
    port = build_model(pcfg, device="cpu")
    fusion = port.backbone.vit.depth_fusion.weight.detach().clone()
    params = init_tree(jax_build_model(jcfg), *map(jnp.asarray, _inputs()[:4]))
    jvit = jcnn.load_cnn_trunk(params, path, "dinov2")["params"]["backbone"][
        "vit"]
    tcnn.load_cnn_trunk(port, path, "dinov2")
    # The JAX graft keeps its model's depth-fusion conv, the port its own.
    jvit = {k: v for k, v in jvit.items() if k != "depth_fusion"}
    keep = ("depth_fusion.weight", "depth_fusion.bias")
    assert_bridged_equal(port.backbone.vit, jvit, keep)
    assert torch.equal(port.backbone.vit.depth_fusion.weight, fusion)


@pytest.mark.parametrize("name", ["clip", "mae", "midas", "sam", "dla34",
                                  "resnet50"])
def test_other_trunks_refuse_citing_item_9(name, tmp_path, tiny_presets):
    """Once refusals, now loads: one tiny seeded trunk in its released
    layout (torch.save'd) through both packages' load_cnn_trunk; every
    parameter and BatchNorm buffer of the port's trunk equals the JAX
    graft's leaf, bit for bit (MiDaS and DLA-34 at tiny widths, ResNet-50
    at its own)."""
    jcfg = trunk_model_config(tiny_config().model, name)
    pcfg = port_config(jcfg)
    path = save(tmp_path / f"{name}.pth", trunk_state(name, pcfg.backbone,
                                                      seed=8))
    port = build_model(pcfg, device="cpu")
    jvariables = jcnn.load_cnn_trunk(jax_init_tree(jcfg), path, name)
    tcnn.load_cnn_trunk(port, path, name)
    assert_trunk_equal(port, jvariables)


def test_bridge_keep_list_is_explicit():
    """An unset parameter outside `keep` still raises, and `keep` must name
    parameters."""
    vit = build_model(port_config(tiny_config().model),
                      device="meta").backbone.vit
    tree = tcnn._convert_vit_trunk(rs.dinov2_hub_state(
        32, 1, 14, 8, shape_only=True), "dinov2")
    with pytest.raises(KeyError, match="depth_fusion"):
        flax_bridge.plan(vit, tree)
    with pytest.raises(KeyError, match="keep names no torch parameter"):
        flax_bridge.plan(vit, tree, keep=["depth_fusion.weight",
                                          "depth_fusion.bias", "nope"])
    del tree["block0"]["ls1"]
    with pytest.raises(KeyError, match="ls1"):
        flax_bridge.plan(vit, tree, keep=["depth_fusion.weight",
                                          "depth_fusion.bias"])
