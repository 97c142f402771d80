"""The port's W8A8 int8 serving path and the tanh-GELU epilogue against the
JAX package (CPU), and the CUDA int8 product (kernel 10) against its plain
version on the card (marker `cuda`).

On the CPU: the quantization, the int8 product and its epilogue, QDense,
tiny DINOv2, SAM and Depth-Pro trunks and the oracle RCNN3D forward with
quant="int8" and gelu="tanh", all on the same numpy-seeded inputs and
bridged weights; the weight-quantization cache; the SERVING-only refusals;
the kernel wrapper's refusals. JAX is imported inside the fixtures that need
it, so the `cuda` tests also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_quant.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch import config as tcfg
from ovmono3d_tpu_torch.models.layers import Dense
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

# Kernel 10's shapes on the serving paths, (rows R, K, M) per image: the
# LIFT trunk (DINOv2 ViT-B/14 at 896^2), SAM ViT-H at 1024^2 (global and
# windowed blocks), Depth-Pro's ViT-L/16 patch encoder (35 crops) and image
# encoder; a small ragged case.
CUDA_SHAPES = {
    "lift_qkv": (4097, 768, 2304), "lift_proj": (4097, 768, 768),
    "lift_fc1": (4097, 768, 3072), "lift_fc2": (4097, 3072, 768),
    "sam_h_window_qkv": (4900, 1280, 3840), "sam_h_fc1": (4096, 1280, 5120),
    "sam_h_fc2": (4096, 5120, 1280),
    "depth_pro_patch_fc1": (20195, 1024, 4096),
    "depth_pro_image_fc2": (577, 4096, 1024), "ragged": (77, 64, 200),
    # K tails (a partial 128-byte k stage) with R = 4097 and M no multiple
    # of the 256-column tile.
    "tail_k96": (4097, 96, 328), "tail_k160": (4097, 160, 200),
}


def _operands(rows, depth, cols, seed=0, device="cpu"):
    """Activations ~N(0, 1) in bf16 and weights ~N(0, 0.02^2), quantized per
    row and per output channel; a bias ~N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, depth)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((cols, depth)) * 0.02).astype(
        np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cols).astype(np.float32)).to(
        device)
    xq, x_scale = tq.quantize_int8(x, -1)
    wq, w_scale = tq.quantize_int8(w, -1)
    return xq, x_scale, wq, w_scale.reshape(-1), bias


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from ovmono3d_tpu.ops import quant as jq

    return jax, jnp, jq


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


def _scaled_normal(shape, seed):
    """Rows of very different ranges, so the scales matter."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * rng.uniform(0.01, 100, shape[:1] + (1,) * (len(shape) - 1)
                           ).astype(np.float32)


@pytest.mark.parametrize("per", ["row", "channel"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_int8_matches_jax(jax_mods, dtype, per):
    jax, jnp, jq = jax_mods
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    x = _scaled_normal((4, 50, 96) if per == "row" else (96, 128), seed=1)
    if per == "row":
        want_q, want_s = jax.jit(jq.quantize_int8, static_argnums=1)(
            jnp.asarray(x).astype(jd), -1)
        got_q, got_s = tq.quantize_int8(torch.from_numpy(x).to(td), -1)
    else:
        # The JAX kernel is [K, M], reduced over axis 0; the port's weight is
        # its transpose [M, K], reduced over the last dim.
        want_q, want_s = jax.jit(jq.quantize_int8, static_argnums=1)(
            jnp.asarray(x).astype(jd), 0)
        got_q, got_s = tq.quantize_int8(torch.from_numpy(x.T.copy()).to(td),
                                        -1)
        got_q, got_s = got_q.T, got_s.T
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    # Exact: the same absmax, the scale as XLA compiles it (the product with
    # 1/127 in f32), a true division and round half to even.
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert int(got_q.abs().max()) == 127


def test_int8_accumulator_matches_jax(jax_mods):
    jax, jnp, _ = jax_mods
    xq, _, wq, _, _ = _operands(70, 192, 48, seed=2)
    want = jax.lax.dot_general(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy().T),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    got = tq.int8_mm_ref(xq, wq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_matmul_ref_matches_jax(jax_mods, dtype, with_bias):
    jax, jnp, jq = jax_mods
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 33, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) * 0.02).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32) if with_bias else None
    want = jax.jit(jq.int8_matmul, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        jd)
    wq, w_scale = tq.quantize_int8(torch.from_numpy(w.T.copy()), -1)
    got = tq.int8_matmul_ref(torch.from_numpy(x), wq, w_scale.reshape(-1),
                             None if b is None else torch.from_numpy(b), td)
    assert got.dtype == td and got.shape == (2, 33, 96)
    # The same integers and scales (the tests above). XLA on the CPU fuses
    # the rescale and the bias add into one FMA, which rounds once where the
    # port rounds the product and the sum each: in f32, within 1 ulp of the
    # product plus 1 ulp of the result (where product and bias cancel, that
    # is many ulps of the result); in bf16 the final cast hides it: within
    # 1 ulp of the result.
    if dtype == "f32":
        xq, x_scale = tq.quantize_int8(torch.from_numpy(x), -1)
        prod = (tq.int8_mm_ref(xq, wq).float()
                * (x_scale * w_scale.reshape(-1))).numpy()
        w = np.asarray(want)
        assert (np.abs(got.numpy() - w)
                <= np.spacing(np.abs(prod)) + np.spacing(np.abs(w))).all()
    else:
        g = got.view(torch.int16).numpy().astype(np.int32)
        w_ = np.asarray(want).view(np.int16).astype(np.int32)
        assert np.abs(g - w_).max() <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdense_none_is_dense(dtype):
    gen = torch.Generator().manual_seed(0)
    dense = Dense(48, 40, dtype)
    dense.init_lecun(gen)
    with torch.no_grad():
        dense.bias.normal_(generator=gen)
    q = tq.QDense(48, 40, dtype)
    q.load_state_dict(dense.state_dict())
    x = torch.randn(3, 7, 48, generator=gen)
    assert torch.equal(q(x), dense(x))
    assert list(dict(q.named_parameters())) == ["weight", "bias"]


def test_qdense_refuses_unknown_modes():
    with pytest.raises(ValueError, match="quant='int4'"):
        tq.QDense(8, 8, quant="int4")
    with pytest.raises(ValueError, match="gelu='quick'"):
        VisionTransformer(device="meta", patch_size=8, embed_dim=16, depth=1,
                          num_heads=2, pretrain_grid=4, gelu="quick")


# --- trunks against the JAX modules --------------------------------------

VIT_KW = dict(patch_size=14, embed_dim=64, depth=2, num_heads=2,
              pretrain_grid=8, layerscale=True, use_depth_fusion=True)
IMG = 126


def _gamma(params, value=0.5):
    """numpy leaves, LayerScales raised from 1e-5 so the blocks matter."""
    import jax

    def fix(path, x):
        x = np.asarray(x)
        return np.full_like(x, value) if path[-1].key == "gamma" else x
    return jax.tree_util.tree_map_with_path(fix, params)


def _close(got, want, tol):
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    assert g.shape == w.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quant,gelu", [("int8", "erf"), ("none", "tanh"),
                                        ("int8", "tanh")])
def test_vit_serving_options_match_jax(jax_mods, quant, gelu, dtype):
    from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

    jax, jnp, _ = jax_mods
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    image = np.random.default_rng(4).normal(size=(2, IMG, IMG, 3)).astype(
        np.float32)
    jvit = JaxViT(dtype=jd, pos_interp_offset=0.1, quant=quant, gelu=gelu,
                  **VIT_KW)
    params = _gamma(jax.jit(jvit.init)(jax.random.PRNGKey(0),
                                       jnp.asarray(image)))
    want = jax.jit(jvit.apply)(params, jnp.asarray(image))
    port = VisionTransformer(dtype=td, quant=quant, gelu=gelu, **VIT_KW)
    load_flax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(image))
    # f32 tanh: the same math summed in another order (1e-4). int8: a
    # rounding step of the activation's quantization flips where the f32
    # sums differ in the last bit, moving that row's product by 1/127 of its
    # range (measured 2.4e-3 of last_feat's scale): 1e-2. bf16: the two
    # frameworks round activations at different points, as in the bf16
    # trunk tests: 3e-2.
    tol = 3e-2 if dtype == "bf16" else (1e-2 if quant == "int8" else 1e-4)
    for key in ("last_feat", "cls"):
        _close(got[key], want[key], tol)


def test_sam_encoder_int8_tanh_matches_jax(jax_mods):
    from ovmono3d_tpu.models.vit import VisionTransformer as JaxViT
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
    from test_torch_sam import IMG as SAM_IMG
    from test_torch_sam import SAM_KW, rel_pos_filled

    jax, jnp, _ = jax_mods
    image = np.random.default_rng(5).normal(
        size=(2, SAM_IMG, SAM_IMG, 3)).astype(np.float32)
    kw = dict(SAM_KW, quant="int8", gelu="tanh")
    jvit = JaxViT(dtype=jnp.bfloat16, **kw)
    params = rel_pos_filled(jax.jit(jvit.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(image)))
    want = jax.jit(jvit.apply)(params, jnp.asarray(image))
    port = VisionTransformer(dtype=torch.bfloat16, pos_interp_offset=0.0, **kw)
    load_flax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(image))
    # bf16 windowed rel-pos blocks and the neck, as the bf16 SAM test: 3e-2
    # of the neck's ~N(0, 1) output.
    assert got["last_feat"].shape == (2, 6, 6, 16)
    _close(got["last_feat"], want["last_feat"], 3e-2)


def test_depth_pro_int8_tanh_matches_jax(jax_mods):
    from ovmono3d_tpu.models import depth as jdepth
    from ovmono3d_tpu_torch.models import depth as tdepth
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
    from test_torch_depth import TINY, depth_params

    jax, jnp, _ = jax_mods
    img = np.random.default_rng(6).normal(size=(1, 128, 128, 3)).astype(
        np.float32)
    kw = dict(TINY, quant="int8", gelu="tanh")
    jmodel = jdepth.DepthPro(dtype=jnp.float32, **kw)
    params = depth_params(jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                               jnp.asarray(img)))
    want = jax.jit(jmodel.apply)(params, jnp.asarray(img))
    port = tdepth.DepthPro(dtype=torch.float32, **kw)
    load_flax_params(port, params)
    assert all(fc.quant == "int8" for vit in port.trunks()
               for blk in vit.blocks()
               for fc in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1,
                          blk.mlp.fc2))
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    # f32 through three int8 trunks and the decoder: quantization steps that
    # flip where the f32 sums differ in the last bit (see the ViT test): 1e-2
    # of each output's scale.
    for key in ("canonical_inverse_depth", "fov_deg"):
        _close(got[key], want[key], 1e-2)


@pytest.fixture(scope="module")
def int8_slice_pair(jax_mods):
    """The oracle RCNN3D at the tiny test config with quant="int8", JAX and
    port on the same weights and inputs."""
    from ovmono3d_tpu.models.rcnn3d import build_model as jax_build_model
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
    from test_model import tiny_config
    from test_torch_rcnn3d import (_inputs, _spread, port_config, to_flax,
                                   training_tree)

    jax, jnp, _ = jax_mods
    jcfg = tiny_config().model
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, quant="int8"))
    image, K, im_hw, ratio, boxes, classes, scores, valid = _inputs()
    model = jax_build_model(jcfg)
    port = build_model(port_config(jcfg), device="cpu")
    assert port.backbone.vit.block0.mlp.fc1.quant == "int8"
    params = _spread(to_flax(port, training_tree(model, image.shape, 3)))
    load_flax_params(port, params)
    want = jax.jit(model.apply)(
        params, jnp.asarray(image), jnp.asarray(K), jnp.asarray(im_hw),
        jnp.asarray(ratio), oracle_boxes=jnp.asarray(boxes),
        oracle_classes=jnp.asarray(classes),
        oracle_scores=jnp.asarray(scores), oracle_valid=jnp.asarray(valid))
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in (image, K, im_hw, ratio)),
                   oracle_boxes=torch.from_numpy(boxes),
                   oracle_classes=torch.from_numpy(classes),
                   oracle_scores=torch.from_numpy(scores),
                   oracle_valid=torch.from_numpy(valid))
    return want, got


@pytest.mark.parametrize("field", ["boxes", "classes", "valid", "scores",
                                   "center_cam", "dimensions", "pose",
                                   "corners3d"])
def test_oracle_lift_int8_matches_jax(int8_slice_pair, field):
    want, got = int8_slice_pair
    w = np.asarray(getattr(want, field))
    g = getattr(got, field)
    if field in ("boxes", "classes", "valid"):
        np.testing.assert_array_equal(g.numpy(), w)
        return
    # bf16 trunk and ROI pooling as in the bf16 slice test (2e-2 of the
    # field's scale); the int8 products round the same integers on both
    # sides.
    _close(g, w, 2e-2)


def test_int8_trunk_close_to_bf16():
    """The port's int8 trunk against its bf16 trunk on the same weights,
    within the JAX package's own limits (tests/test_quant.py): relative
    Frobenius error < 5e-2, cosine > 0.999; and a different path."""
    kw = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2,
              pretrain_grid=8, use_depth_fusion=False)
    gen = torch.Generator().manual_seed(8)
    vit = VisionTransformer(**kw)
    vit.init_weights(gen)
    vit_q = VisionTransformer(quant="int8", **kw)
    vit_q.load_state_dict(vit.state_dict())
    img = torch.rand(1, 64, 64, 3, generator=gen)
    with torch.inference_mode():
        ref = vit(img)["last_feat"].flatten()
        got = vit_q(img)["last_feat"].flatten()
    rel = float((got - ref).norm() / ref.norm())
    cos = float(got @ ref / (got.norm() * ref.norm()))
    assert rel < 5e-2 and cos > 0.999, (rel, cos)
    assert not torch.equal(got, ref)


def test_weight_quantization_cache_refreshes():
    """The cached (wq, w_scale) follows the weight: a bridge load, an
    in-place edit and a new tensor each give the quantization of the new
    weight; an unchanged weight reuses the cache."""
    from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params

    gen = torch.Generator().manual_seed(9)
    fc = tq.QDense(64, 32, torch.float32, quant="int8")
    fc.init_lecun(gen)
    x = torch.randn(5, 64, generator=gen)

    def fresh():
        wq, s = tq.quantize_int8(fc.weight.detach(), -1)
        return wq, s.reshape(-1)

    with torch.no_grad():
        first = fc.quantized_weight()
        assert fc.quantized_weight()[0] is first[0]          # reused
        for change in ("inplace", "bridge", "assign"):
            before = fc(x)
            if change == "inplace":
                fc.weight.mul_(-2.0)
            elif change == "bridge":
                kernel = np.asarray(torch.randn(64, 32, generator=gen))
                load_flax_params(fc, {"kernel": kernel,
                                      "bias": np.zeros(32, np.float32)})
            else:
                fc.weight = torch.nn.Parameter(torch.randn(32, 64,
                                                           generator=gen))
            wq, s = fc.quantized_weight()
            want_q, want_s = fresh()
            assert torch.equal(wq, want_q) and torch.equal(s, want_s), change
            after = fc(x)
            assert not torch.equal(after, before), change
            assert torch.equal(after, tq.int8_matmul_ref(
                x, want_q, want_s, fc.bias, torch.float32)), change


def test_int8_forward_with_grad_raises():
    fc = tq.QDense(32, 16, torch.float32, quant="int8")
    fc.init_lecun(torch.Generator().manual_seed(0))
    x = torch.randn(4, 32)
    with pytest.raises(RuntimeError, match="SERVING-only"):
        fc(x)                                    # the parameters need grad
    with pytest.raises(RuntimeError, match="SERVING-only"):
        fc.requires_grad_(False)(x.requires_grad_())
    with torch.no_grad():
        assert fc(x).shape == (4, 16)
    fc.requires_grad_(True)
    with torch.inference_mode():
        assert fc(x).shape == (4, 16)


def test_train_entry_points_refuse_int8():
    from ovmono3d_tpu_torch.models.rcnn3d import build_model
    from ovmono3d_tpu_torch.parallel.train_step import (create_train_state,
                                                        make_train_step)
    from ovmono3d_tpu_torch.train.loop import train
    from ovmono3d_tpu_torch.train.optim import Optimizer

    bb = tcfg.BackboneConfig(embed_dim=32, depth=1, num_heads=2,
                             pretrain_grid=8, out_channels=32,
                             square_pad=112, quant="int8", freeze=False)
    cfg = tcfg.ModelConfig(num_classes=5, backbone=bb,
                           cube=tcfg.CubeHeadConfig(fc_dim=32))
    model = build_model(cfg, device="cpu")
    opt = Optimizer(tcfg.SolverConfig(), model)
    with pytest.raises(ValueError, match="SERVING-only"):
        create_train_state(model, opt)
    with pytest.raises(ValueError, match="SERVING-only"):
        make_train_step(model, opt)
    with pytest.raises(ValueError, match="SERVING-only"):
        train(tcfg.Config(model=cfg), None, lambda s, b: (s, {}), iter(()))
    # The same model without quant trains.
    plain = build_model(dataclasses.replace(
        cfg, backbone=dataclasses.replace(bb, quant="none")), device="cpu")
    opt = Optimizer(tcfg.SolverConfig(), plain)
    create_train_state(plain, opt)
    make_train_step(plain, opt)


# --- the kernel wrapper ----------------------------------------------------

def _gemm_args(**over):
    xq, x_scale, wq, w_scale, bias = _operands(8, 64, 16, seed=10)
    args = dict(xq=xq, wq=wq, x_scale=x_scale.reshape(-1), w_scale=w_scale,
                bias=bias, out_dtype=torch.bfloat16)
    args.update(over)
    return args


_BAD = {
    "xq_float": (dict(xq=torch.zeros(8, 64)), "int8"),
    "wq_strided": (dict(wq=torch.zeros(64, 16, dtype=torch.int8).T),
                   "contiguous"),
    "xq_3d": (dict(xq=torch.zeros(2, 4, 64, dtype=torch.int8)), "2-D"),
    "depth_mismatch": (dict(wq=torch.zeros(16, 96, dtype=torch.int8)),
                       "depths"),
    "depth_not_32": (dict(xq=torch.zeros(8, 48, dtype=torch.int8),
                          wq=torch.zeros(16, 48, dtype=torch.int8)),
                     "multiple of 32"),
    "one_scale": (dict(x_scale=None), "both scales"),
    "bias_without_scales": (dict(x_scale=None, w_scale=None), "both scales"),
    "scale_f16": (dict(w_scale=torch.ones(16, dtype=torch.float16)), "f32"),
    "scale_size": (dict(x_scale=torch.ones(9)), "8 elements"),
    "bias_size": (dict(bias=torch.zeros(15)), "16 elements"),
    "out_f16": (dict(out_dtype=torch.float16), "bfloat16 or float32"),
    "unaligned": (dict(xq=torch.zeros(8 * 64 + 1, dtype=torch.int8)[1:]
                       .view(8, 64)), "16-byte"),
    "scale_needs_grad": (dict(x_scale=torch.ones(8, requires_grad=True)),
                         "SERVING-only"),
    "out_row": (dict(wq=torch.zeros(12, 64, dtype=torch.int8),
                     w_scale=torch.ones(12), bias=torch.zeros(12)),
                "multiple of 16 bytes"),
    "cpu": ({}, "CUDA device"),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_gemm_wrapper_rejects(case):
    over, match = _BAD[case]
    args = _gemm_args(**over)
    calls, launches = tq._kernel.cache_info()[:2], tq.int8_gemm.launches
    with pytest.raises(ValueError, match=match):
        tq.int8_gemm(**args)
    # Refused before the library is built or looked up, and not counted.
    assert tq._kernel.cache_info()[:2] == calls
    assert tq.int8_gemm.launches == launches


_QUANT_BAD = {
    "f16": (torch.zeros(8, 64, dtype=torch.float16), "bfloat16 or float32"),
    "3d": (torch.zeros(2, 8, 64, dtype=torch.bfloat16), "2-D"),
    "strided_k": (torch.zeros(8, 128, dtype=torch.bfloat16)[:, ::2],
                  "unit stride"),
    "k_not_32": (torch.zeros(8, 48, dtype=torch.bfloat16), "multiple of 32"),
    "empty": (torch.zeros(0, 64, dtype=torch.bfloat16), "empty"),
    "row_stride": (torch.zeros(8, 68, dtype=torch.bfloat16)[:, :64],
                   "16-byte"),
    "unaligned": (torch.zeros(8 * 64 + 1, dtype=torch.float32)[1:]
                  .view(8, 64), "16-byte"),
    "needs_grad": (torch.zeros(8, 64, requires_grad=True), "SERVING-only"),
    "cpu": (torch.zeros(8, 64, dtype=torch.bfloat16), "CUDA device"),
}


@pytest.mark.parametrize("case", list(_QUANT_BAD))
def test_quantize_wrapper_rejects(case):
    x, match = _QUANT_BAD[case]
    calls, launches = tq._kernel.cache_info()[:2], tq.quantize_rows.launches
    with pytest.raises(ValueError, match=match):
        tq.quantize_rows(x)
    assert tq._kernel.cache_info()[:2] == calls
    assert tq.quantize_rows.launches == launches


def test_weight_map_refuses_what_the_kernel_does_not_take():
    calls = tq._kernel.cache_info()[:2]
    with pytest.raises(ValueError, match="multiple of 32"):
        tq.weight_map(torch.zeros(16, 48, dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA device"):
        tq.weight_map(torch.zeros(16, 64, dtype=torch.int8))
    assert tq._kernel.cache_info()[:2] == calls


def test_int8_matmul_cpu_runs_the_plain_version():
    xq, x_scale, wq, w_scale, bias = _operands(6, 64, 24, seed=11)
    x = torch.randn(2, 3, 64, dtype=torch.bfloat16)
    launches = tq.int8_gemm.launches, tq.quantize_rows.launches
    got = tq.int8_matmul(x, wq, w_scale, bias, torch.bfloat16)
    assert torch.equal(got, tq.int8_matmul_ref(x, wq, w_scale, bias,
                                               torch.bfloat16))
    assert got.shape == (2, 3, 24)
    assert (tq.int8_gemm.launches, tq.quantize_rows.launches) == launches


def test_geo_cli_synthetic_with_tanh_gelu(tmp_path, capsys):
    from ovmono3d_tpu_torch.geo import cli

    cli.main(["--synthetic", "--device", "cpu", "--gelu", "tanh",
              "--output-dir", str(tmp_path)])
    assert "GEO synthetic self-check: PASS" in capsys.readouterr().out
    assert cli.parse_args(["--gelu", "tanh"]).gelu == "tanh"
    with pytest.raises(SystemExit):
        cli.parse_args(["--gelu", "quick"])


def test_geo_models_take_the_serving_options(monkeypatch):
    """build_geo_models hands quant and gelu to SAM's encoder and to
    Depth-Pro, whose three trunks take them into every block; Depth-Pro's
    FOV neck stays a plain Dense, as in the JAX module."""
    from ovmono3d_tpu_torch.geo import cli
    from ovmono3d_tpu_torch.models.depth import DepthPro
    from ovmono3d_tpu_torch.models.vit import Mlp

    seen = {}

    def recorder(name):
        class Fake(torch.nn.Module):
            def __init__(self, **kw):
                super().__init__()
                seen[name] = kw

            def init_weights(self, generator):
                pass
        return Fake

    for name in ("VisionTransformer", "DepthPro", "SamSegmenter"):
        monkeypatch.setattr(cli, name, recorder(name))
    cli.build_geo_models("vit_h", depth_bf16=True, device="cpu",
                         quant="int8", gelu="tanh")
    for name in ("VisionTransformer", "DepthPro"):
        assert seen[name]["quant"] == "int8" and seen[name]["gelu"] == "tanh"
    assert seen["VisionTransformer"]["embed_dim"] == 1280
    monkeypatch.undo()
    depth = DepthPro(quant="int8", gelu="tanh", device="meta")
    for vit in depth.trunks():
        mlps = [m for m in vit.modules() if isinstance(m, Mlp)]
        assert len(mlps) == vit.depth
        assert all(m.approximate == "tanh" for m in mlps)
        assert sum(isinstance(m, tq.QDense) and m.quant == "int8"
                   for m in vit.modules()) == 4 * vit.depth
    assert type(depth.fov_neck) is Dense


# --- kernel 10 on the card -------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_SHAPES))
def test_kernel_raw_is_exact_on_cuda(cuda_device, name):
    rows, depth, cols = CUDA_SHAPES[name]
    xq, _, wq, _, _ = _operands(rows, depth, cols, seed=12,
                                device=cuda_device)
    got = tq.int8_gemm(xq, wq)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, tq.int8_mm_ref(xq, wq))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(CUDA_SHAPES))
def test_kernel_dequant_matches_plain_on_cuda(cuda_device, name, out_dtype):
    rows, depth, cols = CUDA_SHAPES[name]
    xq, x_scale, wq, w_scale, bias = _operands(rows, depth, cols, seed=13,
                                               device=cuda_device)
    got = tq.int8_gemm(xq, wq, x_scale, w_scale, bias, out_dtype)
    torch.cuda.synchronize()
    want = tq.dequantize_ref(tq.int8_mm_ref(xq, wq), x_scale, w_scale, bias,
                             out_dtype)
    # The epilogue rounds each step as the plain version does: expected
    # bit-exact; held to 1 ulp of the output dtype.
    view = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    ulps = (got.view(view).long() - want.view(view).long()).abs().max()
    assert int(ulps) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged", "tail_k96", "tail_k160",
                                  "lift_fc1"])
def test_kernel_reuses_the_weight_map_on_cuda(cuda_device, name):
    """The weight's tensor map encoded once and reused, as QDense does: raw
    equal, bf16 within one ulp (expected equal)."""
    rows, depth, cols = CUDA_SHAPES[name]
    xq, x_scale, wq, w_scale, bias = _operands(rows, depth, cols, seed=14,
                                               device=cuda_device)
    w_map = tq.weight_map(wq)
    acc = tq.int8_mm_ref(xq, wq)
    raw = tq.int8_gemm(xq, wq, w_map=w_map)
    got = tq.int8_gemm(xq, wq, x_scale, w_scale, bias, w_map=w_map)
    torch.cuda.synchronize()
    assert torch.equal(raw, acc)
    want = tq.dequantize_ref(acc, x_scale, w_scale, bias, torch.bfloat16)
    ulps = (got.view(torch.int16).long() - want.view(torch.int16).long())
    assert int(ulps.abs().max()) <= 1


def _quant_input(rows, depth, dtype, device):
    """Rows of different ranges, an all-zero row, and a row whose absmax is
    254 (scale exactly 2) holding odd integers, each x / scale a tie at .5
    that rounds to even."""
    x = torch.from_numpy(_scaled_normal((rows, depth), 15)).to(dtype)
    x[3] = 0
    x[5] = torch.arange(depth) % 128 * 2 - 127
    x[5, 0] = 254
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4097, 768), (77, 96), (9, 5120)])
def test_quantize_kernel_is_exact_on_cuda(cuda_device, dtype, shape):
    x = _quant_input(*shape, dtype, cuda_device)
    before = tq.quantize_rows.launches
    xq, x_scale = tq.quantize_rows(x)
    torch.cuda.synchronize()
    assert tq.quantize_rows.launches == before + 1
    want_q, want_s = tq.quantize_int8(x, -1)
    assert torch.equal(x_scale, want_s) and torch.equal(xq, want_q)
    assert x_scale[5].item() == 2.0 and int(xq[3].abs().max()) == 0
    # the ties: odd / 2 rounds to the even neighbour
    ties = x[5, 1:].float() / 2
    assert torch.equal(xq[5, 1:].float(), ties.round())


@pytest.mark.cuda
def test_quantize_kernel_takes_a_row_stride_on_cuda(cuda_device):
    x = torch.randn(50, 160, device=cuda_device,
                    dtype=torch.bfloat16)[:, :96]
    xq, x_scale = tq.quantize_rows(x)
    want_q, want_s = tq.quantize_int8(x, -1)
    assert torch.equal(xq, want_q) and torch.equal(x_scale, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qdense_int8_on_cuda_launches_the_kernel(cuda_device, dtype):
    """QDense on the card: the quantization kernel and the product, once
    each a call, equal to the plain W8A8 product (bf16 and an f32 trunk)."""
    fc = tq.QDense(768, 3072, dtype=dtype, quant="int8", device=cuda_device)
    fc.init_lecun(torch.Generator(device=cuda_device).manual_seed(0))
    x = torch.randn(2, 300, 768, device=cuda_device, dtype=dtype)
    before = tq.int8_gemm.launches, tq.quantize_rows.launches
    with torch.inference_mode():
        got = fc(x)
    torch.cuda.synchronize()
    assert tq.int8_gemm.launches == before[0] + 1
    assert tq.quantize_rows.launches == before[1] + 1
    wq, w_scale = fc.quantized_weight()
    assert torch.equal(got, tq.int8_matmul_ref(x, wq, w_scale, fc.bias,
                                               dtype))
