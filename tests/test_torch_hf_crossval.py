"""The port's converters and key shims against transformers' own forwards
(the counterpart of tests/test_hf_crossval.py for the port): small random HF
GroundingDINO, SAM (prompt encoder + mask decoder, and the image encoder),
DINOv2 and Depth-Pro go through `utils/hf_shims.py` or `hf_dinov2_to_hub`,
then the port's converter, then the port's model through the bridge, and
the port's f32 forward is held to HF's at the JAX tests' tolerances."""
import numpy as np
import pytest
import torch

from ovmono3d_tpu_torch.models.depth import DepthPro
from ovmono3d_tpu_torch.models.gdino.bert import build_subsentence_masks
from ovmono3d_tpu_torch.models.gdino.model import GroundingDINO
from ovmono3d_tpu_torch.models.sam import SamSegmenter
from ovmono3d_tpu_torch.models.vit import VisionTransformer
from ovmono3d_tpu_torch.utils.checkpoint_convert import (convert_dinov2_vit,
                                                         hf_dinov2_to_hub)
from ovmono3d_tpu_torch.utils.depth_convert import convert_depth_pro
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from ovmono3d_tpu_torch.utils.gdino_convert import convert_groundingdino
from ovmono3d_tpu_torch.utils.hf_shims import (hf_gdino_to_original_keys,
                                               hf_sam_to_original_keys)
from ovmono3d_tpu_torch.utils.sam_convert import (convert_sam_encoder,
                                                  convert_sam_segmenter)

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)


def _perturbed(model, std):
    """eval mode, every parameter moved off HF's init (some are zero: the
    box-delta layers, the layer scales)."""
    model.eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * std)
    return model


def _numpy_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous()


def test_groundingdino_matches_hf():
    """tests/test_hf_crossval.py:141's tiny detector: every stage a window
    multiple, shifted windows at every stage, the reference's caption
    pattern; boxes to 1e-4, live logits to 5e-4 / 1e-3."""
    from transformers import (BertConfig, GroundingDinoConfig,
                              GroundingDinoForObjectDetection, SwinConfig)

    torch.manual_seed(2)
    depths = (2, 2, 2, 2)
    swin = SwinConfig(image_size=128, patch_size=4, embed_dim=16,
                      depths=list(depths), num_heads=[1, 2, 4, 8],
                      window_size=2,
                      out_features=["stage2", "stage3", "stage4"],
                      hidden_act="gelu", drop_path_rate=0.0)
    bert = BertConfig(vocab_size=1100, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=64, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    hf = _perturbed(GroundingDinoForObjectDetection(GroundingDinoConfig(
        backbone_config=swin, text_config=bert, d_model=32,
        encoder_layers=2, decoder_layers=2, num_queries=20,
        encoder_attention_heads=8, decoder_attention_heads=8,
        encoder_ffn_dim=2048, decoder_ffn_dim=2048, num_feature_levels=4,
        encoder_n_points=4, decoder_n_points=4, max_text_len=64,
        dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        text_enhancer_dropout=0.0, fusion_dropout=0.0, fusion_droppath=0.0,
        positional_embedding_temperature=20)), 0.02)

    rng = np.random.RandomState(3)
    image = rng.rand(1, 128, 128, 3).astype(np.float32)
    ids = np.zeros((1, 12), np.int64)
    ids[0, :7] = [101, 11, 12, 1012, 13, 1012, 102]
    pad = (ids != 0).astype(np.int64)
    with torch.no_grad():
        want = hf(pixel_values=_nchw(image), input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(pad))

    tree = convert_groundingdino(hf_gdino_to_original_keys(
        _numpy_state(hf), depths, 2, 2))
    port = GroundingDINO(
        hidden_dim=32, nheads=8, enc_layers=2, dec_layers=2, num_queries=20,
        enc_points=4, dec_points=4, max_text_len=64, ffn_dim=2048,
        swin_embed_dim=16, swin_depths=depths, swin_heads=(1, 2, 4, 8),
        swin_window=2, bert_layers=2, bert_hidden=32, bert_heads=4,
        bert_intermediate=64, bert_vocab=1100, bert_max_position=64,
        compute_dtype=torch.float32).eval()
    load_flax_params(port, tree)
    mask3d, pos_ids = build_subsentence_masks(ids)
    with torch.inference_mode():
        got = port(torch.from_numpy(image), torch.from_numpy(ids),
                   torch.from_numpy(pad.astype(bool)),
                   torch.from_numpy(mask3d), torch.from_numpy(pos_ids))
    live = pad[0].astype(bool)
    np.testing.assert_allclose(got["pred_boxes"].numpy(),
                               want.pred_boxes.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got["pred_logits"].numpy()[:, :, :12][:, :, live],
        want.logits.numpy()[:, :, :12][:, :, live], atol=5e-4, rtol=1e-3)


def test_sam_segmenter_matches_hf():
    """tests/test_hf_crossval.py:258: masks and IoU over precomputed
    embeddings and one box, 5e-4 / 1e-3."""
    from transformers import SamConfig, SamModel
    from transformers.models.sam.configuration_sam import (
        SamMaskDecoderConfig, SamPromptEncoderConfig, SamVisionConfig)

    torch.manual_seed(4)
    hf = SamModel(SamConfig(
        vision_config=SamVisionConfig(hidden_size=48, output_channels=32,
                                      num_hidden_layers=1,
                                      num_attention_heads=4, image_size=64,
                                      patch_size=8, num_pos_feats=16),
        prompt_encoder_config=SamPromptEncoderConfig(
            hidden_size=32, image_embedding_size=8, image_size=128,
            mask_input_channels=8),
        mask_decoder_config=SamMaskDecoderConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=8,
            mlp_dim=64, iou_head_hidden_dim=32)))
    _perturbed(hf, 0.05)
    with torch.no_grad():
        # The original SAM has one PositionEmbeddingRandom for the prompts
        # and the image's dense PE; HF keeps two copies of that tensor.
        hf.shared_image_embedding.positional_embedding.copy_(
            hf.prompt_encoder.shared_embedding.positional_embedding)
    rng = np.random.RandomState(5)
    embed = rng.randn(2, 32, 8, 8).astype(np.float32)
    boxes = np.array([[[10.0, 20.0, 90.0, 110.0]], [[5.0, 3.0, 40.0, 80.0]]],
                     np.float32)
    with torch.no_grad():
        want = hf(image_embeddings=torch.from_numpy(embed),
                  input_boxes=torch.from_numpy(boxes), multimask_output=True)
    port = SamSegmenter(embed_dim=32, decoder_mlp_dim=64).eval()
    load_flax_params(port, convert_sam_segmenter(
        hf_sam_to_original_keys(hf.state_dict())))
    with torch.inference_mode():
        masks, iou = port(torch.from_numpy(embed.transpose(0, 2, 3, 1)),
                          torch.from_numpy(boxes[:, 0]), 128.0)
    np.testing.assert_allclose(masks.numpy(), want.pred_masks.numpy()[:, 0],
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(iou.numpy(), want.iou_scores.numpy()[:, 0],
                               atol=5e-4, rtol=1e-3)


def test_dinov2_matches_hf():
    """tests/test_hf_crossval.py:333: the last hidden state before the final
    norm (what the detection backbone consumes), through the hub layout
    `hf_dinov2_to_hub` writes; 2e-5 / 1e-4."""
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(6)
    hf = _perturbed(Dinov2Model(Dinov2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        image_size=56, patch_size=14, layerscale_value=1.0,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0)), 0.05)
    image = np.random.RandomState(7).rand(2, 56, 56, 3).astype(np.float32)
    with torch.no_grad():
        want = hf(_nchw(image), output_hidden_states=True).hidden_states[-1]
    port = VisionTransformer(patch_size=14, embed_dim=32, depth=2,
                             num_heads=4, pretrain_grid=4, layerscale=True,
                             use_depth_fusion=False,
                             dtype=torch.float32).eval()
    load_flax_params(port, convert_dinov2_vit(
        hf_dinov2_to_hub(_numpy_state(hf)), depth=2))
    with torch.inference_mode():
        got = port(torch.from_numpy(image))
    np.testing.assert_allclose(got["last_feat"].numpy().reshape(2, 16, 32),
                               want.numpy()[:, 1:], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got["cls"].numpy(), want.numpy()[:, 0],
                               atol=2e-5, rtol=1e-4)


def test_sam_encoder_matches_hf():
    """tests/test_hf_crossval.py:428: a window that does not divide the grid
    (pad after norm1), one global block, the neck; 5e-5 / 1e-4."""
    from transformers.models.sam.configuration_sam import SamVisionConfig
    from transformers.models.sam.modeling_sam import SamVisionEncoder

    torch.manual_seed(8)
    hf = _perturbed(SamVisionEncoder(SamVisionConfig(
        hidden_size=32, output_channels=16, num_hidden_layers=3,
        num_attention_heads=4, image_size=64, patch_size=8, window_size=3,
        global_attn_indexes=[1], mlp_dim=64)), 0.05)
    image = np.random.RandomState(9).rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        want = hf(_nchw(image)).last_hidden_state.numpy()
    orig = {"image_encoder." + k
            .replace("patch_embed.projection", "patch_embed.proj")
            .replace("layers.", "blocks.")
            .replace("layer_norm1", "norm1").replace("layer_norm2", "norm2")
            .replace("neck.conv1", "neck.0").replace("neck.norm1", "neck.1")
            .replace("neck.conv2", "neck.2").replace("neck.norm2", "neck.3"):
            v for k, v in _numpy_state(hf).items()}
    port = VisionTransformer(
        patch_size=8, embed_dim=32, depth=3, num_heads=4, mlp_ratio=2.0,
        pretrain_grid=8, layerscale=False, use_depth_fusion=False,
        use_cls_token=False, window_size=3, global_blocks=(1,),
        use_rel_pos=True, neck_channels=16, pos_interp_offset=0.0,
        dtype=torch.float32).eval()
    load_flax_params(port, convert_sam_encoder(orig, depth=3))
    with torch.inference_mode():
        got = port(torch.from_numpy(image))["last_feat"].numpy()
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want, atol=5e-5,
                               rtol=1e-4)


def test_depth_pro_matches_hf():
    """tests/test_hf_crossval.py:493: the 3-scale pyramid (1 + 9 + 25
    crops), three trunks, neck, fusion and both heads; inverse depth to
    1e-3 / 1e-4, the field of view to 5e-5 / 1e-4."""
    from transformers import DepthProConfig
    from transformers.models.depth_pro.modeling_depth_pro import (
        DepthProForDepthEstimation)

    torch.manual_seed(10)
    vit = dict(model_type="dinov2", hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, image_size=32, patch_size=8,
               layerscale_value=1.0, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, drop_path_rate=0.0)
    cfg = DepthProConfig(
        patch_size=32, patch_model_config=vit, image_model_config=vit,
        fov_model_config=vit, scaled_images_ratios=[0.25, 0.5, 1.0],
        scaled_images_overlap_ratios=[0.0, 0.5, 0.25],
        scaled_images_feature_dims=[16, 16, 8], intermediate_hook_ids=[1],
        intermediate_feature_dims=[8], fusion_hidden_size=8,
        merge_padding_value=1, num_fov_head_layers=2, use_fov_model=True)
    hf = _perturbed(DepthProForDepthEstimation(cfg, use_fov_model=True), 0.05)
    image = np.random.RandomState(11).rand(2, 128, 128, 3).astype(np.float32)
    with torch.no_grad():
        want = hf(_nchw(image))
    port = DepthPro(patch_size=8, encoder_size=32, vit_dim=32, vit_depth=2,
                    vit_heads=4, scaled_dims=(16, 16, 8), hook_ids=(1,),
                    hook_dims=(8,), fusion_dim=8, merge_padding=1,
                    num_fov_layers=2, use_fov=True,
                    dtype=torch.float32).eval()
    load_flax_params(port, convert_depth_pro(_numpy_state(hf)))
    with torch.inference_mode():
        got = port(torch.from_numpy(image))
    np.testing.assert_allclose(got["canonical_inverse_depth"].numpy(),
                               want.predicted_depth.numpy(), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(got["fov_deg"].numpy(),
                               want.field_of_view.numpy(), atol=5e-5,
                               rtol=1e-4)
