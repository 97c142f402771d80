"""Released-checkpoint loading: torch .pth and flat .npz files -> the port's
modules (counterpart of ovmono3d_tpu/utils/load.py).

The reference's CLIs are only useful with the released weights
(DetectionCheckpointer.resume_or_load, reference tools/train_net.py:151-168;
demo.py:144-150; GroundingDINO load at roi_heads_gdino.py:87-91). This module
is the CLI-facing glue over the converters. Each converter returns the tree
the JAX converter returns; `utils.flax_bridge.load_flax_params` copies it
into the module in place (strict: a missing, extra or misshapen leaf
raises), outside inference mode, so a load after serving re-quantizes
QDense's int8 weights and re-expands Swin's bias tables (both are cached on
the weight's version):

  load_torch_state      .pth -> flat {name: np.ndarray} (handles wrappers)
  load_npz_params       flat '/'-joined flax-path .npz -> a module
  load_rcnn_params      ovmono3d_lift.pth  -> RCNN3D
  load_gdino_params     groundingdino .pth -> GroundingDINO
  load_sam_params       sam_vit_*.pth      -> SAM's encoder and SamSegmenter
  load_depth_params     Depth-Pro .npz or HF-format .pth -> DepthPro
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ovmono3d_tpu_torch.utils.depth_convert import convert_depth_pro
from ovmono3d_tpu_torch.utils.flax_bridge import load_flax_params
from ovmono3d_tpu_torch.utils.gdino_convert import convert_groundingdino
from ovmono3d_tpu_torch.utils.lift_convert import convert_ovmono3d_lift
from ovmono3d_tpu_torch.utils.sam_convert import (convert_sam_encoder,
                                                  convert_sam_segmenter)

logger = logging.getLogger(__name__)


def load_torch_state(path: str | Path) -> dict[str, np.ndarray]:
    """Load a torch checkpoint into a flat numpy state dict.

    Unwraps the common containers ({'model': ...}, {'state_dict': ...},
    {'ema_state_dict': ...}) and strips DDP 'module.' prefixes.
    """
    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "ema_state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = np.asarray(v)
    return out


def _state(source) -> dict[str, np.ndarray]:
    """A path's state dict, or `source` itself when it is one already (a
    caller that also reads the priors loads the file once)."""
    return source if isinstance(source, dict) else load_torch_state(source)


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}}."""
    tree: dict = {}
    for name, value in flat.items():
        *mods, leaf = name.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return tree


def load_npz_params(model: nn.Module, path: str | Path) -> None:
    """Load an .npz of flat '/'-joined param paths into `model`. Complement
    of:
      np.savez(path, **{'/'.join(p): v for p, v in flattened params})
    A parameter the file lacks or a shape that disagrees raises, as in the
    JAX loader; so does an entry the model has no parameter for, which the
    JAX loader skips."""
    with np.load(str(path)) as npz:
        flat = {k: npz[k] for k in npz.files}
    load_flax_params(model, _unflatten(flat))
    logger.info("loaded %d params from %s", len(flat), path)


def load_rcnn_params(model: nn.Module, path, model_cfg) -> None:
    """Load a released ovmono3d_lift.pth (detectron2 format; `path` may be
    the state dict `load_torch_state` read) into an RCNN3D in place.
    `model_cfg` is cfg.model. The file's category priors are not weights of
    the module: `lift_convert.extract_priors` reads them, for the model's
    build (`build_model(priors=...)`)."""
    state = _state(path)
    converted = convert_ovmono3d_lift(
        state,
        depth=model_cfg.backbone.depth,
        scale_factors=tuple(model_cfg.backbone.scale_factors),
        patch_size=model_cfg.backbone.patch_size,
        shared_fc=model_cfg.cube.shared_fc,
        box_resolution=model_cfg.roi_box.pooler_resolution,
        cube_resolution=model_cfg.cube.pooler_resolution,
    )
    load_flax_params(model, converted)
    logger.info("loaded RCNN3D weights (%d tensors)", len(state))


def load_gdino_params(model: nn.Module, path) -> None:
    """Load a released GroundingDINO checkpoint (the original repo's keys;
    `hf_shims.hf_gdino_to_original_keys` renames a HF one) into a
    GroundingDINO in place, e.g. `OVMono3DLift.gdino`."""
    state = _state(path)
    load_flax_params(model, convert_groundingdino(state))
    logger.info("loaded GroundingDINO weights (%d tensors)", len(state))


def load_sam_params(encoder: nn.Module, segmenter: nn.Module, path,
                    depth: int = 12) -> None:
    """Load an official sam_vit_*.pth into SAM's image encoder (the sam
    preset's VisionTransformer) and the SamSegmenter, in place. `depth` is
    the encoder depth (12 for vit_b, 32 for vit_h)."""
    state = _state(path)
    load_flax_params(encoder, convert_sam_encoder(state, depth=depth))
    load_flax_params(segmenter, convert_sam_segmenter(state))
    logger.info("loaded SAM weights (%d tensors)", len(state))


def load_depth_params(model: nn.Module, path) -> None:
    """Load Depth-Pro weights into a DepthPro in place, as the JAX GEO CLI's
    --depth-ckpt (tools/ovmono3d_geo.py:295-309): a path ending in .npz is a
    flat flax-path file (`load_npz_params`), anything else a HF-format
    (`DepthProForDepthEstimation`) torch checkpoint through
    `depth_convert.convert_depth_pro`."""
    if isinstance(path, (str, Path)) and str(path).endswith(".npz"):
        load_npz_params(model, path)
        return
    state = _state(path)
    load_flax_params(model, convert_depth_pro(state))
    logger.info("loaded Depth-Pro weights (%d tensors)", len(state))
