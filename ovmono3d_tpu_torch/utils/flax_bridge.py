"""Load the JAX package's parameters into the port (the inverse of
ovmono3d_tpu/utils/checkpoint_convert.py:28-43).

The port names its submodules after the flax module names, so a flax leaf
`a/b/c/kernel` belongs to the torch module `a.b.c`; the module's type decides
the layout:

  Dense kernel [in, out]                 -> Linear weight [out, in]
  Conv / PatchEmbed kernel HWIO          -> weight OIHW (a grouped
                                            conv's I is in / groups on both
                                            sides)
  ConvTranspose kernel HWIO              -> weight IOHW, spatially flipped
                                            (flax applies it mirrored: the
                                            SFP's, SAM's up1/up2 and every
                                            Depth-Pro deconv)
  LayerNorm / GroupNorm / BatchNorm scale -> weight
  batch_stats mean / var                 -> the FrozenBatchNorm2d's buffers
                                            running_mean / running_var
  Embed embedding [num, features]        -> Embedding weight, unchanged
  any other leaf                         -> the parameter of the same name,
                                            unchanged (bias, pos_embed,
                                            cls_token, gamma, rel_pos_h/w,
                                            SAM's gaussian_matrix,
                                            point_embeddings, no_mask_embed,
                                            iou_token, mask_tokens;
                                            GroundingDINO's level_embed,
                                            tgt_embed, gamma_v/gamma_l and
                                            the Swin rel_pos_bias tables)

A tree is a params dict, or a variables dict of 'params' and, for the CNN
trunks, 'batch_stats' (their BatchNorms' running statistics). The mapping is
strict: a flax leaf with no torch parameter (or buffer), a torch parameter or
buffer no leaf fills, or a shape that disagrees raises. A partial load names
the torch tensors the tree may leave as they are in `keep` (the trunk
checkpoints of `--trunk-ckpt` hold no depth-fusion conv: utils/cnn_convert.py
keeps the model's own); a name in `keep` that is no parameter raises too. A
port RCNN3D holds the trunk, the pyramid, the RPN, box and cube heads, so it
takes the tree JAX's init through `RCNN3D.compute_losses` makes (the
training tree); a tree from the oracle-only init lacks the RPN and box heads
and is refused. The GEO models (SAM's encoder, `SamSegmenter`, `DepthPro`)
take their JAX modules' init trees, and `GroundingDINO` (Swin, BERT, the
enhancer and decoder) its JAX module's; the released checkpoints' converters
(utils/*_convert.py) make the same trees.
"""
from __future__ import annotations

from collections.abc import Iterable, Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

from ovmono3d_tpu_torch.models.layers import FrozenBatchNorm2d
from ovmono3d_tpu_torch.models.vit import PatchEmbed

_HWIO_TO_OIHW = (3, 2, 0, 1)
_HWIO_TO_IOHW = (2, 3, 0, 1)
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _leaves(tree: Mapping) -> dict[str, Any]:
    """{flax path: leaf} of a params tree or of a variables dict ('params',
    and 'batch_stats' whose paths keep that prefix)."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        out = _flatten(tree["params"])
        out.update(_flatten(tree.get("batch_stats", {}), "batch_stats"))
        return out
    return _flatten(tree)


def _rule(mod: nn.Module, leaf: str, stats: bool = False
          ) -> tuple[str, tuple | None, bool]:
    """(torch tensor name, axes permutation or None, flip H/W first)."""
    if stats:
        if not isinstance(mod, FrozenBatchNorm2d) or leaf not in _STATS:
            raise KeyError(f"batch_stats leaf {leaf!r} of a "
                           f"{type(mod).__name__}")
        return _STATS[leaf], None, False
    if leaf == "kernel":
        if isinstance(mod, nn.ConvTranspose2d):
            return "weight", _HWIO_TO_IOHW, True
        if isinstance(mod, (nn.Conv2d, PatchEmbed)):
            return "weight", _HWIO_TO_OIHW, False
        if isinstance(mod, nn.Linear):
            return "weight", (1, 0), False
        raise KeyError(f"no kernel layout for {type(mod).__name__}")
    if leaf in ("scale", "embedding"):
        return "weight", None, False
    return leaf, None, False


def plan(model: nn.Module, tree: Mapping,
         keep: Iterable[str] = ()) -> dict[str, tuple]:
    """Map every flax leaf onto one torch parameter or buffer, checking
    shapes.

    `tree` is the params dict (or the variables dict holding 'params' and
    maybe 'batch_stats') with array-like leaves: numpy arrays, or anything
    with `.shape`, such as the output of jax.eval_shape. Every torch
    parameter and buffer must be filled, but those named in `keep`. Returns
    {flax_path: (torch_name, perm, flip)}; batch_stats paths keep their
    'batch_stats/' prefix.
    """
    modules = dict(model.named_modules())
    params = {**dict(model.named_parameters()),
              **dict(model.named_buffers())}
    out: dict[str, tuple] = {}
    taken: dict[str, str] = {}
    for path, leaf_val in _leaves(tree).items():
        stats = path.startswith("batch_stats/")
        *mod_path, leaf = path.split("/")[1 if stats else 0:]
        mod_name = ".".join(mod_path)
        mod = modules.get(mod_name)
        if mod is None:
            raise KeyError(f"flax leaf {path}: no torch module {mod_name!r}")
        tname, perm, flip = _rule(mod, leaf, stats)
        full = f"{mod_name}.{tname}" if mod_name else tname
        if full not in params:
            raise KeyError(f"flax leaf {path}: no torch parameter {full!r}")
        if full in taken:
            raise KeyError(f"{path} and {taken[full]} both map to {full}")
        shape = tuple(leaf_val.shape)
        if perm is not None:
            shape = tuple(shape[i] for i in perm)
        if shape != tuple(params[full].shape):
            raise ValueError(f"{path} -> {full}: shape {shape} != "
                             f"{tuple(params[full].shape)}")
        taken[full] = path
        out[path] = (full, perm, flip)
    keep = set(keep)
    if keep - set(params):
        raise KeyError(f"keep names no torch parameter: "
                       f"{sorted(keep - set(params))}")
    unset = sorted(set(params) - set(taken) - keep)
    if unset:
        raise KeyError(f"torch parameters with no flax leaf: {unset}")
    return out


def torch_arrays(model: nn.Module, tree: Mapping,
                 keep: Iterable[str] = ()) -> dict[str, np.ndarray]:
    """{torch parameter or buffer name: its leaf of `tree` in the torch
    layout, f32}: what `load_flax_params` copies (views where the layout
    allows)."""
    leaves = _leaves(tree)
    out = {}
    for path, (full, perm, flip) in plan(model, tree, keep).items():
        arr = np.asarray(leaves[path], dtype=np.float32)
        if flip:
            arr = arr[::-1, ::-1]
        if perm is not None:
            arr = np.transpose(arr, perm)
        out[full] = arr
    return out


def load_flax_params(model: nn.Module, tree: Mapping,
                     keep: Iterable[str] = ()) -> None:
    """Copy params in the JAX package's layout (nested dict of numpy arrays)
    into `model`, in place, under no_grad and outside inference mode even
    when the caller is in it: each copy bumps the parameter's version, so
    the caches keyed on it (QDense's int8 weight and kernel 10's tensor map,
    Swin's expanded bias, `OVMono3DLift.replicas`) are rebuilt. A parameter
    made in inference mode has no version; copying into it raises rather
    than leave a stale cache. A 'batch_stats' tree fills the BatchNorms'
    buffers. `keep`: parameters the tree may leave unset."""
    params = {**dict(model.named_parameters()),
              **dict(model.named_buffers())}
    arrays = torch_arrays(model, tree, keep)
    with torch.inference_mode(False), torch.no_grad():
        for name, arr in arrays.items():
            params[name].copy_(torch.from_numpy(arr.copy()))
