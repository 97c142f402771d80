"""Seeded weights for a model, drawn on its device in one call.

Every parameter is a slice of one normal draw from a torch.Generator on the
device, scaled by the rule of its kind, so a seed gives the same weights on
every run and both the program and the reference read the same tensors:

- LayerNorm scales 1 + 0.1 z and their biases 0.1 z;
- LayerScale `gamma` 0.1 + 0.02 z (trained DINOv2 LayerScales are far
  from their 1e-5 init; at the init the blocks would be identities);
- position tables, the cls token and the rel-pos tables 0.1 z;
- other biases 0.02 z;
- other weights z / sqrt(fan_in), fan_in the input channels times the
  kernel area (a transposed convolution's input channels alone);
- a configuration's `weight_means` set the mean of named tensors, where a
  trained model's outputs sit far from 0 (the cube head's pose at the
  identity's 6D vector, its depth and its uncertainty): at 0 the 6D
  normalisation and the uncertainty's clamp make the gradients swing with
  the smallest change of the input.
"""
from __future__ import annotations

import math

import torch


def _scale(name: str, shape, transposed: bool):
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
    if "norm" in owner:
        return (1.0, 0.1) if leaf == "weight" else (0.0, 0.1)
    if leaf == "gamma":
        return 0.1, 0.02
    if leaf in ("pos_embed", "cls_token", "rel_pos_h", "rel_pos_w"):
        return 0.0, 0.1
    if leaf == "bias" or len(shape) < 2:
        return 0.0, 0.02
    fan_in = shape[0] if transposed else math.prod(shape) // shape[0]
    return 0.0, 1.0 / math.sqrt(fan_in)


def draw(specs: list[tuple[str, tuple[int, ...], bool]], seed: int,
         device, means: dict | None = None) -> dict[str, torch.Tensor]:
    """{name: f32 tensor} for [(name, shape, is_transposed_conv)]; `means`
    {name: number or list} replaces the rule's mean of those tensors."""
    means = means or {}
    total = sum(math.prod(s) for _, s, _ in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, start = {}, 0
    for name, shape, transposed in specs:
        n = math.prod(shape)
        mean, std = _scale(name, shape, transposed)
        if name in means:
            mean = torch.tensor(means[name], dtype=torch.float32,
                                device=device)
        out[name] = (flat[start:start + n].view(shape) * std + mean)
        start += n
    return out


def specs_of(model: torch.nn.Module) -> list:
    """(name, shape, transposed) of every parameter of a torch module."""
    transposed = {f"{mn}.weight" for mn, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    return [(n, tuple(p.shape), n in transposed)
            for n, p in model.named_parameters()]
