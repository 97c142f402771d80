"""Image resizing shared by the port's serving paths (the machine with the
card has no cv2).

`resize_bilinear` stands in for cv2.resize(INTER_LINEAR): F.interpolate
bilinear with half-pixel centres and no antialiasing, which is the same
filter. `resize_shortest_edge` is detectron2's ResizeShortestEdge geometry,
a copy of ovmono3d_tpu/data/mapper.py's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR) of [..., H, W, C] maps to [..., h, w, C]."""
    lead = x.shape[:-3]
    y = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *hw, x.shape[-1])


def resize_shortest_edge(hw: tuple[int, int], short: int,
                         max_size: int) -> tuple[int, int, float]:
    """Scale so the shorter side is `short`, capped so the longer side is at
    most `max_size`. Returns (new_h, new_w, scale), rounded half up like
    detectron2's int(x + 0.5): Python's round() disagrees at exact .5."""
    h, w = hw
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5), scale
