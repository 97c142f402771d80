"""Multi-scale deformable attention in PyTorch.

Counterpart of ovmono3d_tpu/models/gdino/deformable.py, which replaces
GroundingDINO's MultiScaleDeformableAttention CUDA extension. Each query
has, per head, level and point, a sampling location and a weight; values
are sampled bilinearly from each level's map and summed.

One gather path: `F.grid_sample(align_corners=False, padding_mode="zeros")`
per level, the form of the official pure-torch
`multi_scale_deformable_attn_pytorch`. Sampling runs in f32 whatever the
value's dtype, and the result is cast back to it. The JAX package's one-hot
bf16 matmul path (levels of at most 4100 positions) and its `levels`
ablation knob are numerics and probes made for the TPU, and are not carried
over.

Conventions: value [B, S, H, D] with S = sum of the levels' h * w (flattened
level after level); sampling_locations [B, Q, H, L, P, 2] as (x, y) in
[0, 1] of each level; attention_weights [B, Q, H, L, P] (already
softmax-ed over L * P). Returns [B, Q, H * D].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def deformable_attention_core(value: torch.Tensor,
                              spatial_shapes: list[tuple[int, int]],
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor
                              ) -> torch.Tensor:
    b, _, heads, d = value.shape
    _, q, _, _, points, _ = sampling_locations.shape
    grids = 2.0 * sampling_locations.float() - 1.0     # to [-1, 1]
    weights = attention_weights.float()
    out = torch.zeros(b * heads, d, q, device=value.device)
    start = 0
    for li, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].float()            # [B, hw, H, D]
        start += h * w
        v = v.permute(0, 2, 3, 1).reshape(b * heads, d, h, w)
        grid = grids[:, :, :, li].transpose(1, 2).reshape(b * heads, q,
                                                          points, 2)
        sampled = F.grid_sample(v, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=False)
        wl = weights[:, :, :, li].transpose(1, 2).reshape(b * heads, 1, q,
                                                          points)
        out = out + (sampled * wl).sum(-1)                   # [B*H, D, Q]
    out = out.view(b, heads, d, q).permute(0, 3, 1, 2).reshape(b, q,
                                                               heads * d)
    return out.to(value.dtype)


def make_reference_points(spatial_shapes: list[tuple[int, int]],
                          device=None) -> torch.Tensor:
    """Each token's normalized centre (x, y), replicated over the levels:
    [S, L, 2] f32."""
    refs = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    pts = torch.cat(refs, 0)
    return pts[:, None, :].expand(pts.shape[0], len(spatial_shapes), 2)
