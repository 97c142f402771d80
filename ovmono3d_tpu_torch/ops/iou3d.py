"""Exact 3D IoU of oriented boxes by fixed-shape polytope clipping, in
PyTorch (counterpart of ovmono3d_tpu/ops/iou3d.py).

For a box pair (A, B) the intersection volume is the divergence-theorem
volume of A's 12 surface triangles clipped by B's 6 half-spaces plus B's
clipped by A's. Clipping a triangle by a plane (Sutherland-Hodgman) adds at
most one vertex, so a fixed buffer of 10 vertices with a count holds every
clipped polygon, and the whole computation is dense tensor math over a batch
of pairs: the JAX package vmaps one pair's function, the port writes the
batch out ([pairs, 12 triangles, 10 vertices, 3]) and loops over the 6
planes. IoU = vol / (volA + volB - vol), as pytorch3d's box3d_overlap.

Functions run on the device their tensors are on; pairs are taken in chunks
of `PAIR_CHUNK` so memory stays bounded.
"""
from __future__ import annotations

import torch

from ovmono3d_tpu_torch.utils.geometry import CUBOID_FACES, CUBOID_QUAD_FACES

_MAX_V = 10  # 3 vertices + up to 6 clips (one more vertex each), padded.
_EPS = 1e-7
PAIR_CHUNK = 8192


def box_planes(corners: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Outward half-spaces of boxes [..., 8, 3]: normals [..., 6, 3] and
    offsets [..., 6], with n . x <= d inside."""
    quads = corners[..., CUBOID_QUAD_FACES, :]            # [..., 6, 4, 3]
    v0, v1, v3 = quads[..., 0, :], quads[..., 1, :], quads[..., 3, :]
    n = torch.linalg.cross(v1 - v0, v3 - v0)
    n = n / n.norm(dim=-1, keepdim=True).clamp(min=_EPS)
    center = corners.mean(-2)
    sign = torch.sign((n * (v0 - center[..., None, :])).sum(-1, keepdim=True))
    n = n * torch.where(sign == 0, torch.ones_like(sign), sign)
    return n, (n * v0).sum(-1)


def box_volume(corners: torch.Tensor) -> torch.Tensor:
    """|e1 . (e2 x e3)| from corner 0's edges (to corners 1, 3 and 4)."""
    e1 = corners[..., 1, :] - corners[..., 0, :]
    e2 = corners[..., 3, :] - corners[..., 0, :]
    e3 = corners[..., 4, :] - corners[..., 0, :]
    return (e1 * torch.linalg.cross(e2, e3)).sum(-1).abs()


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., V, 3] at idx [..., V] along V."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, 3))


def _clip_polygon_by_plane(verts, count, normal, offset, tol):
    """Sutherland-Hodgman over a batch: padded polygons verts [..., V, 3]
    with `count` [...] valid vertices in cyclic order, clipped by the
    half-space n . x - d <= tol (normal [..., 3], offset and tol [...]).
    Returns (verts [..., V, 3], count [...])."""
    idx = torch.arange(_MAX_V, device=verts.device)
    cnt = count[..., None]
    nxt = _gather_rows(verts, torch.where(idx + 1 >= cnt, 0, idx + 1)
                       .expand(*count.shape, _MAX_V))
    d_cur = (verts * normal[..., None, :]).sum(-1) - offset[..., None]
    d_nxt = (nxt * normal[..., None, :]).sum(-1) - offset[..., None]
    cur_in = d_cur <= tol[..., None]
    nxt_in = d_nxt <= tol[..., None]
    denom = d_cur - d_nxt
    # Keep the denominator's sign when clamping it away from zero.
    eps = torch.where(denom < 0, -_EPS, _EPS)
    safe = torch.where(denom.abs() < _EPS, eps, denom)
    inter = verts + (d_cur / safe)[..., None] * (nxt - verts)

    active = idx < cnt
    emit_cur = cur_in & active
    emit_int = (cur_in != nxt_in) & active
    # Compaction by gathers: edge e's outputs occupy slots
    # [start[e], start[e] + n_emit[e]); invert with searchsorted.
    n_emit = emit_cur.to(torch.int64) + emit_int.to(torch.int64)
    csum = n_emit.cumsum(-1)
    start = csum - n_emit
    src = torch.searchsorted(csum, idx.expand_as(csum).contiguous(),
                             right=True).clamp(max=_MAX_V - 1)
    take_cur = (idx == torch.gather(start, -1, src)) \
        & torch.gather(emit_cur, -1, src)
    out = torch.where(take_cur[..., None], _gather_rows(verts, src),
                      _gather_rows(inter, src))
    new_count = csum[..., -1]
    out = torch.where((idx < new_count[..., None])[..., None], out,
                      torch.zeros_like(out))
    return out, new_count


def _surface_volume(corners, planes_n, planes_d, ref, tol):
    """Signed volume of the surface of boxes [P, 8, 3] clipped by the other
    boxes' planes ([P, 6, 3], [P, 6]), as fans of tetrahedra to ref [P, 3]."""
    p = corners.shape[0]
    tris = corners[:, CUBOID_FACES, :]                    # [P, 12, 3, 3]
    verts = torch.zeros(p, 12, _MAX_V, 3, dtype=corners.dtype,
                        device=corners.device)
    verts[:, :, :3] = tris
    count = torch.full((p, 12), 3, dtype=torch.int64, device=corners.device)
    tol12 = tol[:, None].expand(p, 12)
    for i in range(6):
        verts, count = _clip_polygon_by_plane(
            verts, count, planes_n[:, None, i].expand(p, 12, 3),
            planes_d[:, None, i].expand(p, 12), tol12)
    idx = torch.arange(_MAX_V, device=corners.device)
    valid_tri = (idx >= 1) & (idx + 1 < count[..., None])
    rel = verts - ref[:, None, None, :]
    rel1 = rel[:, :, torch.where(idx + 1 >= _MAX_V, 0, idx + 1)]
    # The reference's face winding is clockwise seen from outside (camera
    # frame: x right, y down, z forward), so the raw sum is -V.
    contrib = -(rel[:, :, :1] * torch.linalg.cross(rel, rel1)).sum(-1) / 6.0
    return torch.where(valid_tri, contrib, torch.zeros_like(contrib)) \
        .sum((-1, -2))


def _pair_intersection_volume(a: torch.Tensor, b: torch.Tensor):
    """Intersection volumes of aligned pairs a, b [P, 8, 3] -> [P]."""
    na, da = box_planes(a)
    nb, db = box_planes(b)
    ref = 0.5 * (a.mean(-2) + b.mean(-2))
    # Coplanar faces: A's kept inclusively (+tol), B's exclusively (-tol),
    # so a shared boundary patch counts once; tol scales with the extent.
    extent = torch.cat([a, b], -2).abs().amax((-1, -2))
    tol = 1e-5 * extent.clamp(min=1.0)
    v = (_surface_volume(a, nb, db, ref, tol)
         + _surface_volume(b, na, da, ref, -tol))
    return v.clamp(min=0.0)


def _intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([_pair_intersection_volume(a[i:i + PAIR_CHUNK],
                                                b[i:i + PAIR_CHUNK])
                      for i in range(0, a.shape[0], PAIR_CHUNK)]) \
        if a.shape[0] else a.new_zeros(0)


def _iou(inter, v1, v2):
    union = v1 + v2 - inter
    iou = torch.where(union > _EPS, inter / union.clamp(min=_EPS),
                      torch.zeros_like(union))
    return iou.clamp(0.0, 1.0)


def pairwise_iou3d(corners1: torch.Tensor, corners2: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact pairwise 3D IoU of corners1 [N, 8, 3] and corners2 [M, 8, 3]
    (the reference's vertex order): (intersection volumes [N, M],
    IoU [N, M])."""
    n, m = corners1.shape[0], corners2.shape[0]
    a = corners1[:, None].expand(n, m, 8, 3).reshape(n * m, 8, 3)
    b = corners2[None].expand(n, m, 8, 3).reshape(n * m, 8, 3)
    inter = _intersection(a, b).reshape(n, m)
    return inter, _iou(inter, box_volume(corners1)[:, None],
                       box_volume(corners2)[None, :])


def matched_iou3d(corners1: torch.Tensor,
                  corners2: torch.Tensor) -> torch.Tensor:
    """3D IoU of aligned pairs: [N, 8, 3] x [N, 8, 3] -> [N]."""
    inter = _intersection(corners1, corners2)
    return _iou(inter, box_volume(corners1), box_volume(corners2))
