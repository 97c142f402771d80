"""Depth-Pro monocular metric depth in PyTorch.

Counterpart of ovmono3d_tpu/models/depth.py (the ml-depth-pro model that
OVMono3D-GEO runs for metric depth):

- a shared DINOv2-style patch encoder (ViT-L/16 at 384^2) over the
  overlapping crops of a 3-level image pyramid (ratios 0.25 / 0.5 / 1.0 of
  1536^2: 1 + 9 + 25 = 35 crops in one batch);
- an image encoder on the image downsampled to 384^2, and a FOV encoder;
- patch-grid merging, bilinear reassembly to a 5-level pyramid, the
  upsampling / projection neck and the DPT-style residual fusion decoder;
- the canonical-inverse-depth head and the FOV head.

The three trunks are the port's VisionTransformer with `final_norm`, their
attention in CUDA kernel 1 on the card: its bf16 instance for a bf16
Depth-Pro, its f32 instance (exact f32 products) for an f32 one, the JAX
GEO CLI's default. Maps stay channels-last; convs run in the model's dtype.

Metric decode (Depth-Pro's convention): depth = 1 / (c_inv * W / f_px).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ovmono3d_tpu_torch.models.layers import (Conv, ConvTranspose, Dense,
                                              init_flax_defaults)
from ovmono3d_tpu_torch.models.vit import VisionTransformer


def _resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear NHWC resize, F.interpolate(align_corners=False,
    antialias=False): torch does not antialias on downscale."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def split_to_patches(x: torch.Tensor, patch: int,
                     overlap: float) -> torch.Tensor:
    """[B, S, S, C] -> [n*B, patch, patch, C] overlapping crops, row-major
    over the crop grid, crop-major over the batch."""
    S = x.shape[1]
    if S == patch:
        return x
    stride = int(patch * (1 - overlap))
    crops = [x[:, i:i + patch, j:j + patch]
             for i in range(0, S - patch + 1, stride)
             for j in range(0, S - patch + 1, stride)]
    return torch.stack(crops, dim=0).reshape(-1, patch, patch, x.shape[-1])


def merge_patches(patches: torch.Tensor, batch: int,
                  padding: int) -> torch.Tensor:
    """[n*B, g, g, C] -> [B, G, G, C]: reassemble the row-major crop grid,
    stripping `padding` rows / columns from every inner edge. Given all 35
    crops, the first isqrt(35)^2 = 25 (the full-resolution level) are
    merged, as Depth-Pro's merge_patches does."""
    nB, g = patches.shape[0], patches.shape[1]
    n = nB // batch
    if n == 1:
        return patches
    sq = math.isqrt(n)
    if n < 4:
        padding = 0
    padding = min(g // 4, padding)
    grid = patches.reshape(n, batch, g, g, patches.shape[-1])
    rows = []
    for h in range(sq):
        row = []
        for w in range(sq):
            t = padding if h != 0 else 0
            b = padding if h != sq - 1 else 0
            le = padding if w != 0 else 0
            r = padding if w != sq - 1 else 0
            row.append(grid[h * sq + w][:, t:g - b, le:g - r])
        rows.append(torch.cat(row, dim=2))
    return torch.cat(rows, dim=1)


class PreActResidual(nn.Module):
    """DPT pre-activation residual unit: x + conv(relu(conv(relu(x))))."""

    def __init__(self, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1, dtype=dtype,
                          device=device)
        self.conv2 = Conv(features, features, 3, padding=1, dtype=dtype,
                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionLayer(nn.Module):
    """Residual fuse of a skip (when `with_skip`), a residual unit, a 2x
    deconv (when `use_deconv`) and a 1x1 projection."""

    def __init__(self, features: int, use_deconv: bool = True,
                 with_skip: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        if with_skip:
            self.rcu1 = PreActResidual(features, dtype, device)
        self.rcu2 = PreActResidual(features, dtype, device)
        self.deconv = (ConvTranspose(features, features, bias=False,
                                     dtype=dtype, device=device)
                       if use_deconv else None)
        self.project = Conv(features, features, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if self.deconv is not None:
            x = self.deconv(x)
        return self.project(x)


class DepthPro(nn.Module):
    """Multi-scale patchwork ViT encoder + DPT fusion decoder + FOV head.

    Defaults are the released model (dinov2l16_384 trunks at 384^2, image
    pyramid 1536 / 768 / 384). `quant` and `gelu` are the three ViT trunks'
    serving options (models/vit.py). Submodules carry the JAX module's
    names.
    """

    def __init__(self, patch_size: int = 16, encoder_size: int = 384,
                 vit_dim: int = 1024, vit_depth: int = 24, vit_heads: int = 16,
                 scaled_ratios=(0.25, 0.5, 1.0),
                 overlap_ratios=(0.0, 0.5, 0.25),
                 scaled_dims=(1024, 1024, 512), hook_ids=(11, 5),
                 hook_dims=(256, 256), fusion_dim: int = 256,
                 merge_padding: int = 3, num_fov_layers: int = 2,
                 use_fov: bool = True, quant: str = "none", gelu: str = "erf",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        E, P = encoder_size, patch_size
        if E % P:
            raise ValueError("encoder_size must be a patch multiple")
        self.patch_size, self.encoder_size = P, E
        self.scaled_ratios = tuple(scaled_ratios)
        self.overlap_ratios = tuple(overlap_ratios)
        self.hook_ids = tuple(hook_ids)
        self.merge_padding = merge_padding
        self.use_fov = use_fov
        self.dtype = dtype

        def vit(hooks=()):
            # The JAX trunks keep the size-based position mapping (offset
            # 0); at 384^2 the table needs no resize.
            return VisionTransformer(
                P, vit_dim, vit_depth, vit_heads, pretrain_grid=E // P,
                layerscale=True, use_depth_fusion=False, dtype=dtype,
                device=device, pos_interp_offset=0.0, final_norm=True,
                out_layers=hooks, quant=quant, gelu=gelu)

        def conv(name, cin, cout, k, stride=1, padding=0, bias=True):
            self.add_module(name, Conv(cin, cout, k, stride, padding, bias,
                                       dtype, device))

        def deconv(name, cin, cout, bias=True):
            self.add_module(name, ConvTranspose(cin, cout, bias, dtype,
                                                device))

        self.patch_encoder = vit(self.hook_ids)
        self.image_encoder = vit()
        if use_fov:
            self.fov_encoder = vit()
            self.fov_neck = Dense(vit_dim, fusion_dim // 2, dtype,
                                  device=device)
            conv("fov_conv", fusion_dim, fusion_dim // 2, 3, 2, 1)
        deconv("up_image", vit_dim, scaled_dims[0])
        for i, d in enumerate(scaled_dims):
            conv(f"up_scaled{i}_proj", vit_dim, d, 1, bias=False)
            deconv(f"up_scaled{i}_deconv", d, d, bias=False)
        for i, d in enumerate(hook_dims):
            inter = fusion_dim if i == 0 else d
            conv(f"up_hook{i}_proj", vit_dim, inter, 1, bias=False)
            for j in range(2 + i):
                deconv(f"up_hook{i}_deconv{j}", inter if j == 0 else d, d,
                       bias=False)
        conv("fuse_lowres", 2 * scaled_dims[0], scaled_dims[0], 1)
        dims = tuple(scaled_dims) + tuple(hook_dims)
        # The last projection is dropped when its width already matches.
        self.n_project = len(dims) - (1 if dims[-1] == fusion_dim else 0)
        for i in range(self.n_project):
            conv(f"project{i}", dims[i], fusion_dim, 3, padding=1, bias=False)
        self.n_fuse = len(dims)
        for i in range(self.n_fuse):
            self.add_module(f"fusion{i}", FusionLayer(
                fusion_dim, use_deconv=i < self.n_fuse - 1, with_skip=i > 0,
                dtype=dtype, device=device))
        conv("head_conv1", fusion_dim, fusion_dim // 2, 3, padding=1)
        deconv("head_deconv", fusion_dim // 2, fusion_dim // 2)
        conv("head_conv2", fusion_dim // 2, 32, 3, padding=1)
        conv("head_out", 32, 1, 1)
        if use_fov:
            self.out_size = E // P
            self.num_fov_layers = num_fov_layers
            cin = fusion_dim // 2
            for i in range(num_fov_layers):
                cout = -(-fusion_dim // 2 ** (i + 2))
                conv(f"fov_head{i}", cin, cout, 3, 2, 1)
                cin = cout
            k = int((self.out_size - 1) / 2**num_fov_layers + 1)
            conv("fov_head_out", cin, 1, k)

    # -- stages, in the JAX module's order; forward is their composition --

    def pyramid_patches(self, images: torch.Tensor):
        """The image pyramid as one batch of overlapping crops, the
        full-resolution level first, and the per-level crop counts (lowest
        level first)."""
        B, H = images.shape[0], images.shape[1]
        per_scale = []
        for ratio, ov in zip(self.scaled_ratios, self.overlap_ratios):
            scaled = _resize(images, (int(H * ratio), int(H * ratio)))
            per_scale.append(split_to_patches(scaled, self.encoder_size, ov))
        counts = [p.shape[0] // B for p in per_scale]
        return torch.cat(per_scale[::-1], dim=0), counts

    def encode_patches(self, patches: torch.Tensor) -> dict:
        return self.patch_encoder(patches)

    def encode_image(self, global_img: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(global_img)["last_feat"]

    def encode_fov_trunk(self, global_img: torch.Tensor) -> torch.Tensor:
        return self.fov_encoder(global_img)["last_feat"]

    def decode_features(self, enc: dict, img_feat: torch.Tensor,
                        fov_feat: torch.Tensor | None, batch: int,
                        counts) -> dict:
        """Patch-grid merge and reassembly, the neck, the fusion decoder,
        the depth head and the FOV head."""
        B = batch
        base = self.encoder_size // self.patch_size
        last = enc["last_feat"]
        feats, start = [], 0
        for n in [c * B for c in list(counts)[::-1]]:
            feats.append(last[start:start + n])
            start += n
        feats = feats[::-1]
        scaled_feats = []
        for i, (f, ratio) in enumerate(zip(feats, self.scaled_ratios)):
            merged = merge_patches(f, B, int(self.merge_padding / ratio))
            scaled_feats.append(_resize(merged, (base * 2**i,) * 2))
        hook_feats = []
        tgt = base * 2 ** (len(self.scaled_ratios) - 1)
        for hook in self.hook_ids:
            merged = merge_patches(
                enc[f"feat{hook}"], B,
                int(self.merge_padding / self.scaled_ratios[-1]))
            hook_feats.append(_resize(merged, (tgt, tgt)))
        img_feat = _resize(img_feat, (base, base))

        img_up = self.up_image(img_feat)
        sc_up = [getattr(self, f"up_scaled{i}_deconv")(
                     getattr(self, f"up_scaled{i}_proj")(f))
                 for i, f in enumerate(scaled_feats)]
        hk_up = []
        for i, f in enumerate(hook_feats):
            f = getattr(self, f"up_hook{i}_proj")(f)
            for j in range(2 + i):
                f = getattr(self, f"up_hook{i}_deconv{j}")(f)
            hk_up.append(f)
        glob = self.fuse_lowres(torch.cat([sc_up[0], img_up], dim=-1))
        pyramid = [glob, *sc_up[1:], *hk_up]
        pyramid = [getattr(self, f"project{i}")(f) if i < self.n_project
                   else f for i, f in enumerate(pyramid)]

        x = self.fusion0(pyramid[0])
        for i in range(1, self.n_fuse):
            x = getattr(self, f"fusion{i}")(x, pyramid[i])
        x = self.head_deconv(self.head_conv1(x))
        x = F.relu(self.head_conv2(x))
        inv_depth = F.relu(self.head_out(x))[..., 0]

        if self.use_fov:
            fov_feat = _resize(self.fov_neck(fov_feat), (base, base))
            g = F.relu(self.fov_conv(pyramid[0].detach()))
            h = _resize(fov_feat + g, (self.out_size, self.out_size))
            for i in range(self.num_fov_layers):
                h = F.relu(getattr(self, f"fov_head{i}")(h))
            fov = self.fov_head_out(h).reshape(B)
        else:
            fov = inv_depth.new_zeros(B)
        return {"canonical_inverse_depth": inv_depth.float(),
                "fov_deg": fov.float()}

    def forward(self, images: torch.Tensor) -> dict:
        """images: [B, S, S, 3] normalized, S a power-of-two multiple of
        encoder_size / patch_size and S / 4 >= encoder_size. Returns
        canonical_inverse_depth [B, S, S] and fov_deg [B], f32."""
        B, H = images.shape[0], images.shape[1]
        E = self.encoder_size
        out_size = E // self.patch_size
        if H % out_size or (H // out_size) & (H // out_size - 1):
            raise ValueError(f"input side {H} must be a power-of-two "
                             f"multiple of {out_size}")
        if int(H * min(self.scaled_ratios)) < E:
            raise ValueError(f"input side {H} too small: the lowest pyramid "
                             f"level must be at least encoder_size={E}")
        patches, counts = self.pyramid_patches(images)
        enc = self.encode_patches(patches)
        global_img = _resize(images, (E, E))
        img_feat = self.encode_image(global_img)
        fov_feat = self.encode_fov_trunk(global_img) if self.use_fov else None
        return self.decode_features(enc, img_feat, fov_feat, B, counts)

    def trunks(self) -> list[VisionTransformer]:
        out = [self.patch_encoder, self.image_encoder]
        return out + [self.fov_encoder] if self.use_fov else out

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults for the decoder and heads, the trunks' own
        initializers for the trunks."""
        init_flax_defaults(self, generator)
        for vit in self.trunks():
            vit.init_weights(generator)


def metric_depth(canonical_inverse_depth: torch.Tensor, f_px: torch.Tensor,
                 width: int, min_depth: float = 0.1,
                 max_depth: float = 250.0) -> torch.Tensor:
    """depth = 1 / (c_inv * W / f_px), clamped to [min_depth, max_depth].
    canonical_inverse_depth: [B, H, W]; f_px: [B] focal length in pixels."""
    inv = canonical_inverse_depth * (width / f_px[:, None, None])
    return torch.clamp(1.0 / torch.clamp(inv, min=1.0 / max_depth),
                       min_depth, max_depth)


def fov_to_focal(fov_deg: torch.Tensor, width: int) -> torch.Tensor:
    """Horizontal FOV (degrees) -> focal length in pixels."""
    return 0.5 * width / torch.tan(0.5 * torch.deg2rad(fov_deg))
