"""Colorspace conversion ops (port of flutpu/codec/ops/colorspace.py).

RGB↔YCbCr (BT.601 full-range, the JPEG/JFIF convention) as three
scalar-weighted plane sums, in the original's expression order so the
two packages agree bit for bit in fp32; 4:2:0 chroma down/upsampling via
reshape-mean / repeat.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import on_device

# BT.601 full-range RGB -> YCbCr (JFIF); copy of
# flutpu.codec.ops.colorspace._RGB2YCBCR
_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168735892, -0.331264108, 0.5],
     [0.5, -0.418687589, -0.081312411]], dtype=np.float32)
_YCBCR2RGB = np.linalg.inv(_RGB2YCBCR).astype(np.float32)
_YCBCR_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)


def ycbcr_from_channels(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Three same-shaped RGB channel planes → (y, cb, cr) float32 planes.
    Each product is rounded to fp32 before the sum, left to right, as
    the original computes it (``m[0, 0] * r + m[0, 1] * g + m[0, 2] * b``)."""
    r = r.to(torch.float32)
    g = g.to(torch.float32)
    b = b.to(torch.float32)
    m = [[float(v) for v in row] for row in _RGB2YCBCR]
    y = m[0][0] * r + m[0][1] * g + m[0][2] * b
    cb = m[1][0] * r + m[1][1] * g + m[1][2] * b + 128.0
    cr = m[2][0] * r + m[2][1] * g + m[2][2] * b + 128.0
    return y, cb, cr


def rgb_to_ycbcr_planes(rgb: torch.Tensor):
    """[..., H, W, 3] uint8/float RGB → (y, cb, cr) float32 planes, by
    ``ycbcr_from_channels`` on the three channels."""
    x = rgb.to(torch.float32)
    return ycbcr_from_channels(x[..., 0], x[..., 1], x[..., 2])


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8/float RGB → float32 YCbCr (Y in [0,255],
    Cb/Cr centred at 128)."""
    return torch.stack(rgb_to_ycbcr_planes(rgb), dim=-1)


def subsample_420(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] → [..., H/2, W/2] by 2x2 box mean. H and W even.
    The four samples are summed in row-major order, left to right, as
    the original's ``mean`` sums them (a pairwise sum rounds differently
    in the last bit)."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 2, 2, w // 2, 2)
    s = x[..., 0, :, 0] + x[..., 0, :, 1] + x[..., 1, :, 0] + x[..., 1, :, 1]
    return s / 4.0


def upsample_420(plane: torch.Tensor) -> torch.Tensor:
    """[..., H/2, W/2] → [..., H, W] by nearest-neighbour replication."""
    return plane.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def planes_to_i420(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """(r, g, b) planes → (Y, Cb/2, Cr/2) float32 planes."""
    y, cb, cr = ycbcr_from_channels(r, g, b)
    return y, subsample_420(cb), subsample_420(cr)


def rgb_to_i420(rgb: torch.Tensor):
    """[..., H, W, 3] RGB → (Y [...,H,W], Cb [...,H/2,W/2], Cr) planes."""
    return planes_to_i420(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def ycbcr_to_rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] float YCbCr → float32 RGB in [0,255] (unclipped)."""
    off = on_device("ycbcr_offset", _YCBCR_OFFSET, ycbcr.device)
    m = on_device("ycbcr_to_rgb", _YCBCR2RGB.T, ycbcr.device)
    return (ycbcr.to(torch.float32) - off) @ m


def i420_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                cr: torch.Tensor) -> torch.Tensor:
    """I420 planes → [..., H, W, 3] float RGB in [0,255] (unclipped)."""
    return ycbcr_to_rgb(
        torch.stack([y, upsample_420(cb), upsample_420(cr)], dim=-1))


def scale_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [..., H, W] or [..., H, W, C] to float32
    (half-pixel centres, no corner alignment; a triangle filter widened by
    the scale when shrinking, as ``jax.image.resize`` does)."""
    has_c = img.dim() >= 3 and img.shape[-1] <= 4
    x = img if has_c else img[..., None]
    *lead, h, w, c = x.shape
    x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).to(torch.float32)
    out = torch.nn.functional.interpolate(
        x, size=(out_h, out_w), mode="bilinear", align_corners=False,
        antialias=True)
    out = out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)
    return out if has_c else out[..., 0]
