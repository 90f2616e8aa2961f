"""Device instance compositor — renders a TTML interval from a z-ordered
instance stream against the glyph atlas, entirely on the device (port of
flutpu/ttml/render/device.py).

The host emits a compact instance table (tile index, destination, size,
color, clip rect) and the compositor source-over-blends every instance
into the window in order. flutpu's compositor is an XLA program (a
``fori_loop`` of dynamic slices), not a hand-written TPU kernel; the port
is plain PyTorch. The host knows every instance's position (the tables
are numpy), so a static slice of the working window takes the place of
``dynamic_slice``, and each instance is a handful of elementwise launches
on one (TILE_H, TILE_W) tile.

The arithmetic is flutpu's, on the same pixels in the same order: the
whole tile of every instance is blended, masked pixels (source alpha 0)
and the no-op padding instances included, because
``dst * da / max(out_a, 1e-6)`` is not the identity in float32 and each
pass can move a stored colour by an ulp.

Instance encoding:
  ints  (N, 9) int32: tile, x, y, w, h, clip_x0, clip_y0, clip_x1, clip_y1
        (x/y may be negative: the slice start is clamped and the clip rect
        carries the true geometry)
  cols  (N, 4) float32: r, g, b, effective_alpha (style alpha × region
        opacity), 0..1
Clip rects implement region overflow semantics: hidden clips to the region
box, visible clips to the window.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .atlas import TILE_H, TILE_W
from .composite import _to_bgra_u8, _unit


def composite_instances(atlas: torch.Tensor, ints: np.ndarray,
                        cols: np.ndarray, window_h: int, window_w: int,
                        imgatlas: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Blend one interval's N instances into a transparent
    (window_h, window_w, 4) uint8 BGRA window on the atlas's device
    (flutpu's ``_composite_core``). atlas: (T, TILE_H, TILE_W) uint8 tensor;
    ints, cols: host arrays. ``imgatlas`` (M, TILE_H, TILE_W, 4) uint8
    serves instances with NEGATIVE tile ids (-idx-1): per-pixel-color RGBA
    tiles (SMPTE background images). See module doc for encoding."""
    dev = atlas.device
    ints = np.asarray(ints, np.int64)
    cols_t = torch.as_tensor(np.asarray(cols, np.float32), device=dev)
    # working window padded by a tile on every side so the tile-sized
    # slices of clamped placements never leave it
    ph, pw = window_h + 2 * TILE_H, window_w + 2 * TILE_W
    frame = torch.zeros((ph, pw, 4), dtype=torch.float32, device=dev)
    yy = torch.arange(TILE_H, device=dev)[:, None]
    xx = torch.arange(TILE_W, device=dev)[None, :]

    for i in range(ints.shape[0]):
        tile_idx, x, y, w, h, cx0, cy0, cx1, cy1 = (int(v) for v in ints[i])
        x, cx0, cx1 = x + TILE_W, cx0 + TILE_W, cx1 + TILE_W  # padded coords
        y, cy0, cy1 = y + TILE_H, cy0 + TILE_H, cy1 + TILE_H
        if tile_idx < 0 and imgatlas is not None:
            # an index past either atlas clamps into it, as a dynamic
            # slice's start does
            img = imgatlas[min(-tile_idx - 1, imgatlas.shape[0] - 1)]
            alpha = _unit(img[..., 3])
            src_rgb = _unit(img[..., :3])
        else:
            tile = atlas[min(max(tile_idx, 0), atlas.shape[0] - 1)]
            alpha = _unit(tile)
            src_rgb = cols_t[i, :3]
        # valid-extent mask + clip-rect mask in window coordinates
        gx = xx + x
        gy = yy + y
        mask = ((xx < w) & (yy < h) &
                (gx >= cx0) & (gx < cx1) & (gy >= cy0) & (gy < cy1))
        sa = alpha * cols_t[i, 3]
        sa = torch.where(mask, sa, 0.0)[..., None]
        # the slice start clamps into the padded window (the mask keeps
        # the true geometry)
        sy = min(max(y, 0), ph - TILE_H)
        sx = min(max(x, 0), pw - TILE_W)
        dst = frame[sy:sy + TILE_H, sx:sx + TILE_W]
        da = dst[..., 3:]
        out_a = sa + da * (1 - sa)
        rgb = (src_rgb * sa + dst[..., :3] * da * (1 - sa)) \
            / out_a.clamp(min=1e-6)
        frame[sy:sy + TILE_H, sx:sx + TILE_W] = torch.cat([rgb, out_a],
                                                          dim=-1)

    return _to_bgra_u8(frame[TILE_H:TILE_H + window_h,
                             TILE_W:TILE_W + window_w])


def composite_instances_batch(atlas, ints, cols, window_h: int,
                              window_w: int, unstack: bool = False,
                              imgatlas=None):
    """Composite a whole batch of intervals.

    ints: (K, N, 9) int32, cols: (K, N, 4) float32 — K intervals, each
    padded to a common instance cap. Returns (K, window_h, window_w, 4)
    uint8 BGRA on the atlas's device, or with ``unstack`` a K-tuple of
    per-interval tensors. The intervals render one after the other (as
    flutpu's ``lax.map``); what the batch saves on the card is one fetch
    for the lot where the caller brings the windows to the host."""
    out = tuple(composite_instances(atlas, ints[k], cols[k], window_h,
                                    window_w, imgatlas)
                for k in range(len(ints)))
    return out if unstack else torch.stack(out)


def composite_instances_batch_vmap(atlas, ints, cols, window_h: int,
                                   window_w: int, unstack: bool = False):
    """``composite_instances_batch`` across intervals at once (flutpu's
    ``composite_instances_batch_vmap``): one loop over the instance cap,
    each step blending instance i of every interval together with
    batched gathers and scatters, so the chain is N steps long, not K x
    N. ints: (K, N, 9) int32, cols: (K, N, 4) float32, host arrays; a
    tile index clamps into the atlas (no image atlas, as in flutpu).
    Returns (K, window_h, window_w, 4) uint8 BGRA on the atlas's device,
    or with ``unstack`` a K-tuple; pixel for pixel
    ``composite_instances_batch``'s."""
    dev = atlas.device
    ints = np.asarray(ints, np.int64)
    k, n = ints.shape[:2]
    cols_t = torch.as_tensor(np.asarray(cols, np.float32), device=dev)
    ph, pw = window_h + 2 * TILE_H, window_w + 2 * TILE_W
    frames = torch.zeros((k, ph, pw, 4), dtype=torch.float32, device=dev)
    # per (interval, instance), in padded coordinates: the tile, the
    # extent and clip rect, and the clamped slice's rows and columns
    tile = np.clip(ints[..., 0], 0, atlas.shape[0] - 1)
    x, y = ints[..., 1] + TILE_W, ints[..., 2] + TILE_H
    geo = np.stack([x, y, ints[..., 3], ints[..., 4],
                    ints[..., 5] + TILE_W, ints[..., 6] + TILE_H,
                    ints[..., 7] + TILE_W, ints[..., 8] + TILE_H], axis=-1)
    sy = np.clip(y, 0, ph - TILE_H)[..., None] + np.arange(TILE_H)
    sx = np.clip(x, 0, pw - TILE_W)[..., None] + np.arange(TILE_W)
    tile_t = torch.as_tensor(tile, device=dev)
    geo_t = torch.as_tensor(geo, device=dev)[..., None, None]
    rows_t = torch.as_tensor(sy, device=dev)[..., :, None]
    cols_ix = torch.as_tensor(sx, device=dev)[..., None, :]
    kk = torch.arange(k, device=dev)[:, None, None]
    yy = torch.arange(TILE_H, device=dev)[:, None]
    xx = torch.arange(TILE_W, device=dev)[None, :]
    for i in range(n):
        g = geo_t[:, i]
        gx, gy = xx + g[:, 0], yy + g[:, 1]
        mask = ((xx < g[:, 2]) & (yy < g[:, 3]) & (gx >= g[:, 4])
                & (gx < g[:, 6]) & (gy >= g[:, 5]) & (gy < g[:, 7]))
        sa = _unit(atlas[tile_t[:, i]]) * cols_t[:, i, 3, None, None]
        sa = torch.where(mask, sa, 0.0)[..., None]
        at = (kk, rows_t[:, i], cols_ix[:, i])
        dst = frames[at]
        da = dst[..., 3:]
        out_a = sa + da * (1 - sa)
        rgb = (cols_t[:, i, None, None, :3] * sa
               + dst[..., :3] * da * (1 - sa)) / out_a.clamp(min=1e-6)
        frames[at] = torch.cat([rgb, out_a], dim=-1)
    out = _to_bgra_u8(frames[:, TILE_H:TILE_H + window_h,
                             TILE_W:TILE_W + window_w])
    return tuple(out[i] for i in range(k)) if unstack else out


def composite_instances_over(atlas, ints, cols, base_bgra, window_h: int,
                             window_w: int, imgatlas=None) -> torch.Tensor:
    """Like composite_instances but blending OVER an existing BGRA window
    (host-layer content below the instance stream). As in flutpu, the
    result keeps the channel order of its two BGRA inputs."""
    top = composite_instances(atlas, ints, cols, window_h, window_w,
                              imgatlas)
    t = _unit(top)
    b = _unit(torch.as_tensor(base_bgra, device=top.device))
    ta = t[..., 3:]
    out_a = ta + b[..., 3:] * (1 - ta)
    rgb = (t[..., :3] * ta + b[..., :3] * b[..., 3:] * (1 - ta)) \
        / out_a.clamp(min=1e-6)
    out = torch.cat([rgb, out_a], dim=-1)
    return (out * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)


class InstanceList:
    """Host-side list of the instance stream of one interval."""

    def __init__(self):
        self.ints: List[Tuple[int, ...]] = []
        self.cols: List[Tuple[float, float, float, float]] = []

    def add_entry(self, entry, x: int, y: int, color, alpha_scale: float,
                  clip: Tuple[int, int, int, int]):
        """All tiles of an atlas entry placed with its top-left at (x, y)."""
        for (tile, dx, dy, w, h) in entry.tiles:
            self.add_tile(tile, x + dx, y + dy, w, h, color, alpha_scale,
                          clip)

    def add_tile(self, tile: int, x: int, y: int, w: int, h: int, color,
                 alpha_scale: float, clip: Tuple[int, int, int, int]):
        a = (color[3] / 255.0) * alpha_scale
        if a <= 0.0 or w <= 0 or h <= 0:
            return
        # clamp placement into the padded working range: starts may not be
        # more than one tile outside the window (clip rect keeps geometry)
        self.ints.append((tile, int(x), int(y), int(w), int(h),
                          int(clip[0]), int(clip[1]),
                          int(clip[2]), int(clip[3])))
        self.cols.append((color[0] / 255.0, color[1] / 255.0,
                          color[2] / 255.0, a))

    def add_rect(self, x: int, y: int, w: int, h: int, color,
                 alpha_scale: float, clip: Tuple[int, int, int, int]):
        """Solid rectangle via the reserved all-255 tile 0 (backgrounds,
        underline/strike/overline decoration rects)."""
        for ty in range(0, h, TILE_H):
            for tx in range(0, w, TILE_W):
                self.add_tile(0, x + tx, y + ty,
                              min(TILE_W, w - tx), min(TILE_H, h - ty),
                              color, alpha_scale, clip)

    def filtered(self, window_h: int, window_w: int):
        """(ints, cols) lists with out-of-window instances dropped and
        starts clamped to the one-tile padding margin."""
        out_i: List[Tuple[int, ...]] = []
        out_c = []
        for (t, x, y, w, h, cx0, cy0, cx1, cy1), c in zip(self.ints,
                                                          self.cols):
            if (x + w <= -TILE_W or y + h <= -TILE_H or x >= window_w
                    or y >= window_h):
                continue
            x = max(-TILE_W, min(x, window_w))
            y = max(-TILE_H, min(y, window_h))
            cx0, cy0 = max(cx0, -TILE_W), max(cy0, -TILE_H)
            cx1 = min(cx1, window_w + TILE_W)
            cy1 = min(cy1, window_h + TILE_H)
            out_i.append((t, x, y, w, h, cx0, cy0, cx1, cy1))
            out_c.append(c)
        return out_i, out_c

    def arrays(self, window_h: int, window_w: int):
        """Padded (ints, cols) numpy arrays, instance count rounded to the
        next power of two with no-op instances, as flutpu pads them (the
        compositor blends the padding too, so both packages do the same
        arithmetic on the same pixels)."""
        out_i, out_c = self.filtered(window_h, window_w)
        return pad_instances(out_i, out_c)


def pad_instances(out_i, out_c, cap: Optional[int] = None):
    """Instance lists → (cap, 9) int32 / (cap, 4) float32 arrays padded
    with no-op instances (zero size, zero alpha)."""
    n = max(1, len(out_i))
    if cap is None:
        cap = 1
        while cap < n:
            cap *= 2
    ints = np.zeros((cap, 9), np.int32)
    cols = np.zeros((cap, 4), np.float32)
    if out_i:
        ints[:len(out_i)] = np.asarray(out_i, np.int32)
        cols[:len(out_c)] = np.asarray(out_c, np.float32)
    return ints, cols
