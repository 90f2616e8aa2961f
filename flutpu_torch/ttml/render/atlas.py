"""Glyph/run atlas — device-resident texture cache for the TTML renderer
(port of flutpu/ttml/render/atlas.py).

The host shapes and rasterizes each unique styled text run ONCE (an alpha
map from ``fonts.rasterize_run``), the alpha map is split into fixed-size
tiles and uploaded into a device atlas tensor, and every subsequent
interval that reuses the run costs no host rasterization and no upload —
the device compositor (``render.device``) just references tile indices.

Outline variants (dilate-stroke + gaussian blur) are computed ON THE
DEVICE from the base tiles and cached as additional atlas tiles.

An atlas knows its device: its tile indices, its device tensors and its
stroke computation belong to one ``torch.device``, and ``get_atlas``
keeps one atlas per device, so a CPU render and a card render in one
process never share a tensor. The device tensor grows in power-of-two
tile counts: eager PyTorch has nothing to recompile, but a new tile then
costs the upload of that tile alone, not a reallocation and a copy of the
whole atlas.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

TILE_H = 128
TILE_W = 512


class _Entry:
    __slots__ = ("tiles", "width", "height", "ascent")

    def __init__(self, tiles, width, height, ascent):
        # tiles: list of (tile_idx, dx, dy, w, h) covering the alpha map
        self.tiles = tiles
        self.width = width
        self.height = height
        self.ascent = ascent


def _gauss_taps(blur_px: int) -> np.ndarray:
    """The normalized float32 taps of the stroke blur."""
    sigma = max(blur_px / 2.0, 0.5)
    r = max(1, int(sigma * 3))
    k = np.exp(-(np.arange(-r, r + 1, dtype=np.float32) ** 2)
               / np.float32(2 * sigma * sigma)).astype(np.float32)
    return k / k.sum(dtype=np.float32)


def _stroke_tiles(tiles: torch.Tensor, radius: int,
                  blur_px: int) -> torch.Tensor:
    """Batched device stroke: dilate by ``radius`` (max-pool) + optional
    separable gaussian blur. tiles: (N, TILE_H, TILE_W) uint8 → uint8.

    The blur is a sum of shifted, weighted copies in a fixed order (rows,
    then columns, taps left to right), every product and sum rounded on
    its own: the same float32 result on the CPU and on the card, with no
    TF32 convolution in the way. The cast truncates, as flutpu's, so a
    sum taken in another order (XLA's convolution) can land one level
    apart."""
    x = tiles.to(torch.float32)
    if radius > 0:
        x = torch.nn.functional.max_pool2d(
            x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]
        x = x.clamp(min=0.0)
    if blur_px > 0:
        taps = [float(v) for v in _gauss_taps(blur_px)]
        r = len(taps) // 2
        n, h, w = x.shape
        for dim, size in ((1, h), (2, w)):
            pad = [0, 0, 0, 0]
            pad[(2 - dim) * 2] = pad[(2 - dim) * 2 + 1] = r
            xp = torch.nn.functional.pad(x, pad)
            acc = torch.zeros_like(x)
            for j, k in enumerate(taps):
                acc = acc + xp.narrow(dim, j, size) * k
            x = acc
    return x.clamp(0, 255).to(torch.uint8)


class GlyphAtlas:
    """Host-managed run/tile cache resident on one device.

    Tile 0 is reserved as a solid all-255 tile used for rectangles
    (backgrounds, decorations). The device tensor is materialized lazily
    and only the tiles added since the last sync are uploaded.
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._tiles: List[np.ndarray] = [
            np.full((TILE_H, TILE_W), 255, np.uint8)]
        self._runs: Dict[tuple, _Entry] = {}
        self._stroked: Dict[tuple, _Entry] = {}
        self._device_arr: Optional[torch.Tensor] = None
        self._synced_upto = 0
        # RGBA image tiles (SMPTE background images): a parallel atlas with
        # per-pixel color; instances reference them with NEGATIVE tile
        # indices (-idx-1) so the one instance stream stays homogeneous
        self._img_tiles: List[np.ndarray] = [
            np.zeros((TILE_H, TILE_W, 4), np.uint8)]
        self._images: Dict[tuple, _Entry] = {}
        self._img_device_arr: Optional[torch.Tensor] = None
        self._img_synced_upto = 0

    # -- host-side cache ----------------------------------------------------
    def _add_alpha_map(self, alpha: np.ndarray, ascent: int) -> _Entry:
        h, w = alpha.shape
        tiles = []
        for ty in range(0, max(1, h), TILE_H):
            for tx in range(0, max(1, w), TILE_W):
                sub = alpha[ty:ty + TILE_H, tx:tx + TILE_W]
                tile = np.zeros((TILE_H, TILE_W), np.uint8)
                tile[:sub.shape[0], :sub.shape[1]] = sub
                tiles.append((len(self._tiles), tx, ty,
                              sub.shape[1], sub.shape[0]))
                self._tiles.append(tile)
        return _Entry(tiles, w, h, ascent)

    def run_entry(self, text: str, family: str, size_px: int, bold: bool,
                  italic: bool, par_scale: float = 1.0, rot: int = 0,
                  shear: float = 0.0) -> _Entry:
        """Tiles for a rasterized text run. ``par_scale`` horizontally
        scales the glyph bitmap (anamorphic PAR glyph scaling). ``rot``
        (np.rot90 k: -1 cw for tbrl, +1 ccw for tblr) pre-rotates the
        run's alpha map so vertical writing modes stay on the device path
        with plain axis-aligned tiles. ``shear`` is the reverseOblique
        glyph shear (fonts.rasterize_run)."""
        key = (text, family, size_px, bold, italic, round(par_scale, 4),
               rot, round(shear, 3))
        e = self._runs.get(key)
        if e is None:
            from .fonts import rasterize_run
            alpha, m = rasterize_run(text, family, size_px, bold, italic,
                                     shear=shear)
            if par_scale != 1.0 and alpha.shape[1] > 0:
                new_w = max(1, int(round(alpha.shape[1] * par_scale)))
                alpha = _resize_width(alpha, new_w)
            if rot:
                alpha = np.ascontiguousarray(np.rot90(alpha, rot))
            e = self._add_alpha_map(alpha, m.ascent)
            self._runs[key] = e
        return e

    def stroked_entry(self, text: str, family: str, size_px: int, bold: bool,
                      italic: bool, radius: int, blur_px: int,
                      par_scale: float = 1.0, rot: int = 0,
                      shear: float = 0.0) -> _Entry:
        """Outline variant of a run: computed on the atlas's device from
        the base tiles (dilate + blur), cached as new atlas tiles."""
        key = (text, family, size_px, bold, italic, radius, blur_px,
               round(par_scale, 4), rot, round(shear, 3))
        e = self._stroked.get(key)
        if e is None:
            base = self.run_entry(text, family, size_px, bold, italic,
                                  par_scale, rot, shear)
            idxs = [t[0] for t in base.tiles]
            batch = np.stack([self._tiles[i] for i in idxs])
            stroked = _stroke_tiles(
                torch.from_numpy(batch).to(self.device), int(radius),
                int(blur_px)).cpu().numpy()
            tiles = []
            for ((_, dx, dy, w, h), arr) in zip(base.tiles, stroked):
                tiles.append((len(self._tiles), dx, dy, w, h))
                self._tiles.append(arr)
            e = _Entry(tiles, base.width, base.height, base.ascent)
            self._stroked[key] = e
        return e

    def image_entry(self, rgba: np.ndarray, rot: int = 0) -> _Entry:
        """Tiles for a decoded RGBA image (SMPTE backgroundImage): tiled
        into the RGBA atlas, instances carry -idx-1 tile ids. Cached by
        CONTENT hash — two documents may bind the same #id to different
        images, so a reference-string key would alias them."""
        import hashlib
        if rot:
            rgba = np.ascontiguousarray(np.rot90(rgba, rot))
        key = (rgba.shape, hashlib.sha1(
            np.ascontiguousarray(rgba).tobytes()).hexdigest())
        e = self._images.get(key)
        if e is None:
            h, w = rgba.shape[:2]
            if rgba.ndim == 2:
                rgba = np.stack([rgba] * 3 + [np.full_like(rgba, 255)],
                                axis=-1)
            if rgba.shape[-1] == 3:
                rgba = np.concatenate(
                    [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)],
                    axis=-1)
            tiles = []
            for ty in range(0, max(1, h), TILE_H):
                for tx in range(0, max(1, w), TILE_W):
                    sub = rgba[ty:ty + TILE_H, tx:tx + TILE_W]
                    tile = np.zeros((TILE_H, TILE_W, 4), np.uint8)
                    tile[:sub.shape[0], :sub.shape[1]] = sub
                    tiles.append((-len(self._img_tiles) - 1, tx, ty,
                                  sub.shape[1], sub.shape[0]))
                    self._img_tiles.append(tile)
            e = _Entry(tiles, w, h, 0)
            self._images[key] = e
        return e

    # -- device sync ---------------------------------------------------------
    def _sync(self, host: List[np.ndarray], arr: Optional[torch.Tensor],
              upto: int, min_cap: int) -> torch.Tensor:
        """``arr`` grown to the next power of two that holds ``host`` (the
        old tiles copied on the device), with tiles ``upto``.. uploaded."""
        n = len(host)
        cap = min_cap
        while cap < n:
            cap *= 2
        if arr is None or arr.shape[0] != cap:
            grown = torch.zeros((cap,) + host[0].shape, dtype=torch.uint8,
                                device=self.device)
            if arr is not None:
                grown[:upto] = arr[:upto]
            else:
                upto = 0
            arr = grown
        if upto < n:
            arr[upto:n] = torch.from_numpy(np.stack(host[upto:n])) \
                .to(self.device)
        return arr

    def image_device_array(self) -> torch.Tensor:
        """The RGBA image atlas as an (M, TILE_H, TILE_W, 4) uint8 tensor
        on the atlas's device (M >= 1; index 0 is a transparent dummy)."""
        self._img_device_arr = self._sync(
            self._img_tiles, self._img_device_arr, self._img_synced_upto, 1)
        self._img_synced_upto = len(self._img_tiles)
        return self._img_device_arr

    def device_array(self) -> torch.Tensor:
        """The atlas as an (N, TILE_H, TILE_W) uint8 tensor on the atlas's
        device; N grows in powers of two."""
        self._device_arr = self._sync(
            self._tiles, self._device_arr, self._synced_upto, 16)
        self._synced_upto = len(self._tiles)
        return self._device_arr

    def clear(self):
        self.__init__(self.device)


def atlas_from_numpy(tiles, img_tiles=None, device="cuda") -> GlyphAtlas:
    """An atlas holding given tiles (e.g. flutpu's ``GlyphAtlas._tiles``
    and ``_img_tiles``: sequences of (TILE_H, TILE_W) and
    (TILE_H, TILE_W, 4) uint8 arrays, tile 0 of each included), so that
    the same instance tables address the same pixels in both packages. It
    has no run cache."""
    atlas = GlyphAtlas(device)
    atlas._tiles = [np.ascontiguousarray(t, np.uint8) for t in tiles]
    if img_tiles is not None:
        atlas._img_tiles = [np.ascontiguousarray(t, np.uint8)
                            for t in img_tiles]
    if not atlas._tiles or not atlas._img_tiles:
        raise ValueError("an atlas holds at least tile 0")
    for t in atlas._tiles:
        if t.shape != (TILE_H, TILE_W):
            raise ValueError(f"atlas tile of shape {t.shape}")
    for t in atlas._img_tiles:
        if t.shape != (TILE_H, TILE_W, 4):
            raise ValueError(f"image tile of shape {t.shape}")
    return atlas


def _resize_width(alpha: np.ndarray, new_w: int) -> np.ndarray:
    """Horizontal resample of an alpha map (PAR anamorphic scaling)."""
    try:
        from PIL import Image
        img = Image.fromarray(alpha, "L").resize(
            (new_w, alpha.shape[0]), Image.BILINEAR)
        return np.asarray(img, np.uint8)
    except ImportError:
        idx = np.clip((np.arange(new_w) * alpha.shape[1] // max(1, new_w)),
                      0, alpha.shape[1] - 1)
        return alpha[:, idx]


_atlases: Dict[torch.device, GlyphAtlas] = {}


def _resolve_device(device) -> torch.device:
    """``device`` with its index filled in ("cuda" names the current
    card), so that one card has one atlas."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def get_atlas(device="cuda") -> GlyphAtlas:
    """The process-wide atlas of ``device`` (one per device)."""
    device = _resolve_device(device)
    atlas = _atlases.get(device)
    if atlas is None:
        atlas = _atlases[device] = GlyphAtlas(device)
    return atlas
