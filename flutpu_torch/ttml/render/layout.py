"""Region/text layout engine (host side).

Rebuild of the layout half of plugins/ttml/gstttmlrender.c (build_layouts
:591-939, store_layout :199-289): group active spans into zIndex-ordered
regions, expand region styles with span overrides, break text into lines
(hard breaks from <br>/</p> newlines, soft wrap to the region width),
apply alignment, and draw each region into an RGBA layer — text alpha maps
from flutpu.ttml.render.fonts, decorations as rects, outlines as blurred
strokes. The resulting layers are composited on-device
(flutpu.ttml.render.composite).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..attributes import Attribute, Length, TextOutline
from ..enums import (AttrType, Direction, DisplayAlign, FontStyle, FontWeight,
                     LengthUnit, Overflow, ShowBackground, TextAlign,
                     TextDecoration, UnicodeBidi, WrapOption, WritingMode)
from ..span import Span
from ..style import Style
from .fonts import RunMetrics, measure_run, rasterize_run

DEFAULT_WINDOW_W = 720
DEFAULT_WINDOW_H = 576


def _rgba_tuple(color: int) -> Tuple[int, int, int, int]:
    return ((color >> 24) & 0xFF, (color >> 16) & 0xFF,
            (color >> 8) & 0xFF, color & 0xFF)


@dataclass
class RunSpec:
    text: str
    family: str
    size_px: int
    bold: bool
    italic: bool
    color: Tuple[int, int, int, int]
    bgcolor: Optional[Tuple[int, int, int, int]]
    decorations: TextDecoration
    outline: Optional[TextOutline]
    outline_color: Tuple[int, int, int, int]
    rtl: bool = False  # RTL base direction (affects run order + alignment)
    shear: float = 0.0  # glyph shear: reverseOblique renders the regular
    #                     face leaning LEFT (reference custom pango attr +
    #                     matrix shear, gstttmlrender.c:858-898)
    hscale: float = 1.0  # anamorphic two-length fontSize: glyph widths
    #                      scale by horizontal/vertical (reference
    #                      gstttmlrender.c:745-857 shape attrs; composes
    #                      with the region-wide PAR scale)
    metrics: RunMetrics = None  # filled during measuring

    def measure(self) -> RunMetrics:
        if self.metrics is None:
            self.metrics = measure_run(self.text, self.family, self.size_px,
                                       self.bold, self.italic)
        return self.metrics


@dataclass
class RegionLayout:
    region_id: str
    x: int
    y: int
    width: int
    height: int
    zindex: int
    layer: np.ndarray  # (height, width, 4) uint8 RGBA, region content
    opacity: float = 1.0


def _style_lengths_px(style: Style, attr_type: AttrType, n: int,
                      defaults: List[float]) -> List[float]:
    a = style.get(attr_type)
    out = list(defaults)
    if a is None:
        return out
    vals = a.value if isinstance(a.value, list) else [a.value]
    for i in range(min(n, len(vals))):
        l = vals[i]
        if isinstance(l, Length) and l.present:
            out[i] = l.value
    return out


def _style_enum(style: Style, attr_type: AttrType, default):
    a = style.get(attr_type)
    return a.value if a is not None else default


class _StyleChain:
    """Span style with region-style fallback (the reference's region style
    expansion with span overrides, gstttmlrender.c:591-661)."""

    def __init__(self, span_style: Style, region_style: Optional[Style]):
        self._span = span_style
        self._region = region_style

    def get(self, atype: AttrType):
        a = self._span.get(atype)
        if a is None and self._region is not None:
            return self._region.get(atype)
        return a


def extract_runs(spans: List[Span], region_id: Optional[str],
                 defaults: dict,
                 region_style: Optional[Style] = None) -> List[List[RunSpec]]:
    """Lines of runs for one region: split span chars on hard newlines,
    carry per-span styles (span style overrides region style)."""
    lines: List[List[RunSpec]] = [[]]
    for span in spans:
        if (span.region_id or None) != region_id:
            continue
        style = _StyleChain(span.style, region_style)
        display = style.get(AttrType.DISPLAY)
        if display is not None and not display.value:
            continue
        visible = style.get(AttrType.VISIBILITY)
        font_sizes = _style_lengths_px(style, AttrType.FONT_SIZE, 2,
                                       [defaults["font_size"]] * 2)
        # hostile-input clamp: unbounded font sizes would rasterize
        # decompression-bomb-sized glyph bitmaps (fuzz-found)
        max_fs = max(64, 4 * int(defaults.get("frame_h") or 576))
        font_sizes = [min(f, max_fs) for f in font_sizes]
        # two-length fontSize is anamorphic: first = horizontal, second =
        # vertical — the point size is the VERTICAL length and glyph
        # widths scale by horizontal/vertical (reference:
        # gstttmlstyle.c:181-199 size2 override, gstttmlrender.c:745-857
        # per-glyph shape attrs with hscale = len0/len1)
        size_px = font_sizes[0]
        hscale = 1.0
        fs_attr = style.get(AttrType.FONT_SIZE)
        if fs_attr is not None and isinstance(fs_attr.value, list) \
                and len(fs_attr.value) > 1 \
                and isinstance(fs_attr.value[1], Length) \
                and fs_attr.value[1].present and font_sizes[1] > 0:
            size_px = font_sizes[1]
            hscale = font_sizes[0] / font_sizes[1]
        color_attr = style.get(AttrType.COLOR)
        color = _rgba_tuple(color_attr.value) if color_attr is not None \
            else (255, 255, 255, 255)
        if visible is not None and not visible.value:
            color = (color[0], color[1], color[2], 0)  # invisible, keeps space
        bg_attr = style.get(AttrType.BACKGROUND_COLOR)
        bgcolor = _rgba_tuple(bg_attr.value) if bg_attr is not None else None
        family_attr = style.get(AttrType.FONT_FAMILY)
        family = family_attr.value if family_attr is not None else \
            defaults["font_family"]
        fstyle = _style_enum(style, AttrType.FONT_STYLE, FontStyle.NORMAL)
        # reverseOblique: regular face + negative shear (advances keep the
        # regular-face widths, like the reference's sheared glyphs)
        shear = -0.21 if fstyle == FontStyle.REVERSE_OBLIQUE else 0.0
        fweight = _style_enum(style, AttrType.FONT_WEIGHT, FontWeight.NORMAL)
        deco = _style_enum(style, AttrType.TEXT_DECORATION,
                           TextDecoration.NONE)
        outline_attr = style.get(AttrType.TEXT_OUTLINE)
        outline = outline_attr.value if outline_attr is not None and \
            isinstance(outline_attr.value, TextOutline) and \
            outline_attr.value.present else None
        out_color = color
        if outline is not None and not outline.use_current_color:
            out_color = _rgba_tuple(outline.color)
        direction = _style_enum(style, AttrType.DIRECTION, Direction.LTR)
        bidi = _style_enum(style, AttrType.UNICODE_BIDI, UnicodeBidi.NORMAL)

        text = span.chars
        rtl = direction == Direction.RTL
        if rtl and bidi == UnicodeBidi.BIDI_OVERRIDE:
            # unicodeBidi=bidiOverride forces visual order regardless of
            # script: the reference implements this as a glyph-reversing
            # custom pango attribute (gstttmlrender.c:858-898). Plain
            # direction=rtl must NOT reverse characters — it sets the base
            # direction (run order within the line + start/end mapping).
            text = "\n".join(part[::-1] for part in text.split("\n"))
        for i, frag in enumerate(text.split("\n")):
            if i > 0:
                lines.append([])
            if not frag:
                continue
            lines[-1].append(RunSpec(
                frag, family, int(round(size_px)),
                fweight == FontWeight.BOLD,
                fstyle in (FontStyle.ITALIC, FontStyle.OBLIQUE),
                color, bgcolor, deco, outline, out_color, rtl, shear,
                hscale))
    # RTL base direction lays runs out right-to-left within the line
    for line in lines:
        if any(r.rtl for r in line):
            line.reverse()
    return [l for l in lines]


def wrap_lines(lines: List[List[RunSpec]], max_width: int,
               wrap: bool) -> List[List[RunSpec]]:
    """Soft-wrap run lines to max_width, breaking at spaces."""
    if not wrap or max_width <= 0:
        return [l for l in lines if l]
    out: List[List[RunSpec]] = []
    for line in lines:
        if not line:
            continue
        cur: List[RunSpec] = []
        cur_w = 0
        for run in line:
            words = run.text.split(" ")
            pending = ""
            for wi, word in enumerate(words):
                token = (" " if wi > 0 or pending else "") + word if pending or wi > 0 else word
                candidate = pending + (" " if pending and word else "") + word
                m = measure_run(candidate, run.family, run.size_px,
                                run.bold, run.italic)
                if cur_w + m.width * run.hscale > max_width \
                        and (pending or cur):
                    # flush what we have
                    if pending:
                        cur.append(RunSpec(pending, run.family, run.size_px,
                                           run.bold, run.italic, run.color,
                                           run.bgcolor, run.decorations,
                                           run.outline, run.outline_color,
                                           run.rtl, run.shear, run.hscale))
                    if cur:
                        out.append(cur)
                    cur = []
                    cur_w = 0
                    pending = word
                else:
                    pending = candidate
            if pending:
                cur.append(RunSpec(pending, run.family, run.size_px,
                                   run.bold, run.italic, run.color,
                                   run.bgcolor, run.decorations,
                                   run.outline, run.outline_color, run.rtl,
                                   run.shear, run.hscale))
                cur_w += measure_run(pending, run.family, run.size_px,
                                     run.bold, run.italic).width \
                    * run.hscale
        if cur:
            out.append(cur)
    return out


def _gaussian_blur_2d(alpha: np.ndarray, radius: float) -> np.ndarray:
    """Separable gaussian blur of an alpha map (reference gstttmlblur.c:
    normalized kernel + pixman convolution; numpy separable conv here —
    region-sized arrays, host-cheap)."""
    if radius <= 0:
        return alpha
    sigma = max(radius / 2.0, 0.5)
    r = max(1, int(sigma * 3))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma * sigma))
    k /= k.sum()
    a = alpha.astype(np.float64)
    a = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, a)
    a = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 0, a)
    return np.clip(a, 0, 255).astype(np.uint8)


def _dilate(alpha: np.ndarray, r: int) -> np.ndarray:
    """Stroke approximation: max-filter with radius r."""
    if r <= 0:
        return alpha
    out = alpha
    for _ in range(r):
        p = np.pad(out, 1)
        out = np.maximum.reduce([
            p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1],
            p[1:-1, :-2], p[1:-1, 2:]])
    return out


def draw_region_layer(width: int, height: int, lines: List[List[RunSpec]],
                      *, padding: Tuple[float, float, float, float] = (0, 0, 0, 0),
                      bgcolor: Optional[Tuple[int, int, int, int]] = None,
                      bg_image: Optional[np.ndarray] = None,
                      bg_image_pos: Tuple[float, float] = (0.5, 0.5),
                      text_align: TextAlign = TextAlign.START,
                      display_align: DisplayAlign = DisplayAlign.BEFORE,
                      line_height_px: Optional[float] = None,
                      overflow_visible: bool = False,
                      writing_mode: WritingMode = WritingMode.LRTB
                      ) -> np.ndarray:
    """Rasterize one region into an RGBA layer (host)."""
    pad_t, pad_r, pad_b, pad_l = padding
    vertical = writing_mode in (WritingMode.TBRL, WritingMode.TBLR,
                                WritingMode.TB)
    # for vertical writing modes we lay out in a rotated canvas
    lw, lh = (height, width) if vertical else (width, height)
    inner_w = max(1, int(lw - pad_l - pad_r))
    layer = np.zeros((lh, lw, 4), dtype=np.uint8)

    if bgcolor is not None and bgcolor[3] > 0:
        layer[:, :] = bgcolor

    if bg_image is not None:
        ih, iw = bg_image.shape[:2]
        x0 = int((lw - iw) * bg_image_pos[0])
        y0 = int((lh - ih) * bg_image_pos[1])
        _blit_rgba(layer, bg_image, x0, y0)

    # measure lines (run widths scale by the anamorphic fontSize hscale,
    # matching the device path's scaled_w)
    def host_w(run: RunSpec) -> int:
        if run.hscale == 1.0:
            return run.measure().width
        return max(1, int(round(run.measure().width * run.hscale)))

    metrics = []
    for line in lines:
        if not line:
            metrics.append((0, 0, 0))
            continue
        w = sum(host_w(r) for r in line)
        asc = max(r.measure().ascent for r in line)
        desc = max(r.measure().descent for r in line)
        metrics.append((w, asc, desc))
    advances = [line_height_px if line_height_px else (a + d)
                for (_, a, d) in metrics]
    total_h = int(sum(advances))

    if display_align == DisplayAlign.CENTER:
        y = int((lh - pad_t - pad_b - total_h) / 2 + pad_t)
    elif display_align == DisplayAlign.AFTER:
        y = int(lh - pad_b - total_h)
    else:
        y = int(pad_t)

    for line, (w, asc, desc), adv in zip(lines, metrics, advances):
        if _resolve_align(text_align, line) == "center":
            x = int(pad_l + (inner_w - w) / 2)
        elif _resolve_align(text_align, line) == "right":
            x = int(pad_l + inner_w - w)
        else:
            x = int(pad_l)
        baseline = y + asc
        for run in line:
            m = run.measure()
            rw_px = host_w(run)
            alpha, _ = rasterize_run(run.text, run.family, run.size_px,
                                     run.bold, run.italic, shear=run.shear)
            if run.hscale != 1.0 and alpha.shape[1] > 0:
                from .atlas import _resize_width
                alpha = _resize_width(
                    alpha, max(1, int(round(alpha.shape[1] * run.hscale))))
            ry = baseline - m.ascent
            if run.bgcolor is not None and run.bgcolor[3] > 0:
                _fill_rect(layer, run.bgcolor, x, ry, rw_px, m.height)
            if run.outline is not None:
                r_px = int(round(run.outline.lengths[0].value)) \
                    if run.outline.lengths[0].present else 1
                blur_px = int(round(run.outline.lengths[1].value)) \
                    if run.outline.lengths[1].present else 0
                stroked = _dilate(alpha, max(1, r_px))
                if blur_px:
                    stroked = _gaussian_blur_2d(stroked, blur_px)
                _blend_alpha(layer, stroked, run.outline_color, x, ry)
            _blend_alpha(layer, alpha, run.color, x, ry)
            if run.decorations:
                thickness = max(1, run.size_px // 14)
                if run.decorations & TextDecoration.UNDERLINE:
                    _fill_rect(layer, run.color, x, baseline + 1,
                               rw_px, thickness)
                if run.decorations & TextDecoration.STRIKETHROUGH:
                    _fill_rect(layer, run.color, x,
                               baseline - m.ascent // 3, rw_px, thickness)
                if run.decorations & TextDecoration.OVERLINE:
                    _fill_rect(layer, run.color, x, ry, rw_px, thickness)
            x += rw_px
        y += int(adv)

    # host-path note: drawing is inherently clipped to the region layer;
    # overflow=visible is honored by the device instance path
    # (layout_region_instances clips to the window instead of the region)

    if vertical:
        # tbrl: rotate 90° cw; tblr: rotate 90° ccw
        # (reference writing-mode rotation matrices :1235-1385)
        k = -1 if writing_mode == WritingMode.TBRL else 1
        layer = np.ascontiguousarray(np.rot90(layer, k))
    return layer


def _fill_rect(layer: np.ndarray, color, x: int, y: int, w: int, h: int):
    lh, lw = layer.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(lw, x + w), min(lh, y + h)
    if x1 <= x0 or y1 <= y0:
        return
    _blend_alpha(layer[y0:y1, x0:x1],
                 np.full((y1 - y0, x1 - x0), color[3], np.uint8),
                 (color[0], color[1], color[2], 255), 0, 0)


def _blend_alpha(layer: np.ndarray, alpha: np.ndarray, color, x: int, y: int):
    """Source-over blend of a colored alpha map into an RGBA layer."""
    lh, lw = layer.shape[:2]
    ah, aw = alpha.shape
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(lw, x + aw), min(lh, y + ah)
    if x1 <= x0 or y1 <= y0:
        return
    sub = alpha[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.float32) / 255.0
    sa = sub * (color[3] / 255.0)
    dst = layer[y0:y1, x0:x1].astype(np.float32)
    da = dst[..., 3:] / 255.0
    out_a = sa[..., None] + da * (1 - sa[..., None])
    src_rgb = np.array(color[:3], np.float32)
    num = (src_rgb * sa[..., None]
           + dst[..., :3] * da * (1 - sa[..., None]))
    safe = np.maximum(out_a, 1e-6)
    dst[..., :3] = num / safe
    dst[..., 3:] = out_a * 255.0
    layer[y0:y1, x0:x1] = np.clip(dst, 0, 255).astype(np.uint8)


def _blit_rgba(layer: np.ndarray, src: np.ndarray, x: int, y: int):
    lh, lw = layer.shape[:2]
    sh, sw = src.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(lw, x + sw), min(lh, y + sh)
    if x1 <= x0 or y1 <= y0:
        return
    sub = src[y0 - y:y1 - y, x0 - x:x1 - x]
    if sub.shape[-1] == 4:
        a = sub[..., 3].astype(np.float32) / 255.0
        dst = layer[y0:y1, x0:x1, :3].astype(np.float32)
        layer[y0:y1, x0:x1, :3] = (
            sub[..., :3] * a[..., None] + dst * (1 - a[..., None])
        ).astype(np.uint8)
        layer[y0:y1, x0:x1, 3] = np.maximum(layer[y0:y1, x0:x1, 3],
                                            sub[..., 3])
    else:
        layer[y0:y1, x0:x1, :3] = sub
        layer[y0:y1, x0:x1, 3] = 255


def _resolve_align(text_align: TextAlign, line: List[RunSpec]) -> str:
    """start/end map through the line's base direction (RTL base flips
    them, matching pango's resolved alignment in the reference)."""
    rtl = any(r.rtl for r in line)
    if text_align == TextAlign.CENTER:
        return "center"
    if text_align == TextAlign.LEFT:
        return "left"
    if text_align == TextAlign.RIGHT:
        return "right"
    if text_align == TextAlign.END:
        return "left" if rtl else "right"
    return "right" if rtl else "left"  # START


def layout_region_instances(
        inst, atlas, region_box: Tuple[int, int, int, int],
        lines: List[List[RunSpec]],
        *, padding: Tuple[float, float, float, float] = (0, 0, 0, 0),
        bgcolor: Optional[Tuple[int, int, int, int]] = None,
        bg_image: Optional[np.ndarray] = None,
        bg_image_pos: Tuple[float, float] = (0.5, 0.5),
        text_align: TextAlign = TextAlign.START,
        display_align: DisplayAlign = DisplayAlign.BEFORE,
        line_height_px: Optional[float] = None,
        overflow_visible: bool = False,
        opacity: float = 1.0,
        window_w: int = DEFAULT_WINDOW_W,
        window_h: int = DEFAULT_WINDOW_H,
        par_scale: float = 1.0,
        writing_mode: WritingMode = WritingMode.LRTB) -> None:
    """Emit one region's draw ops into a device InstanceList (the
    glyph-atlas fast path — ALL writing modes and background images).

    Geometry is produced in window coordinates; clipping is a per-instance
    clip rect — the region box for overflow=hidden, the whole window for
    overflow=visible (the reference's overflow clip switch,
    gstttmlrender.c:1235-1385). ``par_scale`` horizontally scales glyph
    bitmaps and advances for anamorphic PAR (gstttmlrender.c:745-857).

    Vertical writing modes (reference rotation matrices :1235-1385) lay
    out in a rotated canvas exactly like the host path, then every draw
    op transforms into window coordinates: rects rotate as rects, text
    runs reference PRE-ROTATED atlas tiles (atlas.run_entry rot) — the
    interval stays one device instance stream, no host-layer fallback.
    """
    rx, ry, rw, rh = region_box
    pad_t, pad_r, pad_b, pad_l = padding
    vertical = writing_mode in (WritingMode.TBRL, WritingMode.TBLR,
                                WritingMode.TB)
    rot = 0
    if vertical:
        rot = -1 if writing_mode == WritingMode.TBRL else 1
        par_scale = 1.0   # host path draws vertical modes without PAR
        #                   glyph scaling; mirror it (display-x scaling of
        #                   rotated glyphs is the line-stacking axis)
    # layout canvas: (lw x lh); equals the region box rotated for vertical
    lw, lh = (rh, rw) if vertical else (rw, rh)
    inner_w = max(1, int(lw - pad_l - pad_r))
    clip = (rx, ry, rx + rw, ry + rh) if not overflow_visible \
        else (0, 0, window_w, window_h)

    def to_window(lx: int, ly: int, w: int, h: int):
        """Layout-local rect → (x, y, w, h) in window coordinates."""
        if rot == 0:
            return rx + lx, ry + ly, w, h
        if rot == -1:  # cw (tbrl): layout (r=ly, c=lx) → (r=lx, c=lh-1-ly)
            return rx + (lh - ly - h), ry + lx, h, w
        return rx + ly, ry + (lw - lx - w), h, w  # ccw (tblr)

    def emit_rect(lx, ly, w, h, color, rect_clip=None):
        x, y, ww, hh = to_window(int(lx), int(ly), int(w), int(h))
        inst.add_rect(x, y, ww, hh, color, opacity,
                      rect_clip if rect_clip is not None else clip)

    def emit_entry(entry, lx, ly, w, h, color):
        # (w, h) is the layout-space box; entry tiles are pre-rotated so
        # only the top-left placement needs transforming
        x, y, _, _ = to_window(int(lx), int(ly), int(w), int(h))
        inst.add_entry(entry, x, y, color, opacity, clip)

    if bgcolor is not None and bgcolor[3] > 0:
        # region background always clips to the region box
        inst.add_rect(rx, ry, rw, rh, bgcolor, opacity,
                      (rx, ry, rx + rw, ry + rh))

    if bg_image is not None:
        # SMPTE background image: tiled into the RGBA image atlas
        # (reference gstttmlrender.c:344-419); placed in layout coords and
        # rotated with the canvas like the host path
        ih, iw = bg_image.shape[:2]
        ie = atlas.image_entry(bg_image, rot)
        ix0 = int((lw - iw) * bg_image_pos[0])
        iy0 = int((lh - ih) * bg_image_pos[1])
        emit_entry(ie, ix0, iy0, iw, ih, (255, 255, 255, 255))

    def run_scale(run: RunSpec) -> float:
        # region-wide PAR scale composed with the run's anamorphic
        # fontSize scale
        return par_scale * run.hscale

    def scaled_w(run: RunSpec) -> int:
        return max(1, int(round(run.measure().width * run_scale(run))))

    metrics = []
    for line in lines:
        if not line:
            metrics.append((0, 0, 0))
            continue
        w = sum(scaled_w(r) for r in line)
        asc = max(r.measure().ascent for r in line)
        desc = max(r.measure().descent for r in line)
        metrics.append((w, asc, desc))
    advances = [line_height_px if line_height_px else (a + d)
                for (_, a, d) in metrics]
    total_h = int(sum(advances))

    if display_align == DisplayAlign.CENTER:
        y = int((lh - pad_t - pad_b - total_h) / 2 + pad_t)
    elif display_align == DisplayAlign.AFTER:
        y = int(lh - pad_b - total_h)
    else:
        y = int(pad_t)

    for line, (w, asc, desc), adv in zip(lines, metrics, advances):
        align = _resolve_align(text_align, line)
        if align == "center":
            x = int(pad_l + (inner_w - w) / 2)
        elif align == "right":
            x = int(pad_l + inner_w - w)
        else:
            x = int(pad_l)
        baseline = y + asc
        for run in line:
            m = run.measure()
            rw_px = scaled_w(run)
            ytop = baseline - m.ascent
            if run.bgcolor is not None and run.bgcolor[3] > 0:
                emit_rect(x, ytop, rw_px, m.height, run.bgcolor)
            if run.outline is not None:
                r_px = int(round(run.outline.lengths[0].value)) \
                    if run.outline.lengths[0].present else 1
                blur_px = int(round(run.outline.lengths[1].value)) \
                    if run.outline.lengths[1].present else 0
                stroked = atlas.stroked_entry(
                    run.text, run.family, run.size_px, run.bold,
                    run.italic, max(1, r_px), blur_px, run_scale(run), rot,
                    run.shear)
                emit_entry(stroked, x, ytop, rw_px, m.height,
                           run.outline_color)
            entry = atlas.run_entry(run.text, run.family, run.size_px,
                                    run.bold, run.italic, run_scale(run),
                                    rot, run.shear)
            emit_entry(entry, x, ytop, rw_px, m.height, run.color)
            if run.decorations:
                thickness = max(1, run.size_px // 14)
                if run.decorations & TextDecoration.UNDERLINE:
                    emit_rect(x, baseline + 1, rw_px, thickness, run.color)
                if run.decorations & TextDecoration.STRIKETHROUGH:
                    emit_rect(x, baseline - m.ascent // 3, rw_px,
                              thickness, run.color)
                if run.decorations & TextDecoration.OVERLINE:
                    emit_rect(x, ytop, rw_px, thickness, run.color)
            x += rw_px
        y += int(adv)
