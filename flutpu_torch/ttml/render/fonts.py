"""Host-side text shaping: fonts and text-run rasterization (port of
flutpu/ttml/render/fonts.py: the same shaping where the DejaVu files are
found; where they are not, Pillow's built-in scalable font at the asked
size, and without Pillow a small bitmap font carried below).

The TPU-first split of the reference's pango/cairo stack
(gstttmlrender.c:591-1176): line breaking, font selection and glyph
rasterization are deeply host-bound (FreeType via PIL here, pango there);
everything per-pixel after the alpha maps — coloring, decorations,
outlines, blur, region backgrounds, alpha-over compositing — runs as device
kernels (flutpu.ttml.render.composite).

Rasterized run alpha maps are cached by (text, font, size) since subtitle
intervals repeat runs heavily.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..enums import FontStyle, FontWeight


def _font_dir() -> Optional[str]:
    try:
        import matplotlib
        d = os.path.join(os.path.dirname(matplotlib.__file__),
                         "mpl-data", "fonts", "ttf")
        if os.path.isdir(d):
            return d
    except ImportError:
        pass
    return None


_FAMILY_FILES = {
    # TTML generic families → DejaVu files: (regular, bold, italic, bolditalic)
    "default": ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf",
                "DejaVuSans-Oblique.ttf", "DejaVuSans-BoldOblique.ttf"),
    "sansSerif": ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf",
                  "DejaVuSans-Oblique.ttf", "DejaVuSans-BoldOblique.ttf"),
    "serif": ("DejaVuSerif.ttf", "DejaVuSerif-Bold.ttf",
              "DejaVuSerif-Italic.ttf", "DejaVuSerif-BoldItalic.ttf"),
    "monospace": ("DejaVuSansMono.ttf", "DejaVuSansMono-Bold.ttf",
                  "DejaVuSansMono-Oblique.ttf",
                  "DejaVuSansMono-BoldOblique.ttf"),
    "monospaceSansSerif": ("DejaVuSansMono.ttf", "DejaVuSansMono-Bold.ttf",
                           "DejaVuSansMono-Oblique.ttf",
                           "DejaVuSansMono-BoldOblique.ttf"),
    "monospaceSerif": ("DejaVuSansMono.ttf", "DejaVuSansMono-Bold.ttf",
                       "DejaVuSansMono-Oblique.ttf",
                       "DejaVuSansMono-BoldOblique.ttf"),
    "proportionalSansSerif": ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf",
                              "DejaVuSans-Oblique.ttf",
                              "DejaVuSans-BoldOblique.ttf"),
    "proportionalSerif": ("DejaVuSerif.ttf", "DejaVuSerif-Bold.ttf",
                          "DejaVuSerif-Italic.ttf",
                          "DejaVuSerif-BoldItalic.ttf"),
}


def _builtin_font(size_px: int):
    """Pillow's own font: its embedded scalable face at ``size_px`` where
    this Pillow has one (10.1 on, with FreeType), else its fixed bitmap
    face; None where neither loads."""
    from PIL import ImageFont
    try:
        return ImageFont.load_default(size_px)
    except TypeError:       # a Pillow whose load_default takes no size
        pass
    except OSError:
        return None
    try:
        return ImageFont.load_default()
    except OSError:
        return None


def font_backend() -> str:
    """Which rasterizer text runs take here: ``PIL (DejaVu)``,
    ``PIL (built-in)`` or ``bitmap``."""
    font = load_font("default", 16)
    if font is None:
        return "bitmap"
    path = getattr(font, "path", None)
    return "PIL (DejaVu)" if isinstance(path, str) and "DejaVu" in path \
        else "PIL (built-in)"


@functools.lru_cache(maxsize=256)
def load_font(family: str, size_px: int, bold: bool = False,
              italic: bool = False):
    """PIL font for (family, pixel size, weight, style); None when Pillow
    or a font of its own is missing (``rasterize_run`` then draws the
    bitmap font)."""
    try:
        from PIL import ImageFont
    except ImportError:
        return None
    d = _font_dir()
    files = _FAMILY_FILES.get(family) or _FAMILY_FILES.get(
        family.split(",")[0].strip()) or _FAMILY_FILES["default"]
    fname = files[(1 if bold else 0) + (2 if italic else 0)]
    if d is not None:
        path = os.path.join(d, fname)
        if os.path.exists(path):
            try:
                return ImageFont.truetype(path, size_px)
            except OSError:
                pass
    return _builtin_font(size_px)


@dataclass
class RunMetrics:
    width: int
    ascent: int
    descent: int

    @property
    def height(self) -> int:
        return self.ascent + self.descent


def measure_run(text: str, family: str, size_px: int, bold: bool = False,
                italic: bool = False) -> RunMetrics:
    font = load_font(family, max(1, int(size_px)), bold, italic)
    if font is None:
        return RunMetrics(8 * len(text), int(size_px * 0.8), int(size_px * 0.2))
    ascent, descent = font.getmetrics()
    width = int(font.getlength(text)) if hasattr(font, "getlength") else \
        font.getbbox(text)[2]
    return RunMetrics(width, ascent, descent)


@functools.lru_cache(maxsize=4096)
def rasterize_run(text: str, family: str, size_px: int, bold: bool = False,
                  italic: bool = False,
                  shear: float = 0.0) -> Tuple[np.ndarray, RunMetrics]:
    """Render a text run to an alpha map (H, W) uint8 + metrics.

    The map's height is ascent+descent; the baseline sits at ``ascent``.
    ``shear`` applies a horizontal glyph shear WITHOUT changing advances —
    the reference's reverseOblique rendering (a custom pango attribute +
    matrix shear, gstttmlrender.c:858-898): negative shear leans glyph
    tops LEFT (reverse oblique); positive leans right (synthetic oblique
    for faces with no italic file). The map widens by |shear|*height so
    nothing clips. Without a PIL font the run is drawn in the bitmap
    font, upright.
    """
    m = measure_run(text, family, size_px, bold, italic)
    font = load_font(family, max(1, int(size_px)), bold, italic)
    w = max(1, m.width)
    h = max(1, m.height)
    if font is None:
        return _rasterize_bitmap(text, w, h), m
    from PIL import Image, ImageDraw
    img = Image.new("L", (w, h), 0)
    if font is not None and text:
        ImageDraw.Draw(img).text((0, 0), text, font=font, fill=255)
    if shear and text:
        extra = int(np.ceil(abs(shear) * h))
        if shear < 0:
            # output(x, y) samples input(x + shear*y): bottoms shift right,
            # tops lean left — reverse oblique
            img = img.transform((w + extra, h), Image.AFFINE,
                                (1, shear, 0, 0, 1, 0), fillcolor=0)
        else:
            # lean right: offset so the sheared top stays in-canvas
            img = img.transform((w + extra, h), Image.AFFINE,
                                (1, shear, -extra, 0, 1, 0), fillcolor=0)
    return np.asarray(img, dtype=np.uint8), m


# -- the bitmap font -------------------------------------------------------------
# Printable ASCII (32..126) in 8x11 cells, one byte per row, most
# significant bit leftmost; the baseline lies under row 8. Drawn only
# where no PIL font loads: ``measure_run`` then gives every character 8
# pixels of width, ascent 0.8 and descent 0.2 of the size, which these
# cells fill (rows stretched to the run's height by nearest neighbour).
_BITMAP_ROWS = 11
_BITMAP_FONT = bytes.fromhex(
    "0000000000000000000000000000303030300030000000000028282800000000"
    "00000028287c28287c28280000103c64783c0c6c7810000000705478103c541c"
    "00000000003860307c587c000000001810200000000000000000081030303030"
    "1008000000201018181818102000000010783048000000000000000010107c10"
    "10000000000000000000000018102000000000007c0000000000000000000000"
    "000030000000000404080810102020000000386c6c6c6c6c3800000000187818"
    "1818187e00000000386c0c18306c7c00000000386c0c380c6c38000000000c1c"
    "2c6c7e0c0c000000007c60786c0c4c7800000000386c60786c6c38000000007c"
    "6c0c1818303000000000386c6c386c6c3800000000386c6c3c0c6c3800000000"
    "0000003000003000000000000000300000302040000000183060301800000000"
    "0000007800780000000000000030180c1830000000000000384c183000300000"
    "000038644c54544e6038000000007838287c6c6e0000000000786c786c6c7800"
    "000000003c6c60606c380000000000786c6c6c6c7800000000007c6078606c7c"
    "00000000007c60786060700000000000386c607c6c3c00000000006e6c7c6c6c"
    "6e000000000078303030307800000000003c181858587000000000006c687078"
    "6c760000000000706060606c7c0000000000446c6c7c545400000000006e7474"
    "6c6c640000000000386c6c6c6c380000000000786c6c7860700000000000386c"
    "6c6c6c380c00000000786c6c786c7600000000003c64781c4c7800000000007c"
    "343030307800000000006e6c6c6c6c3800000000006e6c283838100000000000"
    "5654547c38280000000000663c18183c66000000000066663c18183c00000000"
    "007c6c18306c7c00000000383030303030303800000040402020101008080000"
    "00381818181818183800000010386c000000000000000000000000000000007e"
    "000030100800000000000000000000386c3c6c7e000000006060786c6c6c7800"
    "0000000000386c606c38000000001c0c3c6c6c6c3e000000000000386c7c603c"
    "000000001c307c3030307c000000000000366c6c6c3c0c7800006060786c6c6c"
    "6c000000001800781818187e00000000180078181818181870000060606c7870"
    "786e000000007818181818187e000000000000787c545454000000000000586c"
    "6c6c6c000000000000386c6c6c38000000000000786c6c6c7860700000000036"
    "6c6c6c3c0c1e000000006e3a3030780000000000003c703c0e7c000000003030"
    "7c3030361c0000000000006c6c6c6c3e0000000000006c6c3838100000000000"
    "0056547c3c28000000000000763c183c6e0000000000006e6c6c283830600000"
    "00007c58306c7c000000000c1818301818180c00000000101010101010100000"
    "006030301830303060000000000034580000000000")


def _rasterize_bitmap(text: str, w: int, h: int) -> np.ndarray:
    """``text`` in the bitmap font as an (h, w) uint8 alpha map: 8 columns
    per character, the 11 glyph rows stretched to ``h``; characters
    outside printable ASCII draw as ``?``."""
    glyphs = np.unpackbits(
        np.frombuffer(_BITMAP_FONT, np.uint8).reshape(95, _BITMAP_ROWS, 1),
        axis=2)
    codes = [ord(c) - 32 if 32 <= ord(c) < 127 else ord("?") - 32
             for c in text]
    out = np.zeros((h, w), np.uint8)
    if not codes:
        return out
    line = np.concatenate([glyphs[c] for c in codes], axis=1) * np.uint8(255)
    rows = np.arange(h) * _BITMAP_ROWS // h
    cols = min(w, line.shape[1])
    out[:, :cols] = line[rows][:, :cols]
    return out
