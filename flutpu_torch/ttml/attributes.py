"""TTML attribute model — parsing, normalization, animation timelines.

Rebuild of the reference's attribute engine
(plugins/ttml/gstttmlattribute.c): every supported TTML attribute parsed
from its string form into typed values — time expressions (clock and offset
forms, SMPTE frame-rate aware, clock-timeBase wall-clock deltas), colors
(#rgb(a), rgb()/rgba(), named), length lists with px/em/c/% units and
normalization to pixels, padding shorthand, zIndex lexical tiebreak,
textOutline — plus the per-attribute animation timeline fed by SET nodes.

Table-driven Python instead of a C switch; behavior parity is the goal, and
deviations are noted inline.
"""

from __future__ import annotations

import re
import time as _time
from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.buffer import SECOND
from .enums import (AttrType, ClockMode, Direction, DisplayAlign, DropMode,
                    FontStyle, FontWeight, LengthUnit, MarkerMode, NodeType,
                    Overflow, ShowBackground, SmpteEncoding, SmpteImageType,
                    TextAlign, TextDecoration, TimeBase, UnicodeBidi,
                    WrapOption, WritingMode, is_styling)

# RGBA packed like the reference: 0xRRGGBBAA
NAMED_COLORS = {
    "transparent": 0x00000000, "black": 0x000000FF, "silver": 0xC0C0C0FF,
    "gray": 0x808080FF, "white": 0xFFFFFFFF, "maroon": 0x800000FF,
    "red": 0xFF0000FF, "purple": 0x800080FF, "fuchsia": 0xFF00FFFF,
    "magenta": 0xFF00FFFF, "green": 0x008000FF, "lime": 0x00FF00FF,
    "olive": 0x808000FF, "yellow": 0xFFFF00FF, "navy": 0x000080FF,
    "blue": 0x0000FFFF, "teal": 0x008080FF, "aqua": 0x00FFFFFF,
    "cyan": 0x00FFFFFF,
}


@dataclass
class Length:
    value: float = 1.0
    unit: LengthUnit = LengthUnit.RELATIVE

    @property
    def present(self) -> bool:
        return self.unit != LengthUnit.NOT_PRESENT

    def copy(self) -> "Length":
        return Length(self.value, self.unit)

    @staticmethod
    def absent() -> "Length":
        return Length(0.0, LengthUnit.NOT_PRESENT)


@dataclass
class TextOutline:
    color: int = 0xFFFFFFFF
    use_current_color: bool = True
    lengths: Tuple[Length, Length] = (Length.absent(), Length.absent())

    @property
    def present(self) -> bool:
        return self.lengths[0].present


@dataclass
class AttributeEvent:
    timestamp: int  # ns
    attr: "Attribute"


@dataclass
class Attribute:
    type: AttrType
    value: Any = None
    raw: str = ""  # original string (re-serialization / debugging)
    timeline: List[AttributeEvent] = field(default_factory=list)

    def copy(self, include_timeline: bool = True) -> "Attribute":
        a = Attribute(self.type, _copy_value(self.value), self.raw)
        if include_timeline:
            a.timeline = [AttributeEvent(e.timestamp, e.attr.copy(False))
                          for e in self.timeline]
        return a

    def add_event(self, timestamp: int, src: "Attribute") -> None:
        """Insert an animation event sorted by timestamp (stable for ties —
        reference gstttmlattribute.c:1260-1272)."""
        ev = AttributeEvent(timestamp, src.copy(False))
        idx = len(self.timeline)
        for i, e in enumerate(self.timeline):
            if e.timestamp > timestamp:
                idx = i
                break
        self.timeline.insert(idx, ev)

    @property
    def is_styling(self) -> bool:
        return is_styling(self.type)


def _copy_value(v: Any) -> Any:
    if isinstance(v, Length):
        return v.copy()
    if isinstance(v, list):
        return [_copy_value(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_copy_value(x) for x in v)
    return v


# Special pseudo-attribute marking "remove this style on pop"
STYLE_REMOVAL = "style-removal"


@dataclass
class StyleRemoval:
    removed_type: AttrType


# ----------------------------------------------------------------------------
# expression parsers
# ----------------------------------------------------------------------------

_CLOCK_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?):(\d+(?:\.\d+)?):(\d+(?:\.\d+)?)"
    r"(?::(\d+)(?:\.(\d+))?)?\s*$")
_OFFSET_RE = re.compile(r"^\s*([+-]?\d+(?:\.\d+)?)\s*(ms|h|m|s|t|f)\s*$")


def parse_time_expression(state, expr: str) -> Optional[int]:
    """TTML <timeExpression> → nanoseconds (or None on parse failure).

    Mirrors the reference semantics (gstttmlattribute.c:39-158): clock form
    with optional SMPTE frames.subframes scaled by the effective frame rate
    (frameRate * frameRateMultiplier), offset form with h/m/s/ms/t/f
    metrics, and timeBase="clock" conversion to a delta from the current
    wall clock (GPS offset +16 s; past timestamps clamp to 0).
    """
    res = None
    m = _CLOCK_RE.match(expr)
    if m:
        h, mi, s = float(m.group(1)), float(m.group(2)), float(m.group(3))
        secs = h * 3600 + mi * 60 + s
        if m.group(4) is not None:
            f = int(m.group(4))
            subf = int(m.group(5)) if m.group(5) else 0
            spf = state.frame_rate_den / (state.frame_rate * state.frame_rate_num)
            secs += (f + subf / state.sub_frame_rate) * spf
        res = int(secs * SECOND)
    else:
        m = _OFFSET_RE.match(expr)
        if m:
            count = float(m.group(1))
            metric = m.group(2)
            if metric == "h":
                scale = 3600 * SECOND
            elif metric == "ms":
                scale = SECOND / 1000
            elif metric == "m":
                scale = 60 * SECOND
            elif metric == "s":
                scale = SECOND
            elif metric == "t":
                scale = SECOND / state.tick_rate
            else:  # f
                scale = SECOND * state.frame_rate_den / (
                    state.frame_rate * state.frame_rate_num)
            res = int(count * scale)
    if res is None:
        return None

    if state.time_base == TimeBase.CLOCK:
        res = _clock_to_delta(res, state.clock_mode)
    return res


def _clock_to_delta(res_ns: int, clock_mode: ClockMode,
                    _now: Optional[float] = None) -> int:
    """timeBase=clock: interpret the expression as wall-clock time-of-day and
    return the delta from now (0 if in the past)."""
    now = _time.time() if _now is None else _now
    if clock_mode == ClockMode.LOCAL:
        tm = _time.localtime(now)
    else:
        tm = _time.gmtime(now)
    now_secs = tm.tm_hour * 3600 + tm.tm_min * 60 + tm.tm_sec
    read_secs = (res_ns // SECOND) % 86400
    diff = read_secs - now_secs
    if clock_mode == ClockMode.GPS:
        diff += 16  # UTC-GPS leap-second offset (as pinned by the reference)
    if diff < 0:
        diff = 0
    return int(diff * SECOND)


_HEX8_RE = re.compile(r"^#([0-9a-fA-F]{2})([0-9a-fA-F]{2})([0-9a-fA-F]{2})"
                      r"([0-9a-fA-F]{2})")
_HEX6_RE = re.compile(r"^#([0-9a-fA-F]{2})([0-9a-fA-F]{2})([0-9a-fA-F]{2})")
_RGB_RE = re.compile(r"^rgb\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)")
_RGBA_RE = re.compile(r"^rgba\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)")


def parse_color(expr: str) -> Tuple[int, int, bool]:
    """Parse a leading color expression. Returns (rgba, consumed_chars, ok).
    On failure returns (0xFFFFFFFF, 0, False) — reference behavior."""
    expr = expr.lstrip()
    for regex, has_a in ((_HEX8_RE, True), (_HEX6_RE, False)):
        m = regex.match(expr)
        if m:
            r, g, b = (int(m.group(i), 16) for i in (1, 2, 3))
            a = int(m.group(4), 16) if has_a else 0xFF
            return (r << 24 | g << 16 | b << 8 | a), m.end(), True
    m = _RGBA_RE.match(expr)
    if m:
        r, g, b, a = (int(m.group(i)) & 0xFF for i in (1, 2, 3, 4))
        return (r << 24 | g << 16 | b << 8 | a), m.end(), True
    m = _RGB_RE.match(expr)
    if m:
        r, g, b = (int(m.group(i)) & 0xFF for i in (1, 2, 3))
        return (r << 24 | g << 16 | b << 8 | 0xFF), m.end(), True
    low = expr.lower()
    for name, rgba in NAMED_COLORS.items():
        if low.startswith(name):
            return rgba, len(name), True
    return 0xFFFFFFFF, 0, False


def color_to_string(color: int) -> str:
    return "#%02x%02x%02x%02x" % ((color >> 24) & 0xFF, (color >> 16) & 0xFF,
                                  (color >> 8) & 0xFF, color & 0xFF)


_NUM_RE = re.compile(r"^\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


def parse_length(expr: str) -> Tuple[Optional[Length], str]:
    """Parse one leading <length>; returns (Length or None, rest)."""
    m = _NUM_RE.match(expr)
    if not m:
        return None, expr
    numstr = m.group(1)
    # undo an 'e' of "em" consumed by the exponent syntax (ref quirk handling)
    if numstr[-1] in "eE" or (len(numstr) > 1 and numstr[-2] in "eE"
                              and numstr[-1] == "m"):
        numstr = numstr.rstrip("mM").rstrip("eE")
    try:
        value = float(numstr)
    except ValueError:
        return None, expr
    rest = expr[m.start(1) + len(numstr):]
    if rest[:2].lower() == "px":
        return Length(value, LengthUnit.PIXELS), rest[2:]
    if rest[:2].lower() == "em":
        return Length(value, LengthUnit.EM), rest[2:]
    if rest[:1].lower() == "c":
        return Length(value, LengthUnit.CELLS), rest[1:]
    if rest[:1] == "%":
        return Length(value / 100.0, LengthUnit.RELATIVE), rest[1:]
    return None, expr  # bare number: error per reference


def parse_length_list(expr: str, max_elements: int) -> List[Length]:
    """List of lengths; missing trailing entries are NOT_PRESENT."""
    out: List[Length] = []
    rest = expr
    while len(out) < max_elements:
        length, rest = parse_length(rest)
        if length is None:
            break
        out.append(length)
        if not rest.strip():
            break
        rest = rest.lstrip()
    while len(out) < max_elements:
        out.append(Length.absent())
    return out


def normalize_length(state, style_override, attr_type: AttrType,
                     length: Length, direction: int) -> None:
    """Resolve c/%/em units to pixels in place where possible — reference
    gstttmlattribute.c:312-396. ``direction`` 0 = horizontal, 1 = vertical."""
    if length.unit == LengthUnit.CELLS:
        if state is None or not state.frame_width:
            return
        if direction == 0:
            length.value = length.value * state.frame_width / state.cell_resolution_x
        else:
            length.value = length.value * state.frame_height / state.cell_resolution_y
        length.unit = LengthUnit.PIXELS
        return
    if length.unit == LengthUnit.RELATIVE:
        if attr_type in (AttrType.ORIGIN, AttrType.EXTENT):
            if state is None or not state.frame_width:
                return
            length.value *= (state.frame_width if direction == 0
                             else state.frame_height)
            length.unit = LengthUnit.PIXELS
            return
        if attr_type == AttrType.PADDING:
            style = style_override if style_override is not None else \
                (state.style if state else None)
            extent = style.get(AttrType.EXTENT) if style else None
            if extent is not None:
                parent = extent.value[direction].value
            elif state is not None and state.frame_width:
                parent = (state.frame_width if direction == 0
                          else state.frame_height)
            else:
                return
            length.value *= parent
            length.unit = LengthUnit.PIXELS
            return
        if attr_type in (AttrType.SMPTE_BACKGROUND_IMAGE_HORIZONTAL,
                         AttrType.SMPTE_BACKGROUND_IMAGE_VERTICAL):
            return  # stays relative: image size unknown at parse time
        # all other relatives behave like EM (relative to font size)
    if length.unit in (LengthUnit.RELATIVE, LengthUnit.EM):
        style = style_override if style_override is not None else \
            (state.style if state else None)
        font_size = style.get(AttrType.FONT_SIZE) if style else None
        if font_size is not None and \
                font_size.value[direction].unit == LengthUnit.PIXELS:
            length.value *= font_size.value[direction].value
            length.unit = LengthUnit.PIXELS
            return
        if state is None or not state.frame_height:
            length.unit = LengthUnit.CELLS
        else:
            length.value *= state.frame_height / state.cell_resolution_y
            length.unit = LengthUnit.PIXELS


def get_normalized_length(state, style_override, attr: Attribute,
                          index: int, direction: int) -> Tuple[float, LengthUnit]:
    length = attr.value[index].copy() if isinstance(attr.value, list) else \
        attr.value.copy()
    normalize_length(state, style_override, attr.type, length, direction)
    return length.value, length.unit


# ----------------------------------------------------------------------------
# attribute name table and parse dispatch
# ----------------------------------------------------------------------------

# XML local name → AttrType (namespace is validated separately)
ATTR_BY_NAME: Dict[str, AttrType] = {
    "id": AttrType.ID,
    # "space" (xml:space) is special-cased in parse_attribute BEFORE the
    # table lookup; this entry exists for the segmented.py reverse map
    "space": AttrType.WHITESPACE_PRESERVE,
    "begin": AttrType.BEGIN,
    "end": AttrType.END,
    "dur": AttrType.DUR,
    "tickRate": AttrType.TICK_RATE,
    "frameRate": AttrType.FRAME_RATE,
    "frameRateMultiplier": AttrType.FRAME_RATE_MULTIPLIER,
    "subFrameRate": AttrType.SUBFRAME_RATE,
    "cellResolution": AttrType.CELL_RESOLUTION,
    "pixelAspectRatio": AttrType.PIXEL_ASPECT_RATIO,
    "timeBase": AttrType.TIME_BASE,
    "clockMode": AttrType.CLOCK_MODE,
    "markerMode": AttrType.MARKER_MODE,
    "dropMode": AttrType.DROP_MODE,
    "style": AttrType.STYLE,
    "region": AttrType.REGION,
    "timeContainer": AttrType.TIME_CONTAINER,
    "color": AttrType.COLOR,
    "backgroundColor": AttrType.BACKGROUND_COLOR,
    "direction": AttrType.DIRECTION,
    "display": AttrType.DISPLAY,
    "displayAlign": AttrType.DISPLAY_ALIGN,
    "extent": AttrType.EXTENT,
    "fontFamily": AttrType.FONT_FAMILY,
    "fontSize": AttrType.FONT_SIZE,
    "fontStyle": AttrType.FONT_STYLE,
    "fontWeight": AttrType.FONT_WEIGHT,
    "lineHeight": AttrType.LINE_HEIGHT,
    "opacity": AttrType.OPACITY,
    "origin": AttrType.ORIGIN,
    "overflow": AttrType.OVERFLOW,
    "padding": AttrType.PADDING,
    "showBackground": AttrType.SHOW_BACKGROUND,
    "textAlign": AttrType.TEXT_ALIGN,
    "textDecoration": AttrType.TEXT_DECORATION,
    "textOutline": AttrType.TEXT_OUTLINE,
    "unicodeBidi": AttrType.UNICODE_BIDI,
    "visibility": AttrType.VISIBILITY,
    "wrapOption": AttrType.WRAP_OPTION,
    "writingMode": AttrType.WRITING_MODE,
    "zIndex": AttrType.ZINDEX,
    "imagetype": AttrType.SMPTE_IMAGE_TYPE,
    "imageType": AttrType.SMPTE_IMAGE_TYPE,
    "encoding": AttrType.SMPTE_ENCODING,
    "backgroundImage": AttrType.SMPTE_BACKGROUND_IMAGE,
    "backgroundImageHorizontal": AttrType.SMPTE_BACKGROUND_IMAGE_HORIZONTAL,
    "backgroundImageVertical": AttrType.SMPTE_BACKGROUND_IMAGE_VERTICAL,
}

# xml:space handled via a dedicated attribute type in the reference; we model
# it as a state bool through a pseudo attr
WHITESPACE_PRESERVE = "xml:space"


def _value_is(value: str, token: str) -> bool:
    """Whitespace/case-insensitive token compare (gstttmlutils.c:314-335)."""
    return value.strip().lower() == token.lower()


def _enum_parse(value: str, enum_cls, default):
    v = value.strip()
    for member in enum_cls:
        if member.value.lower() == v.lower():
            return member
    return default


def parse_attribute(state, ns: Optional[str], name: str,
                    value: str) -> Optional[Attribute]:
    """Parse one name/value pair against the current state. Returns None for
    unknown attributes or non-TTML namespaces."""
    from .namespace import namespace_is_ttml
    if not namespace_is_ttml(ns):
        return None

    if name == "space":  # xml:space
        return Attribute(AttrType.WHITESPACE_PRESERVE,
                         _value_is(value, "preserve"), value)

    atype = ATTR_BY_NAME.get(name)
    if atype is None or atype == AttrType.NODE_TYPE:
        return None

    attr = Attribute(atype, None, value)
    t = atype
    if t in (AttrType.BEGIN, AttrType.END, AttrType.DUR):
        attr.value = parse_time_expression(state, value)
        if attr.value is None:
            return None
    elif t == AttrType.TICK_RATE:
        attr.value = float(value)
    elif t == AttrType.FRAME_RATE:
        attr.value = float(value)
    elif t in (AttrType.FRAME_RATE_MULTIPLIER, AttrType.PIXEL_ASPECT_RATIO):
        parts = value.split()
        if len(parts) >= 2:
            attr.value = Fraction(int(parts[0]), int(parts[1]))
        else:
            return None
    elif t == AttrType.SUBFRAME_RATE:
        attr.value = int(float(value))
    elif t == AttrType.TIME_BASE:
        attr.value = _enum_parse(value, TimeBase, TimeBase.MEDIA)
    elif t == AttrType.CLOCK_MODE:
        attr.value = _enum_parse(value, ClockMode, ClockMode.UTC)
    elif t == AttrType.MARKER_MODE:
        attr.value = _enum_parse(value, MarkerMode, MarkerMode.DISCONTINUOUS)
    elif t == AttrType.DROP_MODE:
        attr.value = _enum_parse(value, DropMode, DropMode.NON_DROP)
    elif t == AttrType.CELL_RESOLUTION:
        parts = value.split()
        try:
            nx, ny = int(parts[0]), int(parts[1])
        except (IndexError, ValueError):
            nx, ny = 32, 15
        attr.value = [Length(nx, LengthUnit.CELLS), Length(ny, LengthUnit.CELLS)]
    elif t in (AttrType.COLOR, AttrType.BACKGROUND_COLOR):
        color, _, ok = parse_color(value)
        attr.value = color
    elif t == AttrType.DISPLAY:
        attr.value = _value_is(value, "auto")
    elif t in (AttrType.FONT_FAMILY, AttrType.ID, AttrType.STYLE,
               AttrType.REGION):
        attr.value = value.strip()
    elif t == AttrType.FONT_SIZE:
        attr.value = parse_length_list(value, 2)
        for d in (0, 1):
            normalize_length(state, None, t, attr.value[d], d)
    elif t == AttrType.FONT_STYLE:
        attr.value = _enum_parse(value, FontStyle, FontStyle.NORMAL)
    elif t == AttrType.FONT_WEIGHT:
        attr.value = _enum_parse(value, FontWeight, FontWeight.NORMAL)
    elif t == AttrType.TEXT_DECORATION:
        flags = TextDecoration.NONE
        for token in re.split(r"[\s+]+", value.strip()):
            if token == "underline":
                flags |= TextDecoration.UNDERLINE
            elif token == "lineThrough":
                flags |= TextDecoration.STRIKETHROUGH
            elif token == "overline":
                flags |= TextDecoration.OVERLINE
        attr.value = flags
    elif t in (AttrType.ORIGIN, AttrType.EXTENT):
        if _value_is(value, "auto"):
            base = 0.0 if t == AttrType.ORIGIN else 1.0
            attr.value = [Length(base, LengthUnit.RELATIVE),
                          Length(base, LengthUnit.RELATIVE)]
        else:
            attr.value = parse_length_list(value, 2)
        for d in (0, 1):
            normalize_length(state, None, t, attr.value[d], d)
    elif t == AttrType.TEXT_ALIGN:
        attr.value = _enum_parse(value, TextAlign, TextAlign.START)
    elif t == AttrType.DISPLAY_ALIGN:
        attr.value = _enum_parse(value, DisplayAlign, DisplayAlign.BEFORE)
    elif t == AttrType.OVERFLOW:
        attr.value = _value_is(value, "visible")
    elif t == AttrType.TEXT_OUTLINE:
        if _value_is(value, "none"):
            attr.value = TextOutline(lengths=(Length.absent(), Length.absent()))
        else:
            color, consumed, ok = parse_color(value)
            rest = value[consumed:] if ok else value
            lengths = parse_length_list(rest, 2)
            # outline widths are relative to block progression (vertical)
            for l in lengths:
                normalize_length(state, None, t, l, 1)
            attr.value = TextOutline(color, not ok, (lengths[0], lengths[1]))
    elif t == AttrType.ZINDEX:
        z = 0 if _value_is(value, "auto") else int(float(value))
        # 1e-3 ever-increasing micro index resolves collisions lexically
        attr.value = z * 1000 + state.next_zindex_micro()
    elif t == AttrType.LINE_HEIGHT:
        if _value_is(value, "normal"):
            attr.value = [Length.absent()]
        else:
            length, _ = parse_length(value)
            attr.value = [length if length is not None else Length.absent()]
        normalize_length(state, None, t, attr.value[0], 1)
    elif t == AttrType.WRAP_OPTION:
        attr.value = _enum_parse(value, WrapOption, WrapOption.WRAP)
    elif t == AttrType.PADDING:
        lengths = parse_length_list(value, 4)
        n = sum(1 for l in lengths if l.present)
        # 1→all sides; 2→(v,h); 3→(t,h,b); 4→(t,r,b,l); stored as t,r,b,l
        padding_map = {1: (0, 0, 0, 0), 2: (0, 1, 0, 1),
                       3: (0, 1, 2, 1), 4: (0, 1, 2, 3)}
        if n > 0:
            idx = padding_map[n]
            attr.value = [lengths[idx[0]].copy(), lengths[idx[1]].copy(),
                          lengths[idx[2]].copy(), lengths[idx[3]].copy()]
        else:
            attr.value = lengths
        for i, d in enumerate((1, 0, 1, 0)):
            normalize_length(state, None, t, attr.value[i], d)
    elif t == AttrType.SHOW_BACKGROUND:
        attr.value = _enum_parse(value, ShowBackground, ShowBackground.ALWAYS)
    elif t == AttrType.VISIBILITY:
        attr.value = _value_is(value, "visible")
    elif t == AttrType.OPACITY:
        attr.value = float(value)
    elif t == AttrType.UNICODE_BIDI:
        attr.value = _enum_parse(value, UnicodeBidi, UnicodeBidi.NORMAL)
    elif t == AttrType.DIRECTION:
        attr.value = _enum_parse(value, Direction, Direction.LTR)
    elif t == AttrType.WRITING_MODE:
        attr.value = _enum_parse(value, WritingMode, WritingMode.LRTB)
    elif t == AttrType.SMPTE_IMAGE_TYPE:
        attr.value = _enum_parse(value, SmpteImageType, SmpteImageType.PNG)
    elif t == AttrType.SMPTE_ENCODING:
        attr.value = _enum_parse(value, SmpteEncoding, SmpteEncoding.BASE64)
    elif t == AttrType.SMPTE_BACKGROUND_IMAGE:
        attr.value = None if _value_is(value, "none") else value.strip()
    elif t in (AttrType.SMPTE_BACKGROUND_IMAGE_HORIZONTAL,
               AttrType.SMPTE_BACKGROUND_IMAGE_VERTICAL):
        low = value.strip().lower()
        if low in ("left", "top"):
            length = Length(0.0, LengthUnit.RELATIVE)
        elif low in ("center", "inherit"):
            length = Length(0.5, LengthUnit.RELATIVE)
        elif low in ("right", "bottom"):
            length = Length(1.0, LengthUnit.RELATIVE)
        else:
            parsed, _ = parse_length(value)
            length = parsed if parsed is not None else Length(0.5, LengthUnit.RELATIVE)
        direction = 0 if t == AttrType.SMPTE_BACKGROUND_IMAGE_HORIZONTAL else 1
        normalize_length(state, None, t, length, direction)
        attr.value = [length]
    elif t == AttrType.TIME_CONTAINER:
        attr.value = _value_is(value, "seq")
    else:
        return None
    return attr
