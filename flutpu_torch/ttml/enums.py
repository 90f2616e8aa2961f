"""TTML vocabulary enums.

Rebuild of the reference's enum set (plugins/ttml/gstttmlenums.h): node
types, attribute kinds (with the styling-attribute threshold used by style
handling), units, alignment/wrapping/writing modes, time bases. Python
enums + sets instead of C ordinal tricks.
"""

from __future__ import annotations

import enum


class NodeType(enum.Enum):
    UNKNOWN = "unknown"
    TT = "tt"
    HEAD = "head"
    BODY = "body"
    DIV = "div"
    P = "p"
    SPAN = "span"
    BR = "br"
    SET = "set"
    STYLING = "styling"
    STYLE = "style"
    LAYOUT = "layout"
    REGION = "region"
    METADATA = "metadata"
    SMPTE_IMAGE = "smpte:image"
    SMPTE_INFORMATION = "smpte:information"


# element name → node type (TTML tag vocabulary)
NODE_BY_NAME = {
    "tt": NodeType.TT, "head": NodeType.HEAD, "body": NodeType.BODY,
    "div": NodeType.DIV, "p": NodeType.P, "span": NodeType.SPAN,
    "br": NodeType.BR, "set": NodeType.SET, "styling": NodeType.STYLING,
    "style": NodeType.STYLE, "layout": NodeType.LAYOUT,
    "region": NodeType.REGION, "metadata": NodeType.METADATA,
    "image": NodeType.SMPTE_IMAGE, "information": NodeType.SMPTE_INFORMATION,
}


class AttrType(enum.Enum):
    # structural / non-styling
    NODE_TYPE = "node_type"
    ID = "xml:id"
    BEGIN = "begin"
    END = "end"
    DUR = "dur"
    TICK_RATE = "ttp:tickRate"
    FRAME_RATE = "ttp:frameRate"
    FRAME_RATE_MULTIPLIER = "ttp:frameRateMultiplier"
    SUBFRAME_RATE = "ttp:subFrameRate"
    CELL_RESOLUTION = "ttp:cellResolution"
    PIXEL_ASPECT_RATIO = "ttp:pixelAspectRatio"
    TIME_BASE = "ttp:timeBase"
    CLOCK_MODE = "ttp:clockMode"
    MARKER_MODE = "ttp:markerMode"
    DROP_MODE = "ttp:dropMode"
    STYLE = "style"
    REGION = "region"
    TIME_CONTAINER = "timeContainer"
    WHITESPACE_PRESERVE = "xml:space"
    EXTENT_TT = "tts:extent@tt"
    SMPTE_IMAGE_TYPE = "smpte:imagetype"
    SMPTE_ENCODING = "smpte:encoding"
    # styling attributes (is_styling() == True from here on)
    COLOR = "tts:color"
    BACKGROUND_COLOR = "tts:backgroundColor"
    BACKGROUND_REGION_COLOR = "tts:backgroundColor@region"
    DIRECTION = "tts:direction"
    DISPLAY = "tts:display"
    DISPLAY_ALIGN = "tts:displayAlign"
    EXTENT = "tts:extent"
    FONT_FAMILY = "tts:fontFamily"
    FONT_SIZE = "tts:fontSize"
    FONT_STYLE = "tts:fontStyle"
    FONT_WEIGHT = "tts:fontWeight"
    LINE_HEIGHT = "tts:lineHeight"
    OPACITY = "tts:opacity"
    ORIGIN = "tts:origin"
    OVERFLOW = "tts:overflow"
    PADDING = "tts:padding"
    SHOW_BACKGROUND = "tts:showBackground"
    TEXT_ALIGN = "tts:textAlign"
    TEXT_DECORATION = "tts:textDecoration"
    TEXT_OUTLINE = "tts:textOutline"
    UNICODE_BIDI = "tts:unicodeBidi"
    VISIBILITY = "tts:visibility"
    WRAP_OPTION = "tts:wrapOption"
    WRITING_MODE = "tts:writingMode"
    ZINDEX = "tts:zIndex"
    SMPTE_BACKGROUND_IMAGE = "smpte:backgroundImage"
    SMPTE_BACKGROUND_IMAGE_HORIZONTAL = "smpte:backgroundImageHorizontal"
    SMPTE_BACKGROUND_IMAGE_VERTICAL = "smpte:backgroundImageVertical"


_STYLING = {
    AttrType.COLOR, AttrType.BACKGROUND_COLOR,
    AttrType.BACKGROUND_REGION_COLOR, AttrType.DIRECTION, AttrType.DISPLAY,
    AttrType.DISPLAY_ALIGN, AttrType.EXTENT, AttrType.FONT_FAMILY,
    AttrType.FONT_SIZE, AttrType.FONT_STYLE, AttrType.FONT_WEIGHT,
    AttrType.LINE_HEIGHT, AttrType.OPACITY, AttrType.ORIGIN,
    AttrType.OVERFLOW, AttrType.PADDING, AttrType.SHOW_BACKGROUND,
    AttrType.TEXT_ALIGN, AttrType.TEXT_DECORATION, AttrType.TEXT_OUTLINE,
    AttrType.UNICODE_BIDI, AttrType.VISIBILITY, AttrType.WRAP_OPTION,
    AttrType.WRITING_MODE, AttrType.ZINDEX,
    AttrType.SMPTE_BACKGROUND_IMAGE,
    AttrType.SMPTE_BACKGROUND_IMAGE_HORIZONTAL,
    AttrType.SMPTE_BACKGROUND_IMAGE_VERTICAL,
}


def is_styling(t: AttrType) -> bool:
    return t in _STYLING


class LengthUnit(enum.Enum):
    NOT_PRESENT = "not-present"
    PIXELS = "px"
    EM = "em"
    CELLS = "c"
    PERCENT = "%"
    RELATIVE = "relative"  # normalized fraction after resolution


class TextAlign(enum.Enum):
    LEFT = "left"
    CENTER = "center"
    RIGHT = "right"
    START = "start"
    END = "end"


class DisplayAlign(enum.Enum):
    BEFORE = "before"
    CENTER = "center"
    AFTER = "after"


class WrapOption(enum.Enum):
    WRAP = "wrap"
    NO_WRAP = "noWrap"


class TimeBase(enum.Enum):
    MEDIA = "media"
    SMPTE = "smpte"
    CLOCK = "clock"


class ClockMode(enum.Enum):
    LOCAL = "local"
    GPS = "gps"
    UTC = "utc"


class MarkerMode(enum.Enum):
    CONTINUOUS = "continuous"
    DISCONTINUOUS = "discontinuous"


class DropMode(enum.Enum):
    NON_DROP = "nonDrop"
    DROP_NTSC = "dropNTSC"
    DROP_PAL = "dropPAL"


class Direction(enum.Enum):
    LTR = "ltr"
    RTL = "rtl"


class UnicodeBidi(enum.Enum):
    NORMAL = "normal"
    EMBED = "embed"
    BIDI_OVERRIDE = "bidiOverride"


class WritingMode(enum.Enum):
    LRTB = "lrtb"
    RLTB = "rltb"
    TBRL = "tbrl"
    TBLR = "tblr"
    LR = "lr"
    RL = "rl"
    TB = "tb"


class FontStyle(enum.Enum):
    NORMAL = "normal"
    ITALIC = "italic"
    OBLIQUE = "oblique"
    REVERSE_OBLIQUE = "reverseOblique"


class FontWeight(enum.Enum):
    NORMAL = "normal"
    BOLD = "bold"


class Overflow(enum.Enum):
    VISIBLE = "visible"
    HIDDEN = "hidden"
    SCROLL = "scroll"


class ShowBackground(enum.Enum):
    ALWAYS = "always"
    WHEN_ACTIVE = "whenActive"


class TimeContainer(enum.Enum):
    PAR = "par"
    SEQ = "seq"


class SmpteImageType(enum.Enum):
    PNG = "PNG"


class SmpteEncoding(enum.Enum):
    BASE64 = "Base64"


class TextDecoration(enum.IntFlag):
    NONE = 0
    UNDERLINE = 1
    STRIKETHROUGH = 2
    OVERLINE = 4
