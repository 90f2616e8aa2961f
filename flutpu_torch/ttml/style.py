"""Style model: a set of styling attributes + markup generation.

Rebuild of plugins/ttml/gstttmlstyle.c: styles hold styling attributes (dict
keyed by AttrType instead of the reference's linked list), support copy/
set/get with STYLE_REMOVAL handling, generate markup for the ttmlparse
output (a pango-markup-compatible format), and expand animated attributes
into timeline events.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from .attributes import Attribute, AttributeEvent, color_to_string
from .enums import (AttrType, FontStyle, FontWeight, LengthUnit,
                    TextDecoration, is_styling)


class Style:
    def __init__(self):
        self.attributes: Dict[AttrType, Attribute] = {}

    def reset(self) -> None:
        self.attributes.clear()

    def get(self, atype: AttrType) -> Optional[Attribute]:
        """Present attributes only: an Attribute whose value is None is a
        timeline-only placeholder (a SET animating an attribute its
        parent never declared — round-4 corpus Animation009/010) and must
        read as ABSENT until its first animation event fires; every
        consumer (markup generation, renderer layout) reads through here.
        Writers that must see placeholders use ``attributes`` directly."""
        a = self.attributes.get(atype)
        return a if a is not None and a.value is not None else None

    def set(self, attr: Attribute) -> Optional[Attribute]:
        """Install attr; returns the replaced attribute (or None)."""
        prev = self.attributes.get(attr.type)
        self.attributes[attr.type] = attr
        return prev

    def remove(self, atype: AttrType) -> Optional[Attribute]:
        return self.attributes.pop(atype, None)

    def copy(self, include_timelines: bool = True) -> "Style":
        s = Style()
        for t, a in self.attributes.items():
            s.attributes[t] = a.copy(include_timelines)
        return s

    def __iter__(self) -> Iterator[Attribute]:
        return iter(self.attributes.values())

    def __len__(self) -> int:
        return len(self.attributes)

    # -- markup generation -------------------------------------------------
    def gen_markup(self, default_font_size_px: Optional[float] = None
                   ) -> Tuple[str, str]:
        """(head, tail) markup strings wrapping a span's characters.

        Pango-compatible subset: <span> attributes for colors/fonts plus
        <u>/<s> wrappers — the contract of the reference's ttmlparse output
        (gstttmlstyle.c:139-281)."""
        span_attrs: List[str] = []
        wrappers: List[str] = []

        a = self.get(AttrType.COLOR)
        if a is not None:
            span_attrs.append(f'fgcolor="#{a.value >> 8 & 0xFFFFFF:06x}"')
            alpha = a.value & 0xFF
            if alpha != 0xFF:
                span_attrs.append(f'fgalpha="{int(alpha / 255 * 65535)}"')
        a = self.get(AttrType.BACKGROUND_COLOR)
        if a is not None:
            span_attrs.append(f'bgcolor="#{a.value >> 8 & 0xFFFFFF:06x}"')
            alpha = a.value & 0xFF
            if alpha != 0xFF:
                span_attrs.append(f'bgalpha="{int(alpha / 255 * 65535)}"')
        a = self.get(AttrType.FONT_FAMILY)
        if a is not None and a.value:
            span_attrs.append(f'font_family="{a.value}"')
        a = self.get(AttrType.FONT_SIZE)
        if a is not None and a.value[0].present:
            # two-length fontSize: the SECOND length (vertical) is the
            # point size — reference gstttmlstyle.c:181-199 (size2
            # overrides size1 when both are pixel lengths)
            size = a.value[0].value
            unit = a.value[0].unit
            if len(a.value) > 1 and a.value[1].present \
                    and a.value[1].unit == LengthUnit.PIXELS \
                    and unit == LengthUnit.PIXELS:
                size = a.value[1].value
            if unit == LengthUnit.PIXELS:
                span_attrs.append(f'font_size="{int(size)}px"')
        a = self.get(AttrType.FONT_STYLE)
        if a is not None and a.value in (FontStyle.ITALIC, FontStyle.OBLIQUE):
            span_attrs.append(f'font_style="{a.value.value}"')
        a = self.get(AttrType.FONT_WEIGHT)
        if a is not None and a.value == FontWeight.BOLD:
            span_attrs.append('font_weight="bold"')
        a = self.get(AttrType.TEXT_DECORATION)
        if a is not None:
            if a.value & TextDecoration.UNDERLINE:
                wrappers.append("u")
            if a.value & TextDecoration.STRIKETHROUGH:
                wrappers.append("s")

        head = ""
        tail = ""
        if span_attrs:
            head += "<span " + " ".join(span_attrs) + ">"
            tail = "</span>" + tail
        for w in wrappers:
            head += f"<{w}>"
            tail = f"</{w}>" + tail
        return head, tail

    # -- animation ---------------------------------------------------------
    def collect_events(self) -> List[Tuple[int, Attribute]]:
        """All (timestamp, new_attr) animation updates across attributes."""
        out: List[Tuple[int, Attribute]] = []
        for attr in self.attributes.values():
            for ev in attr.timeline:
                out.append((ev.timestamp, ev.attr))
        return out
