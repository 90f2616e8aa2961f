"""Span model: styled text runs and the active-span set.

Rebuild of plugins/ttml/gstttmlspan.c: a span is (id, chars, style) where
the integer id encodes XML document order; the active list stays sorted by
id so composition concatenates spans in document order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .enums import AttrType
from .style import Style


@dataclass
class Span:
    span_id: int
    chars: str = ""
    style: Style = field(default_factory=Style)
    region_id: Optional[str] = None

    def compose(self, default_font_size_px: Optional[float] = None) -> str:
        """Markup head + escaped chars + tail (gstttmlspan.c:21-55)."""
        head, tail = self.style.gen_markup(default_font_size_px)
        text = (self.chars.replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))
        return head + text + tail


class SpanList:
    """Active spans sorted by id (== document order)."""

    def __init__(self):
        self.spans: List[Span] = []

    def add(self, span: Span) -> None:
        idx = len(self.spans)
        for i, s in enumerate(self.spans):
            if s.span_id > span.span_id:
                idx = i
                break
        self.spans.insert(idx, span)

    def remove(self, span_id: int) -> Optional[Span]:
        for i, s in enumerate(self.spans):
            if s.span_id == span_id:
                return self.spans.pop(i)
        return None

    def get(self, span_id: int) -> Optional[Span]:
        for s in self.spans:
            if s.span_id == span_id:
                return s
        return None

    def update_attr(self, span_id: int, attr) -> None:
        s = self.get(span_id)
        if s is not None:
            s.style.set(attr)

    def clear(self) -> None:
        self.spans.clear()

    def __len__(self) -> int:
        return len(self.spans)

    def __iter__(self):
        return iter(self.spans)
