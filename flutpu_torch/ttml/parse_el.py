"""ttmlparse — emits pango-markup text for each timeline interval.

Rebuild of plugins/ttml/gstttmlparse.c: compose the active spans into one
markup string per interval; blank output (or a lone newline) becomes a
single space so downstream text renderers clear the display instead of
keeping the previous text (the reference's textrender workarounds,
gstttmlparse.c:37-79).
"""

from __future__ import annotations

from typing import Optional

from ..core import Buffer, Caps, register
from .base import TTMLBase


@register
class TTMLParse(TTMLBase):
    """TTML parser emitting pango-markup text per timeline interval."""

    FACTORY = "ttmlparse"

    def src_caps(self) -> Caps:
        return Caps.new("text/x-raw", format="pango-markup")

    def gen_buffer(self, begin: int, end: int) -> Optional[Buffer]:
        text = "".join(span.compose() for span in self.active_spans)
        if not text or text == "\n":
            text = " "  # clear-display buffer
        return Buffer(text.encode("utf-8"))
