"""flutpu_torch.ttml — TTML (W3C Timed Text) subtitle engine (port of
flutpu/ttml).

The streaming host-side parse engine (state machine, attribute model,
event timeline — pure logic, no device work) is a copy of flutpu's; the
renderer's device half runs in PyTorch. Elements:

- ``ttmlparse``             → pango-markup text buffers (host only)
- ``ttmlsegmentedparse``    → standalone per-interval TTML documents (host
                              only)
- ``cudattmlrender``        → BGRA overlay frames (host text layout +
                              device compositing in flutpu_torch.ttml.render)
- ``cudaoverlaycompositor`` → burns the overlay stream into raw video
"""

from .enums import AttrType, NodeType, TextAlign, TimeBase
from .attributes import Attribute, Length, parse_attribute, parse_color
from .state import TTMLState
from .style import Style
from .span import Span, SpanList
from .timeline import Timeline, TimelineEvent, TimelineEventType
from .base import TTMLBase
from .parse_el import TTMLParse
from .segmented import TTMLSegmentedParse
from .render import OverlayCompositor, TTMLRender
from .typefind import TTML_MIME, type_find

__all__ = [
    "AttrType", "NodeType", "TextAlign", "TimeBase", "Attribute", "Length",
    "parse_attribute", "parse_color", "TTMLState", "Style", "Span",
    "SpanList", "Timeline", "TimelineEvent", "TimelineEventType", "TTMLBase",
    "TTMLParse", "TTMLSegmentedParse", "TTMLRender", "OverlayCompositor",
    "TTML_MIME", "type_find",
]
