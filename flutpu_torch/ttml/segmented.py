"""ttmlsegmentedparse — re-serialize each interval as a standalone TTML doc.

Rebuild of plugins/ttml/gstttmlsegmentedparse.c: for every timeline interval
emit a complete ``<tt>`` document (caps ``application/ttml+xml,
segmented=true``): head with the saved named styles and the active regions,
body with one ``<p begin end>`` per line (active spans split on newlines,
each fragment wrapped in a styled ``<span>``).
"""

from __future__ import annotations

from typing import List, Optional
from xml.sax.saxutils import escape, quoteattr

from ..core import Buffer, Caps, SECOND, register
from .attributes import ATTR_BY_NAME, Attribute, color_to_string
from .base import TTMLBase
from .enums import AttrType
from .style import Style


def dump_time(ns: int) -> str:
    """ns → ``H:MM:SS.fffffffff`` (GST_TIME_FORMAT shape, reparseable)."""
    s, frac = divmod(int(ns), SECOND)
    h, rem = divmod(s, 3600)
    m, sec = divmod(rem, 60)
    return f"{h}:{m:02d}:{sec:02d}.{frac:09d}"


def dump_attribute(attr: Attribute) -> Optional[str]:
    """Attribute value → string form (prefers the original raw spelling)."""
    if attr.raw:
        return attr.raw
    v = attr.value
    if v is None:
        return None
    if attr.type in (AttrType.BEGIN, AttrType.END, AttrType.DUR):
        return dump_time(v)
    if attr.type in (AttrType.COLOR, AttrType.BACKGROUND_COLOR,
                     AttrType.BACKGROUND_REGION_COLOR):
        return color_to_string(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    if hasattr(v, "value"):  # enums
        return str(v.value)
    return str(v)


_ATTR_NAME = {t: name for name, t in ATTR_BY_NAME.items()}
# prefer canonical spellings for duplicated entries
_ATTR_NAME[AttrType.SMPTE_IMAGE_TYPE] = "imagetype"
_ATTR_NAME[AttrType.ID] = "xml:id"
_ATTR_NAME[AttrType.WHITESPACE_PRESERVE] = "xml:space"
_ATTR_NAME[AttrType.BACKGROUND_REGION_COLOR] = "backgroundColor"


def _dump_attrs(attrs, skip_region: bool) -> str:
    # dedupe by XML attribute NAME, later values winning: a region whose
    # backgroundColor was animated carries BOTH the base
    # BACKGROUND_REGION_COLOR and the updated BACKGROUND_COLOR — both
    # serialize as "backgroundColor", and a duplicate attribute is
    # malformed XML that aborts the downstream reparse (round-4 corpus
    # roundtrip sweep, Animation009)
    out: dict = {}
    for attr in attrs:
        if attr.type == AttrType.REGION and skip_region:
            continue
        name = _ATTR_NAME.get(attr.type)
        val = dump_attribute(attr)
        if name and val is not None:
            out[name] = val
    return "".join(f" {n}={quoteattr(v)}" for n, v in out.items())


@register
class TTMLSegmentedParse(TTMLBase):
    """Re-serializes each interval as a standalone segmented TTML doc."""

    FACTORY = "ttmlsegmentedparse"

    def src_caps(self) -> Caps:
        return Caps.new("application/ttml+xml", segmented=True)

    def gen_buffer(self, begin: int, end: int) -> Optional[Buffer]:
        state = self.parse_state
        parts: List[str] = ['<?xml version="1.0" encoding="utf-8"?>\n']
        ns_attrs = ""
        have_default = False
        for ns in self.namespaces.namespaces:
            key = "xmlns" if not ns.name else f"xmlns:{ns.name}"
            if key == "xmlns":
                have_default = True
            ns_attrs += f" {key}={quoteattr(ns.value)}"
        if not have_default:
            ns_attrs = ' xmlns="http://www.w3.org/ns/ttml"' + ns_attrs
        cell = f"{state.cell_resolution_x} {state.cell_resolution_y}"
        parts.append(f'<tt{ns_attrs} xml:space="preserve" '
                     f'cellResolution="{cell}">')

        parts.append("<head>")
        if state.saved_styling:
            parts.append("<styling>")
            for sid, attrs in state.saved_styling.items():
                parts.append(f"<style xml:id={quoteattr(sid)}"
                             f"{_dump_attrs(attrs, skip_region=True)}/>")
            parts.append("</styling>")
        if self.active_regions:
            parts.append("<layout>")
            for rid, style in self.active_regions.items():
                parts.append(f"<region xml:id={quoteattr(rid)}"
                             f"{_dump_attrs(style, skip_region=True)}/>")
            parts.append("</layout>")
        parts.append("</head><body>")

        begin_s = dump_time(begin)
        end_s = dump_time(end)
        open_p = False
        for span in self.active_spans:
            # split merged paragraphs back on newlines
            for i, frag in enumerate(span.chars.split("\n")):
                if i > 0 and open_p:
                    parts.append("</p>")
                    open_p = False
                if not frag:
                    continue
                if not open_p:
                    region_attr = ""
                    ra = span.style.get(AttrType.REGION)
                    if ra is not None and ra.value:
                        region_attr = f" region={quoteattr(str(ra.value))}"
                    parts.append(f'<p begin="{begin_s}" end="{end_s}"'
                                 f"{region_attr}>")
                    open_p = True
                style_attrs = _dump_attrs(
                    (a for a in span.style if a.is_styling),
                    skip_region=True)
                parts.append(f"<span{style_attrs}>{escape(frag)}</span>")
        if open_p:
            parts.append("</p>")
        parts.append("</body></tt>\n")
        return Buffer("".join(parts).encode("utf-8"))
