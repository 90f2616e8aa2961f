"""TTML typefinder: sniff ``<?xml`` + ``<tt`` within the first KiB.

Reference: plugins/ttml/gstttmltype.c:19-70 — MIME application/ttml+xml,
extensions ttml/xml/dfxp.
"""

from __future__ import annotations

TTML_MIME = "application/ttml+xml"
TTML_EXTENSIONS = ("ttml", "xml", "dfxp")
_SNIFF_WINDOW = 1024


def type_find(data: bytes) -> bool:
    """True when the head of ``data`` looks like a TTML document."""
    head = bytes(data[:_SNIFF_WINDOW])
    if b"<tt" not in head:
        return False
    # must be an actual tt element opener, not a substring
    idx = head.find(b"<tt")
    nxt = head[idx + 3: idx + 4]
    if nxt not in (b" ", b">", b"\t", b"\n", b"\r", b":"):
        # allow namespace-prefixed <ns:tt too: scan for ":tt" openers
        if b":tt" not in head:
            return False
    return head.lstrip().startswith(b"<?xml") or head.lstrip().startswith(b"<tt")
