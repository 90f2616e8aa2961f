"""TTML namespace handling: whitelist check + name/value store.

Reference: gstttmlutils.c:296-310 (namespace whitelist) and
gstttmlnamespace.c (pair store used for re-serialization by
ttmlsegmentedparse).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

_TTML_NS_PREFIXES = (
    "http://www.w3.org/ns/ttml",
    "http://www.w3.org/2006/04/ttaf1",
    "http://www.w3.org/2006/10/ttaf1",
    "http://www.w3.org/XML/1998/namespace",
    "http://www.smpte-ra.org/schemas/2052-1/2010/smpte-tt",
    "http://www.smpte-ra.org/schemas/2052-1/2013/smpte-tt",
)


def namespace_is_ttml(ns: Optional[str]) -> bool:
    """True when the namespace belongs to the TTML family (or is absent —
    unprefixed attributes are accepted like the reference does)."""
    if ns is None or ns == "":
        return True
    return any(ns.startswith(p) for p in _TTML_NS_PREFIXES)


@dataclass
class Namespace:
    name: str   # prefix ('' for default)
    value: str  # URI


class NamespaceStore:
    def __init__(self):
        self.namespaces: List[Namespace] = []

    def add(self, name: Optional[str], value: str) -> None:
        name = name or ""
        for ns in self.namespaces:
            if ns.name == name:
                ns.value = value
                return
        self.namespaces.append(Namespace(name, value))

    def clear(self) -> None:
        self.namespaces.clear()
