"""Parse state machine: current context + attribute stack + saved hashes.

Rebuild of plugins/ttml/gstttmlstate.c: the streaming parser's mutable
context — node type, id, begin/end and container times, rates, cell
resolution, PAR, frame geometry — plus the attribute stack (push saves the
previous value or a removal marker; pop restores), time-merge semantics
(begin/end relative to the container, dur→end, sequential containers
advance container_begin), named style/region tables for referential
styling, and the embedded-data store for SMPTE images.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from ..core.buffer import SECOND
from .attributes import Attribute, StyleRemoval
from .enums import AttrType, ClockMode, NodeType, TimeBase, is_styling
from .style import Style

UNSET = None  # CLOCK_TIME_NONE analog


class TTMLState:
    def __init__(self):
        self.style = Style()
        self.attribute_stack: List[Union[Attribute, StyleRemoval]] = []
        self.saved_styling: Dict[str, List[Attribute]] = {}
        self.saved_regions: Dict[str, List[Attribute]] = {}
        self.saved_data: Dict[str, bytes] = {}
        self.reset()

    def reset(self) -> None:
        self.node_type = NodeType.UNKNOWN
        self.id: Optional[str] = None
        self.last_span_id = 0
        self._zindex_micro = 0
        self.begin: Optional[int] = UNSET
        self.end: Optional[int] = UNSET
        self.container_begin: Optional[int] = UNSET
        self.container_end: Optional[int] = UNSET
        self.tick_rate = 1.0 * SECOND / SECOND  # ticks per second
        self.frame_rate = 30.0
        self.frame_rate_num = 1
        self.frame_rate_den = 1
        self.sub_frame_rate = 1
        self.cell_resolution_x = 32
        self.cell_resolution_y = 15
        self.whitespace_preserve = False
        self.sequential_time_container = False
        self.time_base = TimeBase.MEDIA
        self.clock_mode = ClockMode.UTC
        self.par_num = 1
        self.par_den = 1
        self.frame_width = 0
        self.frame_height = 0
        self.style.reset()
        if self.attribute_stack:
            self.attribute_stack.clear()
        self.saved_styling.clear()
        self.saved_regions.clear()
        self.saved_data.clear()

    def next_zindex_micro(self) -> int:
        v = self._zindex_micro
        self._zindex_micro += 1
        return v

    # -- set / merge -------------------------------------------------------
    def _set_attribute(self, attr: Attribute) -> Optional[Attribute]:
        """Install an attribute; returns the replaced styling attribute (for
        the stack) or None for scalar state fields."""
        t = attr.type
        if t == AttrType.NODE_TYPE:
            self.node_type = attr.value
        elif t == AttrType.ID:
            self.id = attr.value
        elif t == AttrType.BEGIN:
            self.begin = attr.value
        elif t == AttrType.END:
            self.end = attr.value
        elif t == AttrType.DUR:
            # a None DUR restores "no known duration"
            self.end = None if attr.value is None else \
                (self.begin or 0) + attr.value
        elif t == AttrType.TICK_RATE:
            self.tick_rate = attr.value
        elif t == AttrType.FRAME_RATE:
            self.frame_rate = attr.value
        elif t == AttrType.FRAME_RATE_MULTIPLIER:
            self.frame_rate_num = attr.value.numerator
            self.frame_rate_den = attr.value.denominator
        elif t == AttrType.SUBFRAME_RATE:
            self.sub_frame_rate = attr.value
        elif t == AttrType.CELL_RESOLUTION:
            self.cell_resolution_x = int(attr.value[0].value)
            self.cell_resolution_y = int(attr.value[1].value)
        elif t == AttrType.WHITESPACE_PRESERVE:
            self.whitespace_preserve = attr.value
        elif t == AttrType.TIME_CONTAINER:
            self.sequential_time_container = attr.value
        elif t == AttrType.TIME_BASE:
            self.time_base = attr.value
        elif t == AttrType.CLOCK_MODE:
            self.clock_mode = attr.value
        elif t == AttrType.PIXEL_ASPECT_RATIO:
            self.par_num = attr.value.numerator
            self.par_den = attr.value.denominator
        elif t == AttrType.STYLE:
            self.restore_attr_stack(self.saved_styling, attr.value)
        else:
            return self.style.set(attr)
        return None

    def merge_attribute(self, attr: Attribute) -> None:
        """Merge with container-time semantics (gstttmlstate.c:166-197)."""
        t = attr.type
        if t == AttrType.BEGIN:
            self.begin = attr.value
            if self.container_begin is not None:
                self.begin += self.container_begin
        elif t == AttrType.END:
            self.end = attr.value
            if self.container_begin is not None:
                self.end += self.container_begin
            if self.container_end is not None:
                self.end = min(self.end, self.container_end)
        elif t == AttrType.DUR:
            self.end = attr.value
            if self.begin is not None:
                self.end += self.begin
            if self.container_end is not None:
                self.end = min(self.end, self.container_end)
        else:
            self._set_attribute(attr)

    # -- read back ---------------------------------------------------------
    def get_attribute(self, atype: AttrType) -> Optional[Attribute]:
        """Snapshot the current value of an attribute (copy), or None."""
        simple = {
            AttrType.NODE_TYPE: self.node_type,
            AttrType.ID: self.id,
            AttrType.BEGIN: self.begin,
            AttrType.END: self.end,
            AttrType.TICK_RATE: self.tick_rate,
            AttrType.FRAME_RATE: self.frame_rate,
            AttrType.SUBFRAME_RATE: self.sub_frame_rate,
            AttrType.WHITESPACE_PRESERVE: self.whitespace_preserve,
            AttrType.TIME_CONTAINER: self.sequential_time_container,
            AttrType.TIME_BASE: self.time_base,
            AttrType.CLOCK_MODE: self.clock_mode,
        }
        if atype in simple:
            return Attribute(atype, simple[atype])
        if atype == AttrType.DUR:
            if self.begin is None or self.end is None:
                return Attribute(atype, None)
            return Attribute(atype, self.end - self.begin)
        cur = self.style.get(atype)
        return cur.copy(True) if cur is not None else None

    # -- stack -------------------------------------------------------------
    def push_attribute(self, attr: Attribute) -> None:
        """Save the current value (or a removal marker) and merge the new
        one. backgroundColor inside REGION/DIV nodes becomes the region
        background (reference gstttmlstate.c:291-303 — the Padding-testsuite
        compatibility rule)."""
        if attr.type == AttrType.BACKGROUND_COLOR and self.node_type in (
                NodeType.REGION, NodeType.DIV):
            attr = attr.copy()
            attr.type = AttrType.BACKGROUND_REGION_COLOR
        old = self.get_attribute(attr.type)
        self.attribute_stack.append(
            old if old is not None else StyleRemoval(attr.type))
        self.merge_attribute(attr)

    def pop_attribute(self) -> Tuple[Optional[AttrType], Optional[Attribute]]:
        """Restore the top of the stack. TT-node attributes survive the pop
        so document-level parameters stay visible after </tt>
        (gstttmlstate.c:341-346). Returns (restored attribute type, the
        styling attribute value that was replaced by the restore — the SET
        node's animation value in the SET case)."""
        if not self.attribute_stack:
            return None, None
        item = self.attribute_stack.pop()
        if isinstance(item, StyleRemoval):
            replaced = None
            if self.node_type != NodeType.TT:
                replaced = self.style.remove(item.removed_type)
            return item.removed_type, replaced
        replaced = None
        if self.node_type != NodeType.TT:
            replaced = self._set_attribute(item)
        return item.type, replaced

    # -- referential styling ----------------------------------------------
    def save_attr_stack(self, table: Dict[str, List[Attribute]],
                        style_id: str) -> None:
        attrs = [a.copy(True) for a in self.style]
        if attrs:
            table[style_id] = attrs

    def restore_attr_stack(self, table: Dict[str, List[Attribute]],
                           ids: Optional[str]) -> None:
        """Apply saved styling attribute sets (space-separated id list —
        TTML allows multiple style references)."""
        if not ids:
            return
        for style_id in ids.split():
            attrs = table.get(style_id)
            if attrs is None:
                continue
            for attr in attrs:
                if attr.is_styling:
                    self.push_attribute(attr.copy(True))

    # -- embedded data -----------------------------------------------------
    def save_data(self, data: bytes, data_id: str) -> None:
        self.saved_data[data_id] = data

    def restore_data(self, data_id: str) -> Optional[bytes]:
        return self.saved_data.get(data_id)
