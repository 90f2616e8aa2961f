"""Event timeline: the render main loop's schedule.

Rebuild of plugins/ttml/gstttmlevent.c: six event kinds (span/region ×
begin/end/attr-update) in a timestamp-sorted list with the
region-encloses-span tiebreak; ``flush`` walks events up to the input
buffer's stop time, emitting one output interval per gap between
consecutive timestamps — this loop drives every derived element's
``gen_buffer``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from .attributes import Attribute
from .span import Span
from .style import Style


class TimelineEventType(enum.Enum):
    SPAN_BEGIN = "span-begin"
    SPAN_END = "span-end"
    SPAN_ATTR_UPDATE = "span-attr-update"
    REGION_BEGIN = "region-begin"
    REGION_END = "region-end"
    REGION_ATTR_UPDATE = "region-attr-update"


@dataclass
class TimelineEvent:
    timestamp: int
    type: TimelineEventType
    span: Optional[Span] = None          # SPAN_BEGIN
    span_id: int = 0                     # SPAN_END / SPAN_ATTR_UPDATE
    attr: Optional[Attribute] = None     # *_ATTR_UPDATE
    region_id: Optional[str] = None      # REGION_*
    style: Optional[Style] = None        # REGION_BEGIN


def _tiebreak(t: TimelineEventType) -> int:
    """Regions enclose spans at equal timestamps
    (gstttmlevent.c:51-68)."""
    if t == TimelineEventType.REGION_BEGIN:
        return -1
    if t == TimelineEventType.REGION_END:
        return 1
    return 0


class Timeline:
    def __init__(self):
        self.events: List[TimelineEvent] = []

    def insert(self, event: Optional[TimelineEvent]) -> None:
        if event is None:
            return
        idx = len(self.events)
        for i, e in enumerate(self.events):
            if e.timestamp > event.timestamp:
                idx = i
                break
            if e.timestamp == event.timestamp:
                # stable insertion honoring the region tiebreak
                if _tiebreak(event.type) < _tiebreak(e.type):
                    idx = i
                    break
        self.events.insert(idx, event)

    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()

    def last_timestamp(self) -> Optional[int]:
        return self.events[-1].timestamp if self.events else None

    def flush(self, stop_time: int, last_out_time: int,
              parse: Callable[[TimelineEvent], None],
              gen_buffer: Callable[[int, int], None],
              emit_tail: bool = True) -> int:
        """Consume events up to ``stop_time``. For each gap between
        ``last_out_time`` and the next event, call ``gen_buffer(begin,
        end)`` first, then apply the event via ``parse``. Finally emit the
        tail interval up to stop_time (skipped when the stop is unbounded —
        an infinite trailing clear buffer would poison concatenated-document
        streams). Returns the new last_out_time. (gstttmlevent.c:208-233)"""
        while self.events:
            event = self.events[0]
            if event.timestamp > stop_time:
                break
            self.events.pop(0)
            if event.timestamp > last_out_time:
                gen_buffer(last_out_time, event.timestamp)
                last_out_time = event.timestamp
            parse(event)
        if emit_tail and last_out_time < stop_time:
            gen_buffer(last_out_time, stop_time)
            last_out_time = stop_time
        return last_out_time


# constructors mirroring the reference's helpers -----------------------------

def span_begin(state, span: Span) -> TimelineEvent:
    ts = state.begin if state.begin is not None else 0
    return TimelineEvent(ts, TimelineEventType.SPAN_BEGIN, span=span)


def span_end(state, span_id: int) -> Optional[TimelineEvent]:
    if state.end is None:
        return None
    return TimelineEvent(state.end, TimelineEventType.SPAN_END,
                         span_id=span_id)


def span_attr_update(span_id: int, timestamp: int,
                     attr: Attribute) -> TimelineEvent:
    return TimelineEvent(timestamp, TimelineEventType.SPAN_ATTR_UPDATE,
                         span_id=span_id, attr=attr.copy(False))


def region_begin(timestamp: int, region_id: str, style: Style) -> TimelineEvent:
    return TimelineEvent(timestamp, TimelineEventType.REGION_BEGIN,
                         region_id=region_id, style=style)


def region_end(timestamp: int, region_id: str) -> TimelineEvent:
    return TimelineEvent(timestamp, TimelineEventType.REGION_END,
                         region_id=region_id)


def region_attr_update(timestamp: int, region_id: str,
                       attr: Attribute) -> TimelineEvent:
    return TimelineEvent(timestamp, TimelineEventType.REGION_ATTR_UPDATE,
                         region_id=region_id, attr=attr.copy(False))
