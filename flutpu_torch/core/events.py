"""In-band events and the segment model.

Rebuild of the GStreamer event machinery the reference coordinates with:
serialized downstream events (CAPS/SEGMENT/EOS/custom), upstream events
(SEEK), flushing events, and structure-based custom events — the reference's
``SceneNewHypeEvent`` (hype/src/lib.rs:17-43) and ``ForceKeyUnit``
(hype/src/outputselector/imp.rs:39-43) are custom events in this model.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .buffer import SECOND


class EventType(enum.Enum):
    # downstream, serialized with data
    STREAM_START = "stream-start"
    CAPS = "caps"
    SEGMENT = "segment"
    TAG = "tag"
    EOS = "eos"
    CUSTOM_DOWNSTREAM = "custom-downstream"
    GAP = "gap"
    # bidirectional, out of band
    FLUSH_START = "flush-start"
    FLUSH_STOP = "flush-stop"
    # upstream
    SEEK = "seek"
    QOS = "qos"
    CUSTOM_UPSTREAM = "custom-upstream"


_DOWNSTREAM = {
    EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT, EventType.TAG,
    EventType.EOS, EventType.CUSTOM_DOWNSTREAM, EventType.GAP,
}
_STICKY = {EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT, EventType.TAG}
_SERIALIZED = _DOWNSTREAM

_event_seq = itertools.count(1)


class Event:
    """Base event. ``structure`` carries free-form fields (GstStructure
    analog); named subclasses add typed accessors."""

    type: EventType = EventType.CUSTOM_DOWNSTREAM

    def __init__(self, structure: Optional[Dict[str, Any]] = None,
                 name: str = ""):
        self.structure: Dict[str, Any] = structure or {}
        self.name = name or self.type.value
        self.seqnum = next(_event_seq)

    @property
    def is_downstream(self) -> bool:
        return self.type in _DOWNSTREAM

    @property
    def is_sticky(self) -> bool:
        return self.type in _STICKY

    @property
    def is_serialized(self) -> bool:
        return self.type in _SERIALIZED

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.structure})"


class StreamStartEvent(Event):
    type = EventType.STREAM_START

    def __init__(self, stream_id: str = "stream-0"):
        super().__init__({"stream-id": stream_id})


class CapsEvent(Event):
    type = EventType.CAPS

    def __init__(self, caps):
        super().__init__({"caps": caps})

    @property
    def caps(self):
        return self.structure["caps"]


@dataclass
class Segment:
    """Playback segment: [start, stop) in stream time, with rate/base for
    running-time computation. Mirrors the arithmetic the reference's TTML base
    uses to clip output buffers (gstttmlbase.c:94-198)."""

    start: int = 0
    stop: Optional[int] = None
    time: int = 0
    base: int = 0
    rate: float = 1.0
    format: str = "time"

    def clip(self, pts: Optional[int], duration: Optional[int]):
        """Clip [pts, pts+duration) to the segment. Returns (pts, duration)
        or None if fully outside."""
        if pts is None:
            return pts, duration
        end = pts + (duration or 0)
        if self.stop is not None and pts >= self.stop:
            return None
        if end <= self.start and (duration or 0) > 0:
            return None
        new_pts = max(pts, self.start)
        new_end = end if self.stop is None else min(end, self.stop)
        new_dur = None if duration is None else max(0, new_end - new_pts)
        return new_pts, new_dur

    def to_running_time(self, pts: Optional[int]) -> Optional[int]:
        if pts is None or pts < self.start:
            return None
        return int((pts - self.start) / abs(self.rate)) + self.base

    def copy(self) -> "Segment":
        return Segment(self.start, self.stop, self.time, self.base,
                       self.rate, self.format)


class SegmentEvent(Event):
    type = EventType.SEGMENT

    def __init__(self, segment: Segment):
        super().__init__({"segment": segment})

    @property
    def segment(self) -> Segment:
        return self.structure["segment"]


class TagEvent(Event):
    type = EventType.TAG

    def __init__(self, tags: Dict[str, Any]):
        super().__init__({"tags": tags})


class EosEvent(Event):
    type = EventType.EOS

    def __init__(self):
        super().__init__({})


class GapEvent(Event):
    type = EventType.GAP

    def __init__(self, pts: int, duration: Optional[int] = None):
        super().__init__({"pts": pts, "duration": duration})


class FlushStartEvent(Event):
    type = EventType.FLUSH_START

    def __init__(self):
        super().__init__({})


class FlushStopEvent(Event):
    type = EventType.FLUSH_STOP

    def __init__(self, reset_time: bool = True):
        super().__init__({"reset-time": reset_time})


class SeekEvent(Event):
    type = EventType.SEEK

    def __init__(self, start: int, stop: Optional[int] = None,
                 rate: float = 1.0, flush: bool = True, format: str = "time"):
        super().__init__({"start": start, "stop": stop, "rate": rate,
                          "flush": flush, "format": format})

    @property
    def start(self) -> int:
        return self.structure["start"]

    @property
    def stop(self) -> Optional[int]:
        return self.structure["stop"]

    @property
    def flush(self) -> bool:
        return self.structure["flush"]


class CustomDownstreamEvent(Event):
    type = EventType.CUSTOM_DOWNSTREAM

    def __init__(self, name: str, structure: Optional[Dict[str, Any]] = None):
        super().__init__(structure or {}, name=name)


class CustomUpstreamEvent(Event):
    type = EventType.CUSTOM_UPSTREAM

    def __init__(self, name: str, structure: Optional[Dict[str, Any]] = None):
        super().__init__(structure or {}, name=name)


class ForceKeyUnitEvent(CustomDownstreamEvent):
    """Downstream force-key-unit: next output unit must be a sync point.
    Reference analog: GstForceKeyUnit sent at each chunk start
    (hype/src/outputselector/imp.rs:39-43)."""

    def __init__(self, running_time: Optional[int] = None, all_headers: bool = True,
                 count: int = 0):
        super().__init__("GstForceKeyUnit", {
            "running-time": running_time, "all-headers": all_headers,
            "count": count,
        })
