"""Buffer and BufferList — the unit of dataflow.

Rebuild of the GstBuffer contract the reference depends on: pts/dts/duration/
offset timestamps (hype keys chunking off ``offset``, see reference
hype/src/scenedetector/imp.rs:141-161), flag bits (DELTA_UNIT/HEADER), and an
opaque payload. The payload may be host bytes, a numpy array, or a
device-resident tensor — elements declare which they accept via caps, and
device tensors flow through pads without forced host copies.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Iterable, Iterator, List, Optional

CLOCK_TIME_NONE: Optional[int] = None

# Convenience time constants (nanoseconds, like GstClockTime).
NSECOND = 1
USECOND = 1_000
MSECOND = 1_000_000
SECOND = 1_000_000_000


class BufferFlags(enum.IntFlag):
    NONE = 0
    DELTA_UNIT = 1 << 0   # not a sync point (non-keyframe)
    HEADER = 1 << 1       # stream header (SPS/PPS analog)
    DISCONT = 1 << 2      # discontinuity in the stream
    GAP = 1 << 3          # filler for a data gap
    MARKER = 1 << 4       # access-unit boundary


class Buffer:
    """A timestamped payload.

    ``data`` is opaque to the core: bytes, numpy array, tensor, or any
    object the downstream element understands per the negotiated caps.
    """

    __slots__ = ("data", "pts", "dts", "duration", "offset", "offset_end",
                 "flags", "meta")

    def __init__(
        self,
        data: Any = b"",
        pts: Optional[int] = None,
        dts: Optional[int] = None,
        duration: Optional[int] = None,
        offset: Optional[int] = None,
        offset_end: Optional[int] = None,
        flags: BufferFlags = BufferFlags.NONE,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.data = data
        self.pts = pts
        self.dts = dts
        self.duration = duration
        self.offset = offset
        self.offset_end = offset_end
        self.flags = flags
        self.meta: Dict[str, Any] = meta if meta is not None else {}

    def copy(self) -> "Buffer":
        return Buffer(self.data, self.pts, self.dts, self.duration,
                      self.offset, self.offset_end, self.flags, dict(self.meta))

    def has_flag(self, flag: BufferFlags) -> bool:
        return bool(self.flags & flag)

    def set_flag(self, flag: BufferFlags) -> None:
        self.flags |= flag

    def unset_flag(self, flag: BufferFlags) -> None:
        self.flags &= ~flag

    @property
    def size(self) -> int:
        d = self.data
        if isinstance(d, (bytes, bytearray, memoryview)):
            return len(d)
        if hasattr(d, "nbytes"):
            return int(d.nbytes)
        return 0

    def end_pts(self) -> Optional[int]:
        if self.pts is None:
            return None
        return self.pts + (self.duration or 0)

    def __repr__(self) -> str:
        def ts(v):
            return "none" if v is None else f"{v / SECOND:.6f}s"
        return (f"Buffer(pts={ts(self.pts)}, dur={ts(self.duration)}, "
                f"offset={self.offset}, size={self.size}, flags={self.flags!r})")


class BufferList:
    """Ordered group of buffers pushed as one unit (scenecollector analog:
    reference hype/src/scenecollector/imp.rs:19-34 accumulates per-scene
    BufferLists and pushes them whole)."""

    __slots__ = ("buffers",)

    def __init__(self, buffers: Optional[Iterable[Buffer]] = None):
        self.buffers: List[Buffer] = list(buffers) if buffers else []

    def append(self, buf: Buffer) -> None:
        self.buffers.append(buf)

    def __len__(self) -> int:
        return len(self.buffers)

    def __iter__(self) -> Iterator[Buffer]:
        return iter(self.buffers)

    def __getitem__(self, i: int) -> Buffer:
        return self.buffers[i]

    def __repr__(self) -> str:
        return f"BufferList(n={len(self.buffers)})"
