"""flutpu_torch.core — host-side streaming dataflow framework.

The port's own copy of flutpu's dataflow layer, with the same module
names and public API: elements, pads, caps, buffers, events, bins,
queues, a registry with a textual pipeline language, and a push/pull
test harness. All pixel math lives in flutpu_torch.codec and its CUDA
kernels; this layer owns topology, ordering and time. Its registry holds
the core elements and the port's (``cudajpegenc``, ``cudafvcenc``), so a
launch string here holds the port's elements only.
"""

from .buffer import (Buffer, BufferFlags, BufferList, CLOCK_TIME_NONE,
                     MSECOND, NSECOND, SECOND, USECOND)
from .caps import Caps, IntRange, ValueList
from .element import (Element, PropertySpec, State, StateChange,
                      StateChangeReturn)
from .events import (CapsEvent, CustomDownstreamEvent, CustomUpstreamEvent,
                     EosEvent, Event, EventType, FlushStartEvent,
                     FlushStopEvent, ForceKeyUnitEvent, GapEvent, SeekEvent,
                     Segment, SegmentEvent, StreamStartEvent, TagEvent)
from .pad import (FlowError, FlowReturn, GhostPad, Pad, PadDirection,
                  ProbeReturn, ProbeType)
from .bin import Bin, Pipeline
from .bus import Bus, Message, MessageType
from .registry import factories, make, register
from .parse import parse_launch, parse_bin_from_description
from .harness import Harness

__all__ = [
    "Buffer", "BufferFlags", "BufferList", "CLOCK_TIME_NONE", "MSECOND",
    "NSECOND", "SECOND", "USECOND", "Caps", "IntRange", "ValueList",
    "Element", "PropertySpec", "State", "StateChange", "StateChangeReturn",
    "CapsEvent", "CustomDownstreamEvent", "CustomUpstreamEvent", "EosEvent",
    "Event", "EventType", "FlushStartEvent", "FlushStopEvent",
    "ForceKeyUnitEvent", "GapEvent", "SeekEvent", "Segment", "SegmentEvent",
    "StreamStartEvent", "TagEvent", "FlowError", "FlowReturn", "GhostPad",
    "Pad", "PadDirection", "ProbeReturn", "ProbeType", "Bin", "Pipeline",
    "Bus", "Message", "MessageType", "factories", "make", "register",
    "parse_launch", "parse_bin_from_description", "Harness",
]
