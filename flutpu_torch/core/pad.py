"""Pads — typed dataflow endpoints with probes, sticky events and linking.

Rebuild of the GstPad contract the reference builds on: chain-function push
model, serialized in-band events, sticky CAPS/SEGMENT replay, pad probes as
interception points (reference hype/src/outputselector/imp.rs:92-112 and
plugins/injectbin/gstinjectbin.c:176-191 both hinge on probes), and ghost pads
for bin boundaries.
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, TYPE_CHECKING

from .buffer import Buffer, BufferList
from .caps import Caps
from .events import (CapsEvent, Event, EventType, FlushStartEvent,
                     FlushStopEvent, Segment, SegmentEvent)

if TYPE_CHECKING:
    from .element import Element


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


class FlowReturn(enum.Enum):
    OK = "ok"
    NOT_LINKED = "not-linked"
    FLUSHING = "flushing"
    EOS = "eos"
    NOT_NEGOTIATED = "not-negotiated"
    ERROR = "error"


class FlowError(Exception):
    def __init__(self, ret: FlowReturn, msg: str = ""):
        super().__init__(f"{ret.value}: {msg}")
        self.ret = ret


class ProbeType(enum.IntFlag):
    BUFFER = 1 << 0
    BUFFER_LIST = 1 << 1
    EVENT_DOWNSTREAM = 1 << 2
    EVENT_UPSTREAM = 1 << 3
    BLOCK = 1 << 4
    # convenience combos (GStreamer parity)
    DATA_DOWNSTREAM = BUFFER | BUFFER_LIST | EVENT_DOWNSTREAM
    BLOCK_DOWNSTREAM = BLOCK | BUFFER | BUFFER_LIST | EVENT_DOWNSTREAM


class ProbeReturn(enum.Enum):
    OK = "ok"
    DROP = "drop"
    REMOVE = "remove"
    PASS = "pass"


_probe_ids = itertools.count(1)

ProbeCallback = Callable[["Pad", Any], ProbeReturn]
ChainFunction = Callable[["Pad", Buffer], FlowReturn]
ChainListFunction = Callable[["Pad", BufferList], FlowReturn]
EventFunction = Callable[["Pad", Event], bool]


class Pad:
    def __init__(self, name: str, direction: PadDirection,
                 element: Optional["Element"] = None,
                 template_caps: Optional[Caps] = None):
        self.name = name
        self.direction = direction
        self.element = element
        self.template_caps = template_caps or Caps.any()
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None
        self.flushing = False
        self.eos = False
        self.sticky: Dict[EventType, Event] = {}
        self.chain_function: Optional[ChainFunction] = None
        self.chain_list_function: Optional[ChainListFunction] = None
        self.event_function: Optional[EventFunction] = None
        self.query_caps_function: Optional[Callable[["Pad"], Caps]] = None
        self._probes: Dict[int, tuple] = {}
        self._lock = threading.RLock()
        # ghost-pad proxying: sink ghost → internal target (``_proxy_target``
        # on the ghost); internal src pad → its ghost (``_ghost_forward``).
        self._proxy_target: Optional["Pad"] = None
        self._ghost_forward: Optional["Pad"] = None

    # -- identity ----------------------------------------------------------
    @property
    def full_name(self) -> str:
        el = self.element.name if self.element is not None else "?"
        return f"{el}:{self.name}"

    def __repr__(self) -> str:
        return f"Pad({self.full_name}, {self.direction.value})"

    # -- linking -----------------------------------------------------------
    def link(self, sink: "Pad") -> None:
        if self.direction != PadDirection.SRC or sink.direction != PadDirection.SINK:
            raise ValueError(f"link must be src→sink, got {self}→{sink}")
        if self.peer is not None or sink.peer is not None:
            raise ValueError(f"already linked: {self}→{self.peer}, {sink}→{sink.peer}")
        if not self.template_caps.can_intersect(sink.template_caps):
            raise ValueError(
                f"incompatible caps linking {self.full_name} → {sink.full_name}: "
                f"{self.template_caps} vs {sink.template_caps}")
        self.peer = sink
        sink.peer = self
        # Replay sticky events so a late-linked peer sees CAPS/SEGMENT.
        for ev in sorted(self.sticky.values(), key=_sticky_order):
            sink.send_event(ev)

    def unlink(self) -> None:
        if self.peer is not None:
            self.peer.peer = None
            self.peer = None

    def is_linked(self) -> bool:
        return self.peer is not None

    # -- caps --------------------------------------------------------------
    def query_caps(self) -> Caps:
        if self.query_caps_function is not None:
            return self.query_caps_function(self)
        if self.caps is not None:
            return self.caps
        return self.template_caps

    def peer_query_caps(self) -> Caps:
        if self.peer is None:
            return Caps.any()
        return self.peer.query_caps()

    # -- probes ------------------------------------------------------------
    def add_probe(self, ptype: ProbeType, callback: ProbeCallback) -> int:
        pid = next(_probe_ids)
        with self._lock:
            self._probes[pid] = (ptype, callback)
        return pid

    def remove_probe(self, pid: int) -> None:
        with self._lock:
            self._probes.pop(pid, None)

    def _run_probes(self, data: Any, mask: ProbeType) -> ProbeReturn:
        with self._lock:
            snapshot = list(self._probes.items())
        for pid, (ptype, cb) in snapshot:
            if not (ptype & mask):
                continue
            # BLOCK probes only fire on serialized data (blocking semantics:
            # callback runs on the streaming thread before data proceeds —
            # this is the injectbin swap synchronization point).
            ret = cb(self, data)
            if ret is None or ret == ProbeReturn.OK:
                continue
            if ret == ProbeReturn.REMOVE:
                self.remove_probe(pid)
            elif ret == ProbeReturn.DROP:
                return ProbeReturn.DROP
            elif ret == ProbeReturn.PASS:
                break
        return ProbeReturn.OK

    # -- data flow (downstream) ---------------------------------------------
    def push(self, buf: Buffer) -> FlowReturn:
        """Push a buffer out of this SRC pad to the linked peer."""
        assert self.direction == PadDirection.SRC, f"push on sink pad {self}"
        if self.flushing:
            return FlowReturn.FLUSHING
        mask = ProbeType.BUFFER | ProbeType.BLOCK
        if self._run_probes(buf, mask) == ProbeReturn.DROP:
            return FlowReturn.OK
        peer = self.peer
        if peer is None:
            if self._ghost_forward is not None:
                return self._ghost_forward.push(buf)
            return FlowReturn.NOT_LINKED
        return peer.chain(buf)

    def push_list(self, buffers: BufferList) -> FlowReturn:
        assert self.direction == PadDirection.SRC
        if self.flushing:
            return FlowReturn.FLUSHING
        mask = ProbeType.BUFFER_LIST | ProbeType.BLOCK
        if self._run_probes(buffers, mask) == ProbeReturn.DROP:
            return FlowReturn.OK
        peer = self.peer
        if peer is None:
            if self._ghost_forward is not None:
                return self._ghost_forward.push_list(buffers)
            return FlowReturn.NOT_LINKED
        return peer.chain_list(buffers)

    def _post_element_error(self, exc: Exception) -> None:
        """Log + surface an element exception as a bus ERROR message."""
        import traceback
        from .log import Category
        Category("pad").error(
            "%s: chain raised %s: %s", self, type(exc).__name__, exc)
        el = self.element
        if el is not None and hasattr(el, "post_message"):
            from .bus import Message, MessageType
            el.post_message(Message(
                MessageType.ERROR, source=el,
                structure={"error": str(exc),
                           "exception": type(exc).__name__,
                           "debug": traceback.format_exc()}))

    def chain(self, buf: Buffer) -> FlowReturn:
        """Deliver a buffer into this SINK pad."""
        assert self.direction == PadDirection.SINK, f"chain on src pad {self}"
        if self.flushing:
            return FlowReturn.FLUSHING
        if self.eos:
            return FlowReturn.EOS
        mask = ProbeType.BUFFER | ProbeType.BLOCK
        if self._run_probes(buf, mask) == ProbeReturn.DROP:
            return FlowReturn.OK
        if self._proxy_target is not None:
            return self._proxy_target.chain(buf) if self._proxy_target.direction == PadDirection.SINK \
                else self._proxy_target.push(buf)
        if self.chain_function is None:
            return FlowReturn.NOT_LINKED
        # catch-panic analog (reference scenecollector/imp.rs:272-292 wraps
        # pad functions so element bugs become flow errors, not dead
        # streaming threads): exceptions -> ERROR + bus message
        try:
            return self.chain_function(self, buf)
        except Exception as exc:  # noqa: BLE001 - boundary by design
            self._post_element_error(exc)
            return FlowReturn.ERROR

    def chain_list(self, buffers: BufferList) -> FlowReturn:
        assert self.direction == PadDirection.SINK
        if self.flushing:
            return FlowReturn.FLUSHING
        mask = ProbeType.BUFFER_LIST | ProbeType.BLOCK
        if self._run_probes(buffers, mask) == ProbeReturn.DROP:
            return FlowReturn.OK
        if self._proxy_target is not None:
            return self._proxy_target.chain_list(buffers) \
                if self._proxy_target.direction == PadDirection.SINK \
                else self._proxy_target.push_list(buffers)
        if self.chain_list_function is not None:
            return self.chain_list_function(self, buffers)
        # default: degrade to per-buffer chain
        for b in buffers:
            ret = self.chain(b)
            if ret != FlowReturn.OK:
                return ret
        return FlowReturn.OK

    # -- events ------------------------------------------------------------
    def push_event(self, event: Event) -> bool:
        """Send an event out of this pad (downstream for SRC, upstream for SINK)."""
        if self.direction == PadDirection.SRC:
            if event.is_sticky:
                self.sticky[event.type] = event
                if event.type == EventType.CAPS:
                    self.caps = event.caps  # type: ignore[attr-defined]
            if event.type == EventType.FLUSH_START:
                self.flushing = True
            elif event.type == EventType.FLUSH_STOP:
                self.flushing = False
                self.eos = False
            elif event.type == EventType.STREAM_START:
                # a new stream clears EOS state (GStreamer sticky
                # semantics) — a non-flushing upstream restart pushes
                # STREAM_START, never FLUSH_STOP
                self.eos = False
                self.sticky.pop(EventType.EOS, None)
            elif self.flushing and event.is_serialized:
                return False
            mask = ProbeType.EVENT_DOWNSTREAM | ProbeType.BLOCK
            if self._run_probes(event, mask) == ProbeReturn.DROP:
                return True
            peer = self.peer
            if peer is None:
                if self._ghost_forward is not None:
                    return self._ghost_forward.push_event(event)
                return event.is_sticky  # sticky events are stored for later
            return peer.send_event(event)
        else:
            # upstream event out of a sink pad
            mask = ProbeType.EVENT_UPSTREAM
            if self._run_probes(event, mask) == ProbeReturn.DROP:
                return True
            peer = self.peer
            if peer is None:
                return False
            return peer.send_event(event)

    def send_event(self, event: Event) -> bool:
        """Deliver an event into this pad (downstream into SINK, upstream into SRC)."""
        if self.direction == PadDirection.SINK:
            if event.type == EventType.FLUSH_START:
                self.flushing = True
            elif event.type == EventType.FLUSH_STOP:
                self.flushing = False
                self.eos = False
            elif event.type == EventType.STREAM_START:
                self.eos = False  # new stream clears EOS (see push_event)
                self.sticky.pop(EventType.EOS, None)
            elif event.is_serialized and self.flushing:
                return False
            if event.is_sticky:
                self.sticky[event.type] = event
                if event.type == EventType.CAPS:
                    self.caps = event.caps  # type: ignore[attr-defined]
            if event.type == EventType.EOS:
                self.eos = True
            mask = ProbeType.EVENT_DOWNSTREAM | ProbeType.BLOCK
            if self._run_probes(event, mask) == ProbeReturn.DROP:
                return True
            if self._proxy_target is not None:
                if self._proxy_target.direction == PadDirection.SINK:
                    return self._proxy_target.send_event(event)
                return self._proxy_target.push_event(event)
            if self.event_function is not None:
                return self.event_function(self, event)
            # default: forward downstream through the element's src pads
            return _forward_event(self, event)
        else:
            # upstream event arriving at a SRC pad
            mask = ProbeType.EVENT_UPSTREAM
            if self._run_probes(event, mask) == ProbeReturn.DROP:
                return True
            if self._proxy_target is not None:
                if self._proxy_target.direction == PadDirection.SRC:
                    return self._proxy_target.send_event(event)
                return self._proxy_target.push_event(event)
            if self.event_function is not None:
                return self.event_function(self, event)
            return _forward_event_upstream(self, event)

    # -- flush helpers -------------------------------------------------------
    def set_flushing(self, flushing: bool) -> None:
        self.flushing = flushing
        if not flushing:
            self.eos = False


def _sticky_order(ev: Event) -> int:
    order = {EventType.STREAM_START: 0, EventType.CAPS: 1,
             EventType.SEGMENT: 2, EventType.TAG: 3}
    return order.get(ev.type, 9)


def _forward_event(sink_pad: Pad, event: Event) -> bool:
    """Default sink event handler: pass to all src pads of the element."""
    el = sink_pad.element
    if el is None:
        return True
    ok = True
    for pad in el.src_pads():
        ok = pad.push_event(event) and ok
    return ok


def _forward_event_upstream(src_pad: Pad, event: Event) -> bool:
    el = src_pad.element
    if el is None:
        return False
    ok = False
    for pad in el.sink_pads():
        ok = pad.push_event(event) or ok
    return ok


class GhostPad(Pad):
    """Pad on a bin boundary proxying an internal target pad. Retargetable —
    the injectbin swap retargets its src ghost pad to the new child
    (reference gstinjectbin.c:149-166).

    SINK ghost: external data chained into the ghost is proxied to the
    internal target sink pad. SRC ghost: the internal target src pad forwards
    its pushes out through the ghost (``_ghost_forward`` back-pointer).
    """

    def __init__(self, name: str, direction: PadDirection,
                 target: Optional[Pad] = None, element=None,
                 template_caps: Optional[Caps] = None):
        super().__init__(name, direction, element, template_caps)
        self._target: Optional[Pad] = None
        if target is not None:
            self.set_target(target)

    def set_target(self, target: Optional[Pad]) -> None:
        old = self._target
        if self.direction == PadDirection.SINK:
            self._proxy_target = target
            if target is not None and old is not target:
                # replay the stickies THIS ghost has seen into the new
                # target so it negotiates (STREAM_START/CAPS/SEGMENT)
                # before the first proxied buffer — mirroring the SRC
                # ghost's replay below
                for ev in sorted(self.sticky.values(), key=_sticky_order):
                    if target.direction == PadDirection.SINK:
                        target.send_event(ev)
                    else:
                        target.push_event(ev)
        else:
            if old is not None:
                old._ghost_forward = None
            if target is not None:
                target._ghost_forward = self
                # replay target's stickies out through the ghost so the new
                # topology's downstream sees current CAPS/SEGMENT
                for ev in sorted(target.sticky.values(), key=_sticky_order):
                    self.push_event(ev)
        self._target = target

    def get_target(self) -> Optional[Pad]:
        return self._target
