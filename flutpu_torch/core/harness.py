"""Test harness — push/pull around an element or pipeline fragment.

Rebuild of ``gst_check``'s Harness used throughout the reference's tests
(hype/tests/tests.rs:16-46 ``test_order``): attach a fake source to the
fragment's unlinked sink pad and a capturing sink to its unlinked src pad,
push buffers and events from the test thread, pull output in order.
"""

from __future__ import annotations

import queue as _pyqueue
import time
from typing import Any, List, Optional, Union

from .bin import Bin, Pipeline
from .buffer import Buffer
from .caps import Caps
from .element import Element, State
from .events import (CapsEvent, EosEvent, Event, EventType, Segment,
                     SegmentEvent, StreamStartEvent)
from .pad import FlowReturn, Pad, PadDirection
from .parse import find_unlinked_pad, parse_launch


class Harness:
    def __init__(self, element: Union[Element, str], sink_caps: Optional[Caps] = None):
        if isinstance(element, str):
            self.pipeline: Bin = parse_launch(element)
            self.element: Element = self.pipeline
            entry = find_unlinked_pad(self.pipeline, PadDirection.SINK)
            exit_ = find_unlinked_pad(self.pipeline, PadDirection.SRC)
        else:
            self.element = element
            self.pipeline = element if isinstance(element, Bin) else None  # type: ignore
            entry = next((p for p in element.sink_pads() if not p.is_linked()), None)
            exit_ = next((p for p in element.src_pads() if not p.is_linked()), None)
            if isinstance(element, Bin) and entry is None and exit_ is None \
                    and not element.pads:
                entry = find_unlinked_pad(element, PadDirection.SINK)
                exit_ = find_unlinked_pad(element, PadDirection.SRC)

        # harness source pad → element entry
        self.srcpad = Pad("harness-src", PadDirection.SRC)
        if entry is not None:
            self.srcpad.link(entry)
        # element exit → harness sink pad
        self.sinkpad = Pad("harness-sink", PadDirection.SINK,
                           template_caps=sink_caps or Caps.any())
        self.sinkpad.chain_function = self._sink_chain
        self.sinkpad.event_function = self._sink_event
        if exit_ is not None:
            exit_.link(self.sinkpad)

        self._out: "_pyqueue.Queue[Buffer]" = _pyqueue.Queue()
        self._events: List[Event] = []
        self._eos = False
        self._started = False
        self.last_flow = FlowReturn.OK

        if self.element.set_state(State.PLAYING).name == "FAILURE":
            raise RuntimeError("harness element refused to go PLAYING")

    @classmethod
    def new_parse(cls, description: str) -> "Harness":
        return cls(description)

    # -- push side ---------------------------------------------------------
    def set_src_caps(self, caps: Union[Caps, str]) -> None:
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        if not self._started:
            self._started = True
            self.srcpad.push_event(StreamStartEvent("harness-stream"))
        self.srcpad.push_event(CapsEvent(caps))
        self.srcpad.push_event(SegmentEvent(Segment()))

    def set_sink_caps(self, caps: Union[Caps, str]) -> None:
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        self.sinkpad.template_caps = caps

    def _ensure_started(self):
        if not self._started:
            self._started = True
            self.srcpad.push_event(StreamStartEvent("harness-stream"))
            self.srcpad.push_event(SegmentEvent(Segment()))

    def push(self, buf: Buffer) -> FlowReturn:
        self._ensure_started()
        self.last_flow = self.srcpad.push(buf)
        return self.last_flow

    def push_event(self, event: Event) -> bool:
        self._ensure_started()
        return self.srcpad.push_event(event)

    def push_eos(self) -> bool:
        return self.push_event(EosEvent())

    # -- pull side ---------------------------------------------------------
    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._out.put(buf)
        return FlowReturn.OK

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        self._events.append(event)
        if event.type == EventType.EOS:
            self._eos = True
        return True

    def pull(self, timeout: float = 10.0) -> Optional[Buffer]:
        """Next buffer, or None once EOS has been reached and the queue
        is drained (the appsink pull_sample contract — loops can simply
        `while (b := h.pull(...)) is not None`). Raises TimeoutError only
        when the stream is still live and nothing arrived in time."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self._out.get(timeout=min(
                    0.05, max(0.0, deadline - time.monotonic()))
                    if self._eos else max(0.0, deadline - time.monotonic()))
            except _pyqueue.Empty:
                if self._eos:
                    # drained past EOS: end of stream, not a timeout
                    if self._out.qsize() == 0:
                        return None
                    if time.monotonic() >= deadline:
                        # a racing consumer kept the queue non-empty past the
                        # caller's deadline — honor the timeout contract
                        raise TimeoutError("harness pull timed out post-EOS")
                    continue
                raise TimeoutError("harness pull timed out")

    def try_pull(self, timeout: float = 0.1) -> Optional[Buffer]:
        try:
            return self._out.get(timeout=timeout)
        except _pyqueue.Empty:
            return None

    def buffers_received(self) -> int:
        return self._out.qsize()

    def events_received(self) -> List[Event]:
        return list(self._events)

    def wait_for_eos(self, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._eos:
                return True
            time.sleep(0.005)
        return self._eos

    # -- teardown ----------------------------------------------------------
    def teardown(self) -> None:
        self.element.set_state(State.NULL)

    def __enter__(self) -> "Harness":
        return self

    def __exit__(self, *exc) -> None:
        self.teardown()
