"""outputselector — round-robin GOP-chunk scatter with per-branch queues.

A copy of flutpu/hype/outputselector.py on the port's core.

A bin: ghost sink → internal selector; each requested ``src_%u`` pad gets a
bounded Queue (its own streaming thread — the parallel region boundary) and a
ghost src pad. A SceneNewEvent on the sink switches the active branch to
``queues[gop_index % N]`` and emits a ForceKeyUnit so every chunk starts on a
sync point, making chunks independently encodable — the property the whole
zero-communication parallelism design rests on.

Reference: hype/src/outputselector/imp.rs (probe :92-112, round-robin
:29-44, queue depth SCENE_BUFFER_SIZE*2 = 40 :11,170-175).

Event routing: buffers and non-scene custom events go to the active branch
only; CAPS/SEGMENT/STREAM_START/TAG/EOS are broadcast to every branch (each
branch needs negotiation state, and every collector pad must see EOS to
finish its last scene).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..core import (Bin, Buffer, Element, Event, EventType, FlowReturn,
                    ForceKeyUnitEvent, GhostPad, Pad, PadDirection,
                    PropertySpec, register)
from ..core.queue import Queue
from .events import SceneNewEvent
from ..core.log import category

CAT = category("hypeoutputselector")

SCENE_BUFFER_SIZE = 20  # queue depth = 2x this, as in the reference


class _Selector(Element):
    """Internal 1→N switch. Not registered; used only inside OutputSelector."""

    FACTORY = "hype-selector"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._src_list: List[Pad] = []
        self._active: Optional[Pad] = None
        self._lock = threading.Lock()
        self._counter = 0

    def request_pad(self, template: str) -> Optional[Pad]:
        with self._lock:
            pad = Pad(f"src_{self._counter}", PadDirection.SRC, self)
            self._counter += 1
            self.add_pad(pad)
            self._src_list.append(pad)
            if self._active is None:
                self._active = pad
            return pad

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        active = self._active
        if active is None:
            return FlowReturn.NOT_LINKED
        return active.push(buf)

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        scene = SceneNewEvent.parse(event)
        if scene is not None:
            self._switch(scene)
            # scene event continues to the (new) active branch only, so each
            # collector pad sees exactly the scene boundaries of its chunks
            active = self._active
            return active.push_event(event) if active is not None else False
        if event.type in (EventType.CAPS, EventType.SEGMENT,
                          EventType.STREAM_START, EventType.TAG,
                          EventType.EOS, EventType.FLUSH_START,
                          EventType.FLUSH_STOP):
            ok = True
            for p in list(self._src_list):
                ok = p.push_event(event) and ok
            return ok
        active = self._active
        return active.push_event(event) if active is not None else False

    def _switch(self, scene: SceneNewEvent) -> None:
        with self._lock:
            if not self._src_list:
                return
            idx = scene.gop_index % len(self._src_list)
            CAT.debug("scene %d -> branch %d", scene.gop_index, idx)
            new_active = self._src_list[idx]
            if new_active is not self._active:
                # replay current negotiation stickies onto the branch about to
                # receive data (they were broadcast, but a branch requested
                # after negotiation would have missed them)
                for ev in self.sinkpad.sticky.values():
                    if ev.type not in new_active.sticky:
                        new_active.push_event(ev)
                self._active = new_active
        # chunk independence: next unit on this branch must be a keyframe
        new_active.push_event(ForceKeyUnitEvent())


@register
class OutputSelector(Bin):
    """Round-robin GOP-chunk scatter with per-branch queues and forced
    keyframes at chunk starts."""

    FACTORY = "outputselector"
    PROPERTIES = [
        PropertySpec("max-size-buffers", SCENE_BUFFER_SIZE * 2,
                     "per-branch reorder-queue depth"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self._selector = _Selector(name=f"{self.name}-sel")
        self.add(self._selector)
        self.sinkpad = self.add_ghost_pad("sink", self._selector.sinkpad)
        self._pad_counter = 0
        self._pad_lock = threading.Lock()

    def request_pad(self, template: str) -> Optional[Pad]:
        if not (template.startswith("src")):
            return None
        with self._pad_lock:
            pad_id = self._pad_counter
            self._pad_counter += 1
        q = Queue(name=f"{self.name}-q{pad_id}")
        q.set_property("max-size-buffers",
                       int(self.get_property("max-size-buffers")))
        self.add(q)
        sel_src = self._selector.request_pad("src_%u")
        sel_src.link(q.sinkpad)
        ghost = self.add_ghost_pad(f"src_{pad_id}", q.srcpad)
        q.sync_state_with_parent()
        return ghost
