"""scenecollector — N→1 strictly ordered gather.

A copy of flutpu/hype/scenecollector.py on the port's core.

Per-pad current-scene map plus per-scene buffer lists; a scene completes when
the *next* SceneNewEvent (or EOS) arrives on its pad; completed scenes drain
strictly in ``next_scene_to_send`` order regardless of branch completion
order, and EOS is held back until every pending scene has flushed.

Reference: hype/src/scenecollector/imp.rs (Scenes :19-34, push_buffer
:54-69, ordered pop_buffers :71-99, new_scene :107-118, finish_scene
:120-130, chain/event :139-182).

Improvement over the reference: pop+push runs under a single ordered-drain
lock, closing the reference's window where two branch threads could pop
consecutive scenes and push them out of order.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..core import (Buffer, BufferList, Element, Event, EventType, FlowReturn,
                    Pad, PadDirection, PropertySpec, register)
from .events import SceneNewEvent
from ..core.log import category

CAT = category("hypescenecollector")


class _SceneBuffers:
    __slots__ = ("buffers", "completed")

    def __init__(self):
        self.buffers = BufferList()
        self.completed = False


class _Scenes:
    """Scene accounting shared by all sink pads (thread-safe)."""

    def __init__(self):
        self.pad_scenes: Dict[str, int] = {}
        self.scene_buffers: Dict[int, _SceneBuffers] = {}
        self.next_scene_to_send = 0
        self.lock = threading.Lock()

    def push_buffer(self, pad_name: str, buf: Buffer) -> None:
        with self.lock:
            current = self.pad_scenes.get(pad_name)
            if current is None:
                # buffer before any scene event on this pad: scene 0 implied
                current = 0
                self.pad_scenes[pad_name] = current
                self.scene_buffers.setdefault(current, _SceneBuffers())
            self.scene_buffers[current].buffers.append(buf)

    def pop_completed(self) -> List[BufferList]:
        """Remove and return the run of completed scenes starting at
        next_scene_to_send, in order."""
        out: List[BufferList] = []
        with self.lock:
            scene = self.next_scene_to_send
            while scene in self.scene_buffers:
                sb = self.scene_buffers[scene]
                if not sb.completed:
                    break
                del self.scene_buffers[scene]
                out.append(sb.buffers)
                scene += 1
                self.next_scene_to_send = scene
        return out

    def new_scene(self, pad_name: str, scene: int) -> None:
        with self.lock:
            prev = self.pad_scenes.get(pad_name)
            self.pad_scenes[pad_name] = scene
            if prev is not None and prev in self.scene_buffers:
                self.scene_buffers[prev].completed = True
            self.scene_buffers.setdefault(scene, _SceneBuffers())

    def finish_scene(self, pad_name: str) -> None:
        with self.lock:
            prev = self.pad_scenes.pop(pad_name, None)
            if prev is not None and prev in self.scene_buffers:
                self.scene_buffers[prev].completed = True

    def pending(self) -> int:
        with self.lock:
            return len(self.scene_buffers)


@register
class SceneCollector(Element):
    """N-to-1 strictly ordered scene gather; EOS held until all scenes
    flush; optional dead-branch timeout."""

    FACTORY = "scenecollector"
    PROPERTIES = [
        PropertySpec("branch-timeout-ms", 0,
                     "tolerate a dead/stalled branch: if the next scene to "
                     "send stays incomplete this long while later scenes "
                     "are ready, skip it (0 = wait forever, the reference's "
                     "behavior — SURVEY §7 'ordering under failure')"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self._scenes = _Scenes()
        self._pad_counter = 0
        self._lock = threading.Lock()
        # serializes the pop→push sequence so scene order on the src pad is
        # exactly next_scene_to_send order even under branch-thread races
        self._drain_lock = threading.Lock()
        self._caps_pushed = False
        self._eos_sent = False
        self._stall_since: Optional[float] = None
        self._stalled_scene: Optional[int] = None

    def request_pad(self, template: str) -> Optional[Pad]:
        if not template.startswith("sink"):
            return None
        with self._lock:
            pad = Pad(f"sink_{self._pad_counter}", PadDirection.SINK, self)
            self._pad_counter += 1
        pad.chain_function = self._sink_chain
        pad.event_function = self._sink_event
        self.add_pad(pad)
        return pad

    # -- dataflow ----------------------------------------------------------
    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._scenes.push_buffer(pad.name, buf)
        return self._drain()

    def _drain(self) -> FlowReturn:
        with self._drain_lock:
            self._maybe_skip_stalled()
            for blist in self._scenes.pop_completed():
                CAT.log("draining scene with %d buffers", len(blist))
                ret = self.srcpad.push_list(blist)
                if ret not in (FlowReturn.OK, FlowReturn.NOT_LINKED):
                    return ret
        return FlowReturn.OK

    def _maybe_skip_stalled(self) -> None:
        """Dead-branch tolerance: when later scenes are complete but the head
        scene isn't, start a timer; past the timeout, drop the head scene so
        the stream keeps flowing (the reference stalls forever here)."""
        timeout_ms = int(self.get_property("branch-timeout-ms") or 0)
        if timeout_ms <= 0:
            return
        import time as _time
        with self._scenes.lock:
            head = self._scenes.next_scene_to_send
            sb = self._scenes.scene_buffers.get(head)
            blocked = (sb is not None and not sb.completed
                       and any(s > head and b.completed
                               for s, b in self._scenes.scene_buffers.items()))
            if not blocked:
                self._stall_since = None
                self._stalled_scene = None
                return
            now = _time.monotonic()
            if self._stalled_scene != head:
                self._stalled_scene = head
                self._stall_since = now
                return
            if (now - (self._stall_since or now)) * 1000 >= timeout_ms:
                CAT.warning("branch stalled: skipping scene %d (%d buffers)",
                            head, len(sb.buffers))
                del self._scenes.scene_buffers[head]
                self._scenes.next_scene_to_send = head + 1
                self._stall_since = None
                self._stalled_scene = None

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        scene = SceneNewEvent.parse(event)
        if scene is not None:
            self._scenes.new_scene(pad.name, scene.gop_index)
            self._drain()
            return True
        if event.type == EventType.CAPS:
            # all branches carry identical caps; forward once
            with self._lock:
                if self._caps_pushed:
                    return True
                self._caps_pushed = True
            return self.srcpad.push_event(event)
        if event.type in (EventType.SEGMENT, EventType.STREAM_START,
                          EventType.TAG):
            # forward first occurrence only (branches duplicate them)
            if event.type in self.srcpad.sticky:
                return True
            return self.srcpad.push_event(event)
        if event.type == EventType.EOS:
            self._scenes.finish_scene(pad.name)
            self._drain()
            if self._scenes.pending() != 0:
                return True  # hold EOS until all scenes have flushed
            with self._lock:
                if self._eos_sent:
                    return True
                self._eos_sent = True
            return self.srcpad.push_event(event)
        return self.srcpad.push_event(event)
