"""SceneNew custom event — the chunk-boundary coordination signal.

A copy of flutpu/hype/events.py on the port's core.

Reference: SceneNewHypeEvent, a custom downstream event carrying
(gop_index, gop_size) in a structure (hype/src/lib.rs:17-43).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core import CustomDownstreamEvent, Event

SCENE_NEW_EVENT_NAME = "scene-new-hype-event"


class SceneNewEvent(CustomDownstreamEvent):
    def __init__(self, gop_index: int, gop_size: int):
        super().__init__(SCENE_NEW_EVENT_NAME,
                         {"gop_index": int(gop_index), "gop_size": int(gop_size)})

    @property
    def gop_index(self) -> int:
        return self.structure["gop_index"]

    @property
    def gop_size(self) -> int:
        return self.structure["gop_size"]

    @staticmethod
    def parse(event: Event) -> Optional["SceneNewEvent"]:
        """Return the event viewed as a SceneNewEvent, or None."""
        if event.name != SCENE_NEW_EVENT_NAME:
            return None
        if isinstance(event, SceneNewEvent):
            return event
        ev = SceneNewEvent(event.structure["gop_index"], event.structure["gop_size"])
        return ev
