"""Bin and Pipeline — element containers with state propagation.

Rebuild of GstBin semantics used by the reference's composite elements (hype
bin, outputselector bin, injectbin): child management, sink-first state
propagation, ghost pads on the boundary, and a bus on the pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .bus import Bus, Message, MessageType
from .element import Element, State, StateChange, StateChangeReturn
from .pad import GhostPad, Pad, PadDirection


class Bin(Element):
    FACTORY = "bin"

    def __init__(self, name: Optional[str] = None, **props):
        self.children: Dict[str, Element] = {}
        super().__init__(name, **props)

    # -- children ----------------------------------------------------------
    def add(self, *elements: Element) -> None:
        for el in elements:
            if el.name in self.children:
                raise ValueError(f"duplicate child name {el.name!r} in {self.name}")
            self.children[el.name] = el
            el.parent = self

    def remove(self, el: Element) -> None:
        self.children.pop(el.name, None)
        el.parent = None

    def get_by_name(self, name: str) -> Optional[Element]:
        if name in self.children:
            return self.children[name]
        for child in self.children.values():
            if isinstance(child, Bin):
                found = child.get_by_name(name)
                if found is not None:
                    return found
        return None

    def iterate_elements(self) -> List[Element]:
        return list(self.children.values())

    # -- ghost pads --------------------------------------------------------
    def add_ghost_pad(self, name: str, target: Pad) -> GhostPad:
        ghost = GhostPad(name, target.direction, target=target, element=self)
        self.add_pad(ghost)
        return ghost

    # -- state -------------------------------------------------------------
    def _sorted_children(self) -> List[Element]:
        """Sinks first (no src pads), sources last — GstBin ordering so
        downstream elements are ready before data can arrive."""
        def key(el: Element):
            has_src = bool(el.src_pads())
            has_sink = bool(el.sink_pads())
            if not has_src:
                return 0  # pure sink
            if not has_sink:
                return 2  # pure source
            return 1
        return sorted(self.children.values(), key=key)

    def change_state(self, transition: StateChange) -> StateChangeReturn:
        _, target = transition.value
        children = self._sorted_children()
        if target < self.state:
            children = children  # teardown also sinks-first is fine
        for child in children:
            if child.locked_state:
                continue
            if child.set_state(State(target)) == StateChangeReturn.FAILURE:
                return StateChangeReturn.FAILURE
        return super().change_state(transition)


class Pipeline(Bin):
    FACTORY = "pipeline"

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self.bus = Bus()

    def play(self) -> StateChangeReturn:
        return self.set_state(State.PLAYING)

    def stop(self) -> StateChangeReturn:
        return self.set_state(State.NULL)
