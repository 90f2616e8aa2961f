"""hype — HYbrid Parallel Encoder bin.

A copy of flutpu/hype/hypebin.py on the port's core: its encoder check
(``_is_video_encoder``) imports ``..codec.base``, the port's
``VideoEncoder``, so ``cudajpegenc`` and ``cudafvcenc`` sit in a hype.

Composite: scenedetector → outputselector → [encoder-0..4] → scenecollector
→ capsfilter, with ghost sink/src pads. Branch links are built at NULL→READY;
each encoder's src template caps are intersected into the capsfilter — an
empty intersection fails the state change (the reference's incompatible-
encoder test contract). Each child must be a video encoder (or ``identity``).

Reference: hype/src/hype/imp.rs (NUM_ENC=5 :9, create_pipeline :34-63,
construct-only encoder props :102-125, encoder type check :139-152, static
topology :167-190, state hook :234-247, ChildProxy :252-275).

Encoder property values may be an Element instance or a factory description
string like ``"identity sleep-time=100"`` (gst-launch analog of passing an
element-valued property).
"""

from __future__ import annotations

import shlex
from typing import Dict, List, Optional

from ..core import (Bin, Caps, Element, PropertySpec, State, StateChange,
                    StateChangeReturn, make, register)
from ..core.elements import CapsFilter, Identity
from ..core.parse import _parse_value
from .outputselector import OutputSelector
from .scenecollector import SceneCollector
from .scenedetector import SceneDetector

DEFAULT_GOP_SIZE = 10
NUM_ENC = 5
ENC_PREFIX = "encoder-"


def _is_video_encoder(el: Element) -> bool:
    from ..codec.base import VideoEncoder
    return isinstance(el, (VideoEncoder, Identity))


def _make_from_description(desc: str) -> Element:
    """Instantiate an element from ``"factory prop=val prop=val"``."""
    parts = shlex.split(desc)
    el = make(parts[0])
    for p in parts[1:]:
        k, _, v = p.partition("=")
        el.set_property(k, _parse_value(v))
    return el


@register
class Hype(Bin):
    """HYbrid Parallel Encoder bin: GOP-chunk scatter -> N encoder
    branches -> strictly ordered gather (reference: hype)."""

    FACTORY = "hype"
    PROPERTIES = (
        [PropertySpec("gop-size", DEFAULT_GOP_SIZE)]
        + [PropertySpec(f"{ENC_PREFIX}{i}", None, construct_only=True,
                        ptype=object) for i in range(NUM_ENC)]
    )

    def __init__(self, name: Optional[str] = None, **props):
        self.scenedetector = SceneDetector(name="scenedetector")
        self.outputselector = OutputSelector(name="outputselector")
        self.scenecollector = SceneCollector(name="scenecollector")
        self.capsfilter = CapsFilter(name="capsfilter")
        super().__init__(name, **props)
        self.add(self.scenedetector, self.outputselector,
                 self.scenecollector, self.capsfilter)
        self.scenedetector.link(self.outputselector)
        self.scenecollector.srcpad.link(self.capsfilter.sinkpad)
        self.sinkpad = self.add_ghost_pad("sink", self.scenedetector.sinkpad)
        self.srcpad = self.add_ghost_pad("src", self.capsfilter.srcpad)
        self._links_built = False

    # -- properties --------------------------------------------------------
    def do_set_property(self, name: str, value) -> None:
        if name == "gop-size" and value is not None:
            self.scenedetector.set_property("gop-size", int(value))
        elif name.startswith(ENC_PREFIX) and value is not None:
            if self.get_by_name(name) is not None:
                return  # already added; keep first (reference warns+skips)
            el = value if isinstance(value, Element) else \
                _make_from_description(str(value))
            if not _is_video_encoder(el):
                raise ValueError(
                    f"{name}: {el.FACTORY!r} is not a video encoder")
            el.name = name
            self.add(el)

    def do_get_property(self, name: str):
        if name == "gop-size":
            return self.scenedetector.get_property("gop-size")
        if name.startswith(ENC_PREFIX):
            return self.get_by_name(name)
        return None

    # -- topology ----------------------------------------------------------
    def _create_pipeline(self) -> bool:
        if self._links_built:
            return True
        self._links_built = True
        intersected = Caps.any()
        for i in range(NUM_ENC):
            enc = self.get_by_name(f"{ENC_PREFIX}{i}")
            if enc is None:
                continue
            src_pad = self.outputselector.request_pad("src_%u")
            src_pad.link(enc.static_sink_pad)
            sink_pad = self.scenecollector.request_pad("sink_%u")
            enc.static_src_pad.link(sink_pad)
            enc_caps = enc.static_src_pad.template_caps
            inter = intersected.intersect(enc_caps)
            if inter is None:
                return False
            intersected = inter
        self.capsfilter.set_property("caps", intersected)
        return True

    def change_state(self, transition: StateChange) -> StateChangeReturn:
        if transition == StateChange.NULL_TO_READY:
            if not self._create_pipeline():
                return StateChangeReturn.FAILURE
        return super().change_state(transition)

    # -- ChildProxy analog -------------------------------------------------
    def child_by_index(self, index: int) -> Optional[Element]:
        fixed = [self.scenedetector, self.outputselector,
                 self.scenecollector, self.capsfilter]
        if index < len(fixed):
            return fixed[index]
        return self.get_by_name(f"{ENC_PREFIX}{index}")

    def children_count(self) -> int:
        return len(self.children)

    def child_by_name(self, name: str) -> Optional[Element]:
        return self.get_by_name(name)
