"""VideoEncoder base — the encoder element contract.

Copy of flutpu/codec/base.py (that package imports jax), on the port's
copy of the dataflow core, without WARM_DEVICE: the port runs no jax,
so there is no backend to arm.

The reference delegates encoding to off-the-shelf GStreamer encoders and only
type-checks them (hype/src/hype/imp.rs:139-152: must be a VIDEO_ENCODER
factory, or ``identity``). Here the framework owns its encoders: subclasses
implement ``encode_frame`` (and usually batch whole GOPs to the device).

Contract pieces the hype bin relies on:
- static ``sink``/``src`` pads with declared template caps (the bin
  intersects all encoder src template caps into its capsfilter)
- ForceKeyUnit handling: the next output unit is a sync point
  (DELTA_UNIT flag cleared), making chunk boundaries independently decodable
"""

from __future__ import annotations

from typing import Optional

from ..core import (Buffer, BufferFlags, Caps, Element, Event, EventType,
                    FlowReturn, Pad, PadDirection)


class VideoEncoder(Element):
    """Base class for video encoder elements."""

    SINK_CAPS = "video/x-raw"
    SRC_CAPS = ""  # subclasses must declare their bitstream caps

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        sink_caps = Caps.from_string(self.SINK_CAPS) if self.SINK_CAPS else Caps.any()
        src_caps = Caps.from_string(self.SRC_CAPS) if self.SRC_CAPS else Caps.any()
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK, self, template_caps=sink_caps))
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC, self, template_caps=src_caps))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._force_key_unit = True  # first frame is always a sync point
        self.input_caps: Optional[Caps] = None

    # -- subclass hooks ------------------------------------------------------
    def set_format(self, caps: Caps) -> Optional[Caps]:
        """Input caps negotiated; return the output caps (or None to defer)."""
        return None

    def encode_frame(self, buf: Buffer, keyframe: bool) -> Optional[Buffer]:
        """Encode one frame; return the bitstream buffer (or None to buffer
        internally — flush on EOS via ``finish()``)."""
        raise NotImplementedError

    def finish(self):
        """Drain internal state at EOS; yield remaining output buffers."""
        return []

    def drain(self) -> None:
        """Flush any internally batched frames downstream NOW. Called before
        a serialized custom event (chunk boundary) or EOS is forwarded, so
        held output cannot be reordered past the event — the hype collector
        attributes buffers to scenes by arrival order relative to scene
        events (reference scenecollector contract)."""

    def on_custom_event(self, event: Event) -> None:
        """Hook: observe custom downstream events (e.g. hype scene-new)."""

    def reset(self) -> None:
        """Drop internally batched state on a flushing seek. Subclasses
        holding pending frames must clear them here — stale pre-seek frames
        must never leak into post-seek chunks."""

    # -- plumbing ------------------------------------------------------------
    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        keyframe = self._force_key_unit
        self._force_key_unit = False
        out = self.encode_frame(buf, keyframe)
        if out is None:
            return FlowReturn.OK
        if keyframe:
            out.unset_flag(BufferFlags.DELTA_UNIT)
        return self.srcpad.push(out)

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.name == "GstForceKeyUnit":
            self._force_key_unit = True
            return True
        if event.type == EventType.CUSTOM_DOWNSTREAM:
            self.drain()  # chunk boundary: held frames must precede the event
            self.on_custom_event(event)
            return self.srcpad.push_event(event)
        if event.type == EventType.CAPS:
            if self.input_caps is not None and event.caps != self.input_caps:
                self.drain()  # geometry change: close the open batch first
                self._force_key_unit = True  # new format starts on a sync
            self.input_caps = event.caps
            out_caps = self.set_format(event.caps)
            if out_caps is not None:
                from ..core import CapsEvent
                return self.srcpad.push_event(CapsEvent(out_caps))
            return self.srcpad.push_event(event)
        if event.type == EventType.EOS:
            for out in self.finish():
                self.srcpad.push(out)
            return self.srcpad.push_event(event)
        if event.type == EventType.FLUSH_STOP:
            self.reset()
            self._force_key_unit = True  # post-seek stream starts on a sync
            return self.srcpad.push_event(event)
        return self.srcpad.push_event(event)
