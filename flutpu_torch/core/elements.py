"""Built-in utility elements: identity, capsfilter, fakesink, appsink,
videotestsrc, filesrc, appsrc.

These are the framework's stock elements, mirroring the GStreamer core
elements the reference's tests and pipelines rely on (``identity
sleep-time=10000`` as a fake encoder in hype/tests/tests.rs, ``capsfilter``
inside the hype bin, ``fakesink``/``filesrc`` in README pipelines).
"""

from __future__ import annotations

import queue as _pyqueue
import threading
import time
from fractions import Fraction
from typing import Any, List, Optional

import numpy as np

from .buffer import Buffer, BufferList, MSECOND, SECOND
from .caps import Caps, ValueList
from .element import Element, PropertySpec, State, StateChange, StateChangeReturn
from .events import (CapsEvent, EosEvent, Event, EventType, Segment,
                     SegmentEvent, StreamStartEvent)
from .pad import FlowReturn, Pad, PadDirection
from .registry import register


@register
class Identity(Element):
    """Pass-through with optional per-buffer sleep — the latency-skew tool
    the reference tests use to stress ordered reassembly
    (hype/tests/tests.rs: ``identity sleep-time=10000``, microseconds)."""

    FACTORY = "identity"
    PROPERTIES = [
        PropertySpec("sleep-time", 0, "microseconds to sleep per buffer"),
        PropertySpec("silent", True),
        PropertySpec("handoff", None, "callable(element, buffer) per buffer"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        st = self.get_property("sleep-time") or 0
        if st:
            time.sleep(st / 1e6)
        handoff = self.get_property("handoff")
        if handoff is not None:
            handoff(self, buf)
        return self.srcpad.push(buf)


@register
class CapsFilter(Element):
    """Restricts flowing caps to the ``caps`` property; fails negotiation on
    incompatible upstream caps. Reference analog: capsfilter after the hype
    scenecollector intersecting encoder src caps (hype/src/hype/imp.rs:44-63)."""

    FACTORY = "capsfilter"
    PROPERTIES = [PropertySpec("caps", None, ptype=object)]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = lambda p, b: self.srcpad.push(b)
        self.sinkpad.event_function = self._sink_event
        self.sinkpad.query_caps_function = self._query_caps
        self.srcpad.query_caps_function = self._query_caps

    def _filter_caps(self) -> Caps:
        caps = self.get_property("caps")
        if caps is None:
            return Caps.any()
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        return caps

    def _query_caps(self, pad: Pad) -> Caps:
        return self._filter_caps()

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            inter = event.caps.intersect(self._filter_caps())
            if inter is None:
                return False
            return self.srcpad.push_event(CapsEvent(inter))
        return self.srcpad.push_event(event)


@register
class FakeSink(Element):
    """Swallows data; records counts; optional handoff callback."""

    FACTORY = "fakesink"
    PROPERTIES = [
        PropertySpec("handoff", None, "callable(element, buffer)"),
        PropertySpec("num-buffers-received", 0),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self.eos_received = threading.Event()

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._props["num-buffers-received"] += 1
        handoff = self.get_property("handoff")
        if handoff is not None:
            handoff(self, buf)
        return FlowReturn.OK

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            self.eos_received.set()
            from .bus import Message, MessageType
            self.post_message(Message(MessageType.EOS, self))
        return True


@register
class AppSink(Element):
    """Pull-style sink: application pops buffers/events from a queue."""

    FACTORY = "appsink"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.chain_list_function = self._chain_list
        self.sinkpad.event_function = self._event
        self.samples: "_pyqueue.Queue[Any]" = _pyqueue.Queue()

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self.samples.put(buf)
        return FlowReturn.OK

    def _chain_list(self, pad: Pad, buffers: BufferList) -> FlowReturn:
        for b in buffers:
            self.samples.put(b)
        return FlowReturn.OK

    def _event(self, pad: Pad, event: Event) -> bool:
        self.samples.put(event)
        return True

    def try_pull_buffer(self, timeout: Optional[float] = None) -> Optional[Buffer]:
        import time as _t
        deadline = None if timeout is None else _t.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - _t.monotonic())
            try:
                item = self.samples.get(timeout=remaining)
            except _pyqueue.Empty:
                return None
            if isinstance(item, Buffer):
                return item
            if isinstance(item, Event) and item.type == EventType.EOS:
                return None

    def interrupt(self) -> None:
        """End the pull as EOS would: a waiting ``try_pull_buffer`` returns
        None (for an application that saw an error, after which no EOS
        comes)."""
        self.samples.put(EosEvent())


@register
class AppSrc(Element):
    """Push-style source driven by the application thread."""

    FACTORY = "appsrc"
    PROPERTIES = [PropertySpec("caps", None, ptype=object)]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self._started = False

    def _ensure_stream_start(self):
        if not self._started:
            self._started = True
            self.srcpad.push_event(StreamStartEvent(f"{self.name}-stream"))
            caps = self.get_property("caps")
            if caps is not None:
                if isinstance(caps, str):
                    caps = Caps.from_string(caps)
                self.srcpad.push_event(CapsEvent(caps))
            self.srcpad.push_event(SegmentEvent(Segment()))

    def push(self, buf: Buffer) -> FlowReturn:
        self._ensure_stream_start()
        return self.srcpad.push(buf)

    def end_of_stream(self) -> bool:
        self._ensure_stream_start()
        return self.srcpad.push_event(EosEvent())


@register
class VideoTestSrc(Element):
    """Synthetic raw-video source. Patterns: solid, gradient, smpte-ish bars,
    ball (moving dot), noise. Pushes ``num-buffers`` frames on
    PAUSED→PLAYING from its own streaming thread."""

    FACTORY = "videotestsrc"
    PROPERTIES = [
        PropertySpec("num-buffers", 30),
        PropertySpec("pattern", "smpte"),
        PropertySpec("width", 320),
        PropertySpec("height", 240),
        PropertySpec("framerate", Fraction(30, 1), ptype=object),
        PropertySpec("format", "RGB"),
        PropertySpec("is-live", False),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def make_frame(self, i: int) -> np.ndarray:
        w = int(self.get_property("width"))
        h = int(self.get_property("height"))
        pattern = self.get_property("pattern")
        nch = 3 if self.get_property("format") in ("RGB", "BGR") else 4
        return make_test_frame(pattern, w, h, i, nch)

    def _task(self):
        n = int(self.get_property("num-buffers"))
        w = int(self.get_property("width"))
        h = int(self.get_property("height"))
        fps = self.get_property("framerate")
        fmt = self.get_property("format")
        caps = Caps.new("video/x-raw", format=fmt, width=w, height=h,
                        framerate=fps)
        self.srcpad.push_event(StreamStartEvent(f"{self.name}-stream"))
        self.srcpad.push_event(CapsEvent(caps))
        self.srcpad.push_event(SegmentEvent(Segment()))
        frame_dur = int(SECOND / fps)
        is_live = bool(self.get_property("is-live"))
        for i in range(n):
            if self._stop.is_set():
                return
            buf = Buffer(self.make_frame(i), pts=i * frame_dur,
                         duration=frame_dur, offset=i)
            ret = self.srcpad.push(buf)
            if ret != FlowReturn.OK:
                return
            if is_live:
                time.sleep(frame_dur / SECOND)
        self.srcpad.push_event(EosEvent())

    def change_state(self, transition: StateChange) -> StateChangeReturn:
        if transition == StateChange.PAUSED_TO_PLAYING:
            self._stop.clear()
            self._thread = threading.Thread(target=self._task,
                                            name=f"{self.name}-src", daemon=True)
            self._thread.start()
        elif transition == StateChange.PLAYING_TO_PAUSED:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=10)
                self._thread = None
        return super().change_state(transition)


def make_test_frame(pattern: str, w: int, h: int, i: int, nch: int = 3) -> np.ndarray:
    """Deterministic test frame generator shared by videotestsrc and benches."""
    yy, xx = np.mgrid[0:h, 0:w]
    if pattern == "solid":
        frame = np.full((h, w, nch), (i * 7) % 256, dtype=np.uint8)
    elif pattern == "gradient":
        frame = np.zeros((h, w, nch), dtype=np.uint8)
        frame[..., 0] = ((xx * 255) // max(w - 1, 1)).astype(np.uint8)
        frame[..., 1] = ((yy * 255) // max(h - 1, 1)).astype(np.uint8)
        frame[..., 2] = (i * 5) % 256
    elif pattern == "ball":
        frame = np.zeros((h, w, nch), dtype=np.uint8)
        cx = int((0.5 + 0.4 * np.sin(i * 0.2)) * w)
        cy = int((0.5 + 0.4 * np.cos(i * 0.23)) * h)
        r = max(4, min(w, h) // 10)
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        frame[mask] = 255
    elif pattern == "noise":
        rng = np.random.default_rng(i)
        frame = rng.integers(0, 256, size=(h, w, nch), dtype=np.uint8).astype(np.uint8)
    else:  # smpte-ish vertical color bars
        bars = np.array([
            [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
            [191, 0, 191], [191, 0, 0], [0, 0, 191], [0, 0, 0],
        ], dtype=np.uint8)
        idx = (xx * len(bars)) // max(w, 1)
        frame3 = bars[np.clip(idx, 0, len(bars) - 1)]
        if nch == 3:
            frame = frame3
        else:
            frame = np.concatenate(
                [frame3, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    if frame.shape[-1] != nch:
        if frame.shape[-1] < nch:
            pad = np.full((h, w, nch - frame.shape[-1]), 255, np.uint8)
            frame = np.concatenate([frame, pad], axis=-1)
        else:
            frame = frame[..., :nch]
    return np.ascontiguousarray(frame)


@register
class FileSrc(Element):
    """Reads a file and pushes it as buffers of ``blocksize`` bytes on
    PAUSED→PLAYING. Supports byte-seek restart (the TTML base translates time
    seeks into byte-0 seeks upstream, reference gstttmlbase.c:1347-1373)."""

    FACTORY = "filesrc"
    PROPERTIES = [
        PropertySpec("location", ""),
        PropertySpec("blocksize", 64 * 1024),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.srcpad.event_function = self._src_event
        self._thread: Optional[threading.Thread] = None
        self._restart = threading.Event()
        self._stop = threading.Event()

    def _src_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.SEEK:
            self._flush_on_restart = bool(event.structure.get("flush", True))
            self._restart.set()
            return True
        return False

    def _task(self):
        while not self._stop.is_set():
            if self._restart.is_set() and getattr(self, "_flush_on_restart", False):
                # flushing seek: reset downstream before restarting
                from .events import FlushStartEvent, FlushStopEvent
                self.srcpad.push_event(FlushStartEvent())
                self.srcpad.push_event(FlushStopEvent())
            self._restart.clear()
            path = self.get_property("location")
            bs = int(self.get_property("blocksize"))
            self.srcpad.push_event(StreamStartEvent(f"{self.name}-stream"))
            seg = Segment(format="bytes")
            self.srcpad.push_event(SegmentEvent(seg))
            offset = 0
            with open(path, "rb") as f:
                while not self._stop.is_set() and not self._restart.is_set():
                    data = f.read(bs)
                    if not data:
                        break
                    buf = Buffer(data, offset=offset)
                    offset += len(data)
                    if self.srcpad.push(buf) != FlowReturn.OK:
                        return
            if not self._restart.is_set():
                self.srcpad.push_event(EosEvent())
                # stay alive: a later seek restarts the stream
                while not self._stop.is_set() and not self._restart.is_set():
                    self._restart.wait(timeout=0.1)

    def change_state(self, transition: StateChange) -> StateChangeReturn:
        if transition == StateChange.PAUSED_TO_PLAYING:
            self._stop.clear()
            self._thread = threading.Thread(target=self._task,
                                            name=f"{self.name}-src", daemon=True)
            self._thread.start()
        elif transition == StateChange.PLAYING_TO_PAUSED:
            self._stop.set()
            self._restart.set()
            if self._thread is not None:
                self._thread.join(timeout=10)
                self._thread = None
        return super().change_state(transition)


@register
class FileSink(Element):
    """Writes buffer payloads to ``location``."""

    FACTORY = "filesink"
    PROPERTIES = [PropertySpec("location", "")]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._fh = None
        self.eos_received = threading.Event()

    def _ensure_open(self):
        if self._fh is None:
            self._fh = open(self.get_property("location"), "wb")
        return self._fh

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = buf.data
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        elif isinstance(data, str):
            data = data.encode("utf-8")
        self._ensure_open().write(bytes(data))
        return FlowReturn.OK

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            if self._fh is not None:
                self._fh.flush()
            self.eos_received.set()
            from .bus import Message, MessageType
            self.post_message(Message(MessageType.EOS, self))
        return True

    def change_state(self, transition: StateChange) -> StateChangeReturn:
        if transition == StateChange.PAUSED_TO_READY and self._fh is not None:
            self._fh.close()
            self._fh = None
        return super().change_state(transition)


@register
class FdSink(Element):
    """Collects payload bytes; ``get_data()`` returns the concatenation
    (stand-in for the reference README's ``fdsink`` inspection pipelines)."""

    FACTORY = "fdsink"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.sinkpad.chain_function = self._chain
        self._chunks: List[bytes] = []
        self.eos_received = threading.Event()
        self.sinkpad.event_function = self._event

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = buf.data
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        elif isinstance(data, str):
            data = data.encode("utf-8")
        self._chunks.append(bytes(data))
        return FlowReturn.OK

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            self.eos_received.set()
        return True

    def get_data(self) -> bytes:
        return b"".join(self._chunks)


@register
class VideoConvert(Element):
    """Raw-video format conversion (RGB / BGR / BGRA / RGBA / I420) — the
    pipeline glue the reference's README examples use (videoconvert).
    Negotiates against the downstream format; planar I420 payloads travel
    as dict buffers {"y","u","v"}."""

    FACTORY = "videoconvert"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-raw")))
        self.srcpad = self.add_pad(Pad(
            "src", PadDirection.SRC, self,
            template_caps=Caps.from_string("video/x-raw")))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._in_format = "RGB"
        self._out_format = None

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            caps = event.caps
            self._in_format = caps.get("format", "RGB")
            peer = self.srcpad.peer_query_caps()
            out_fmt = peer.get("format")
            if isinstance(out_fmt, ValueList):
                out_fmt = out_fmt.values[0]
            self._out_format = out_fmt or self._in_format
            out_caps = caps.with_fields(format=self._out_format)
            return self.srcpad.push_event(CapsEvent(out_caps))
        return self.srcpad.push_event(event)

    @staticmethod
    def _to_rgb(data: np.ndarray, fmt: str) -> np.ndarray:
        if fmt == "RGB":
            return data
        if fmt == "BGR":
            return data[..., ::-1]
        if fmt == "RGBA":
            return data[..., :3]
        if fmt == "BGRA":
            return data[..., [2, 1, 0]]
        raise ValueError(f"unsupported input format {fmt}")

    @staticmethod
    def _from_rgb(rgb: np.ndarray, fmt: str) -> np.ndarray:
        h, w = rgb.shape[:2]
        if fmt == "RGB":
            return rgb
        if fmt == "BGR":
            return np.ascontiguousarray(rgb[..., ::-1])
        if fmt in ("RGBA", "BGRA"):
            alpha = np.full((h, w, 1), 255, np.uint8)
            rgbx = rgb if fmt == "RGBA" else rgb[..., [2, 1, 0]]
            return np.concatenate([rgbx, alpha], axis=-1)
        if fmt == "I420":
            import torch
            from ..codec.ops.colorspace import rgb_to_i420
            y, cb, cr = rgb_to_i420(torch.from_numpy(rgb.astype(np.float32)))
            clip = lambda p: np.clip(p.numpy() + 0.5, 0, 255).astype(np.uint8)
            return {"y": clip(y), "u": clip(cb), "v": clip(cr)}
        raise ValueError(f"unsupported output format {fmt}")

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        fmt_in = self._in_format
        fmt_out = self._out_format or fmt_in
        if fmt_in == fmt_out:
            return self.srcpad.push(buf)
        data = buf.data
        if fmt_in == "I420" and isinstance(data, dict):
            import torch
            from ..codec.ops.colorspace import i420_to_rgb
            rgb = np.clip(i420_to_rgb(*(
                torch.from_numpy(np.asarray(data[k], np.float32))
                for k in ("y", "u", "v"))).numpy() + 0.5, 0, 255
            ).astype(np.uint8)
        else:
            rgb = self._to_rgb(np.asarray(data), fmt_in)
        out = buf.copy()
        out.data = self._from_rgb(np.ascontiguousarray(rgb), fmt_out)
        return self.srcpad.push(out)
