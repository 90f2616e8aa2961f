"""avimux / avidemux — MJPEG in a standard AVI container (a copy of
flutpu/codec/avimux.py, held to it by tests/test_torch_avimux.py;
flutpu's package imports jax, so the port carries its own).

Minimal RIFF/AVI writer (MJPG fourcc) so cudajpegenc output plays in
stock players (ffplay/VLC/browsers understand MJPEG-in-AVI). Frames
buffer until EOS (the index must know every chunk), then one finalized
AVI buffer is emitted; use filesink downstream. ``avidemux`` splits such
a stream back into one image/jpeg buffer per frame as the bytes arrive.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, Optional

from ..core import (Buffer, Caps, Element, Event, EventType, FlowReturn,
                    Pad, PadDirection, register)


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, payload: bytes) -> bytes:
    body = kind + payload
    pad = b"\x00" if len(body) & 1 else b""
    return b"LIST" + struct.pack("<I", len(body)) + body + pad


def build_avi(frames: List[bytes], width: int, height: int,
              fps: Fraction) -> bytes:
    n = len(frames)
    usec_per_frame = int(1_000_000 * fps.denominator / max(1, fps.numerator)) \
        if fps and fps.numerator else 33333
    max_size = max((len(f) for f in frames), default=0)

    avih = struct.pack(
        "<14I", usec_per_frame, 0,
        0, 0x10,  # flags: AVIF_HASINDEX
        n, 0, 1, max_size, width, height, 0, 0, 0, 0)

    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0,
        fps.denominator or 1, fps.numerator or 30, 0, n, max_size, 0xFFFFFFFF,
        0, 0, 0, int(width), int(height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)

    movi_body = b"".join(_chunk(b"00dc", f) for f in frames)
    movi = _list(b"movi", movi_body)

    # idx1: offsets relative to the start of the movi list's 'movi' tag + 4
    idx_entries = []
    off = 4
    for f in frames:
        idx_entries.append(struct.pack("<4sIII", b"00dc", 0x10, off, len(f)))
        off += 8 + len(f) + (len(f) & 1)
    idx1 = _chunk(b"idx1", b"".join(idx_entries))

    riff_body = b"AVI " + hdrl + movi + idx1
    return b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body


@register
class AviMux(Element):
    """Muxes an MJPEG (image/jpeg) stream into one AVI file buffer at EOS."""

    FACTORY = "avimux"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("image/jpeg")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._frames: List[bytes] = []
        self._caps: Optional[Caps] = None
        self._first_pts: Optional[int] = None

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._frames.append(bytes(buf.data))
        if self._first_pts is None:
            self._first_pts = buf.pts
        return FlowReturn.OK

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            self._caps = event.caps
            return True
        if event.type == EventType.FLUSH_STOP:
            # discard the flushed segment's frames — they must not be
            # muxed into the post-flush file
            self._frames = []
            self._first_pts = None
            return self.srcpad.push_event(event)
        if event.type == EventType.EOS:
            caps = self._caps or Caps.new("image/jpeg")
            fps = caps.get("framerate") or Fraction(30, 1)
            data = build_avi(self._frames,
                             int(caps.get("width") or 0),
                             int(caps.get("height") or 0), fps)
            from ..core import CapsEvent
            self.srcpad.push_event(CapsEvent(Caps.new("video/x-msvideo")))
            self.srcpad.push(Buffer(data, pts=self._first_pts or 0))
            self._frames = []
            self._first_pts = None
            return self.srcpad.push_event(event)
        return self.srcpad.push_event(event)


def _dc_stream_no(fourcc: bytes) -> Optional[int]:
    """Stream number of an ##dc data chunk, or None if not one."""
    if fourcc[2:4] != b"dc" or not fourcc[:2].isdigit():
        return None
    return int(fourcc[:2])


def parse_avi(data: bytes):
    """Minimal RIFF/AVI reader: returns a dict with ``frames`` (the
    first VIDEO stream's data chunks, in movi order), ``width``,
    ``height`` and ``fps``, or None for non-AVI data. Tolerates missing
    idx1. Stream-aware: strh/strf pairs are associated in order, so an
    audio-first AVI doesn't poison width/height and a second stream's
    ##dc chunks aren't interleaved into the video frames."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        return None
    width = height = 0
    rate, scale = 30, 1
    frames: List[bytes] = []
    strh_seen = 0
    last_strh_vids = False
    vids_stream: Optional[int] = None

    def walk(buf: bytes, pos: int, end: int):
        nonlocal width, height, rate, scale
        nonlocal strh_seen, last_strh_vids, vids_stream
        end = min(end, len(buf))  # declared sizes are untrusted: a RIFF
        #                           header claiming more bytes than exist
        #                           must not walk past the buffer
        while pos + 8 <= end:
            fourcc = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            body_start = pos + 8
            body_end = min(body_start + size, end)
            avail = body_end - body_start  # may be < declared size
            if fourcc == b"LIST":
                walk(buf, body_start + 4, body_end)
            elif fourcc == b"strh" and avail >= 40:
                typ = buf[body_start:body_start + 4]
                last_strh_vids = typ == b"vids"
                if last_strh_vids and vids_stream is None:
                    vids_stream = strh_seen
                    scale, rate = struct.unpack(
                        "<II", buf[body_start + 20:body_start + 28])
                strh_seen += 1
            elif fourcc == b"strf" and avail >= 16 and last_strh_vids \
                    and not width:
                width, height = struct.unpack(
                    "<ii", buf[body_start + 4:body_start + 12])
            else:
                sno = _dc_stream_no(fourcc)
                if sno is not None and (vids_stream is None
                                        or sno == vids_stream):
                    frames.append(buf[body_start:body_end])
            pos = body_end + (size & 1)

    walk(data, 12, 8 + struct.unpack("<I", data[4:8])[0])
    fps = Fraction(rate or 30, scale or 1)
    return {"frames": frames, "width": width, "height": abs(height),
            "fps": fps}


@register
class AviDemux(Element):
    """avidemux — splits an MJPEG AVI stream back into one image/jpeg
    buffer per frame (the inverse of avimux). Streaming: frames are
    emitted as soon as their movi chunk is fully buffered — no need to
    wait for EOS or the idx1 index (works on live/partial files)."""

    FACTORY = "avidemux"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-msvideo")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._reset()

    def _reset(self) -> None:
        self._buf = bytearray()
        self._pos = 0            # parse offset into _buf
        self._started = False    # RIFF header consumed
        self._stack: List[int] = []   # LIST end offsets we are inside
        self._hdr = {"width": 0, "height": 0, "fps": Fraction(30, 1)}
        self._caps_sent = False
        self._frame_idx = 0
        self._bad = False
        self._strh_seen = 0              # stream association (strh order)
        self._last_strh_vids = False
        self._vids_stream: Optional[int] = None

    def _emit_caps(self) -> None:
        if self._caps_sent:
            return
        from ..core import CapsEvent
        self.srcpad.push_event(CapsEvent(Caps.new(
            "image/jpeg", parsed=True, width=self._hdr["width"],
            height=self._hdr["height"], framerate=self._hdr["fps"])))
        self._caps_sent = True

    def _frame_dur(self) -> int:
        fps = self._hdr["fps"]
        return int(1_000_000_000 * fps.denominator / max(1, fps.numerator))

    def _parse(self) -> None:
        """Advance through buffered bytes, emitting complete frames."""
        buf = self._buf
        if self._bad:
            return
        if not self._started:
            if len(buf) < 12:
                return
            if bytes(buf[:4]) != b"RIFF" or bytes(buf[8:12]) != b"AVI ":
                self._bad = True
                return
            self._pos = 12
            self._started = True
        while True:
            # leave finished LISTs
            while self._stack and self._pos >= self._stack[-1]:
                self._stack.pop()
            if len(buf) - self._pos < 8:
                return
            fourcc = bytes(buf[self._pos:self._pos + 4])
            size = struct.unpack("<I", buf[self._pos + 4:self._pos + 8])[0]
            # corrupt-stream guards: a fourcc must be printable ASCII and
            # a declared size plausible — otherwise _parse would wait
            # forever for bytes that never come while _buf grows
            # unboundedly. LISTs are EXEMPT from the size bound: they are
            # descended into immediately (never buffered whole), and a
            # long recording's movi LIST legitimately exceeds any bound
            # (256 MB ≈ 90 s of 1080p30 MJPEG)
            if (size > (1 << 28) and fourcc != b"LIST") or \
                    not all(0x20 <= c < 0x7F for c in fourcc):
                self._bad = True
                return
            body = self._pos + 8
            if fourcc == b"LIST":
                if len(buf) - body < 4:
                    return
                # RIFF pads odd-sized chunks with one byte — LISTs included
                self._stack.append(body + size + (size & 1))
                self._pos = body + 4  # descend past the list kind
                continue
            end = body + size + (size & 1)
            if fourcc in (b"strh", b"strf"):
                if len(buf) < end:
                    return
                payload = bytes(buf[body:body + size])
                if fourcc == b"strh" and size >= 4:
                    # associate the following strf with THIS stream: an
                    # audio-first AVI must not poison width/height
                    self._last_strh_vids = payload[:4] == b"vids"
                    if self._last_strh_vids and size >= 28 and \
                            self._vids_stream is None:
                        self._vids_stream = self._strh_seen
                        scale, rate = struct.unpack("<II", payload[20:28])
                        self._hdr["fps"] = Fraction(rate or 30, scale or 1)
                    self._strh_seen += 1
                elif fourcc == b"strf" and size >= 12 and \
                        self._last_strh_vids and not self._hdr["width"]:
                    w, h = struct.unpack("<ii", payload[4:12])
                    self._hdr["width"], self._hdr["height"] = w, abs(h)
            elif _dc_stream_no(fourcc) is not None:
                if len(buf) < end:
                    return  # frame not fully buffered yet
                sno = _dc_stream_no(fourcc)
                if self._vids_stream is None or sno == self._vids_stream:
                    self._emit_caps()
                    dur = self._frame_dur()
                    self.srcpad.push(Buffer(bytes(buf[body:body + size]),
                                            pts=self._frame_idx * dur,
                                            duration=dur,
                                            offset=self._frame_idx))
                    self._frame_idx += 1
            elif len(buf) < end:
                return  # skipped chunk (avih, idx1, ...) still arriving
            self._pos = end

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._buf += bytes(buf.data)
        self._parse()
        # bound memory on long streams: drop fully consumed bytes
        if self._pos > (1 << 20):
            shift = self._pos
            del self._buf[:shift]
            self._pos = 0
            self._stack = [e - shift for e in self._stack]
        return FlowReturn.OK

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            self._parse()
            return self.srcpad.push_event(event)
        if event.type == EventType.FLUSH_STOP:
            # full reset INCLUDING header/caps state: a post-flush stream
            # may be a different file (new geometry/fps) and must
            # renegotiate rather than keep the previous stream's caps
            self._reset()
            return self.srcpad.push_event(event)
        if event.type == EventType.CAPS:
            return True
        return self.srcpad.push_event(event)
