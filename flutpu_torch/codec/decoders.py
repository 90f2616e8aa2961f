"""Decoder elements on a CUDA device: ``cudajpegdec`` and ``cudafvcdec``
(port of flutpu/codec/decoders.py: ``jpegdec`` and ``fvcdec``).

Host entropy decode (the native ``flu_jpeg_decode_scan``), then the
reconstruction in plain PyTorch on the element's ``device`` (flutpu's
XLA programs: de-zigzag, dequantize, IDCT, upsample, RGB; for FVC the
in-loop reconstruction with motion compensation), one raw RGB frame out
per coded frame, in host memory. ``cudajpegdec`` reads the baseline JFIF
subset the encoders write (4:2:0 and 4:4:4, the standard Annex-K
Huffman tables); ``cudafvcdec`` reads FVC chunks, one per buffer or as a
byte stream in blocks of any size. With the encoders they make
decode → process → encode pipelines (BASELINE config 2's decode →
overlay shape). A corrupt input returns ``FlowReturn.ERROR``.
"""

from __future__ import annotations

import struct
from fractions import Fraction

import numpy as np
import torch

from ..core import (Buffer, Caps, CapsEvent, Element, Event, EventType,
                    FlowReturn, Pad, PadDirection, PropertySpec, register)
from .decode import coefs_to_rgb, decode_scan_to_coefs, parse_jfif
from .fvc import MAGIC, FvcDecoder
from .jpeg import _pad_to
from .ops.quant import CHROMA_QTABLE, LUMA_QTABLE, scale_qtable

_DEVICE = PropertySpec("device", "cuda", "torch device of the "
                       "reconstruction (cuda, cuda:N, or cpu for the same "
                       "PyTorch code there)")


def _geometry(caps):
    """(width, height) of ``caps``, or None where either is missing."""
    if caps is None:
        return None
    w, h = caps.get("width"), caps.get("height")
    if not w or not h:
        return None
    return int(w), int(h)


@register
class CudaJpegDec(Element):
    """Decodes the baseline JFIF subset back to raw RGB frames."""

    FACTORY = "cudajpegdec"
    PROPERTIES = [_DEVICE]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("image/jpeg")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._caps_sent = False

    def _device(self) -> torch.device:
        return torch.device(str(self.get_property("device")))

    def prewarm(self, caps=None) -> bool:
        """Reconstruct one zero frame at ``caps``' geometry on the
        element's device, so that an injectbin swap finds the device
        context and the reconstruction's kernels loaded. False without a
        width and height."""
        size = _geometry(caps)
        if size is None:
            return False
        w, h = size
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        dev = self._device()
        y = torch.zeros((ph // 8, pw // 8, 64), dtype=torch.int16, device=dev)
        c = torch.zeros((ph // 16, pw // 16, 64), dtype=torch.int16,
                        device=dev)
        q = torch.as_tensor(scale_qtable(LUMA_QTABLE, 85), device=dev)
        coefs_to_rgb(y, c, c, q, q, h, w).cpu()
        return True

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            return True  # output caps derive from the bitstream
        return self.srcpad.push_event(event)

    def decode(self, data: bytes):
        """One JFIF image → (H, W, 3) uint8 RGB in host memory, or None
        for data that is not a decodable image of the subset."""
        info = parse_jfif(data)
        if info is None or not info["h"] or not info["w"] \
                or 0 not in info["qtables"]:
            return None
        h, w, sub = info["h"], info["w"], info["subsample"]
        mult = 16 if sub else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        ybw, ybh = pw // 8, ph // 8
        cbw, cbh = (pw // 16, ph // 16) if sub else (ybw, ybh)
        coefs = decode_scan_to_coefs(info["scan"], ybw, ybh, cbw, cbh, sub)
        if coefs is None:
            return None
        dev = self._device()
        tabs = info["qtables"]
        qy = torch.as_tensor(tabs[0], device=dev)
        qc = torch.as_tensor(tabs.get(1, tabs[0]), device=dev)
        y, cb, cr = (torch.from_numpy(c).to(dev) for c in coefs)
        return coefs_to_rgb(y, cb, cr, qy, qc, h, w, subsample=sub) \
            .cpu().numpy()

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        rgb = self.decode(bytes(buf.data))
        if rgb is None:
            return FlowReturn.ERROR
        if not self._caps_sent:
            self._caps_sent = True
            self.srcpad.push_event(CapsEvent(Caps.new(
                "video/x-raw", format="RGB", width=rgb.shape[1],
                height=rgb.shape[0])))
        out = Buffer(rgb, pts=buf.pts, dts=buf.dts, duration=buf.duration,
                     offset=buf.offset)
        return self.srcpad.push(out)


@register
class CudaFvcDec(Element):
    """Decodes FVC chunks to raw RGB frames (one buffer per coded
    frame)."""

    FACTORY = "cudafvcdec"
    PROPERTIES = [_DEVICE]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-fvc")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._decoder = None
        self._caps_sent = False
        self._tail = b""  # partial chunk bytes (byte-stream inputs)
        self._frame_count = 0

    def do_set_property(self, name, value):
        if name == "device":
            self._decoder = None

    def _dec(self) -> FvcDecoder:
        if self._decoder is None:
            self._decoder = FvcDecoder(str(self.get_property("device")))
        return self._decoder

    def prewarm(self, caps=None) -> bool:
        """Run the in-loop reconstruction of a two-frame chunk (an I and a
        P frame) at ``caps``' geometry on the element's device. False
        without a width and height."""
        size = _geometry(caps)
        if size is None:
            return False
        w, h = size
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        dev = self._dec().device
        q = torch.as_tensor(scale_qtable(CHROMA_QTABLE, 85), device=dev)
        y = torch.zeros((2, ph // 8, pw // 8, 64), dtype=torch.int16,
                        device=dev)
        c = torch.zeros((2, ph // 16, pw // 16, 64), dtype=torch.int16,
                        device=dev)
        mvs = [None, np.zeros((ph // 16, pw // 16, 2), np.int8)]
        FvcDecoder._reconstruct_mc(y, c, c, mvs, q, q, planar=False)[0].cpu()
        return True

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            return True
        if event.type == EventType.FLUSH_STOP:
            self._tail = b""
        return self.srcpad.push_event(event)

    def _take_complete_chunk(self, data: bytes):
        """(chunk, remainder) if a full chunk is buffered, else (None,
        data). Mirrors FvcDecoder.split_stream but tolerates truncation
        (a streaming source delivers arbitrary byte blocks)."""
        if len(data) < 12:
            return None, data
        if data[:4] != MAGIC:
            raise ValueError("bad FVC chunk boundary")
        ver, cflags, _, _, _, f = struct.unpack(">BBHHBB", data[4:12])
        end = 13 if ver >= 2 else 12
        if cflags & 16:
            end += 4  # explicit coded-size extension
        if cflags & 32:
            end += 1  # B-frame bquality extension
        hdr = 7 if ver >= 2 else 5
        for _i in range(f):
            if len(data) - end < hdr:
                return None, data
            if ver >= 2:
                _, mv_len, plen = struct.unpack(">BHI", data[end:end + 7])
                end += 7 + mv_len + plen
            else:
                _, plen = struct.unpack(">BI", data[end:end + 5])
                end += 5 + plen
        if len(data) < end:
            return None, data
        return data[:end], data[end:]

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = self._tail + bytes(buf.data)
        ret = FlowReturn.OK
        while True:
            try:
                chunk, data = self._take_complete_chunk(data)
            except ValueError:
                self._tail = b""
                return FlowReturn.ERROR
            if chunk is None:
                break
            ret = self._decode_and_push(chunk, buf)
            if ret != FlowReturn.OK:
                break
        self._tail = data
        return ret

    def _decode_and_push(self, chunk: bytes, buf: Buffer) -> FlowReturn:
        try:
            frames, info = self._dec().decode_chunk(chunk)
        except ValueError:
            return FlowReturn.ERROR
        if not self._caps_sent:
            self._caps_sent = True
            self.srcpad.push_event(CapsEvent(Caps.new(
                "video/x-raw", format="RGB",
                width=info["width"], height=info["height"])))
        pts_list = buf.meta.get("frame_pts") or [None] * len(frames)
        dur = (buf.duration // len(frames)
               if buf.duration is not None else None)
        if dur is None:  # byte-stream input: synthesize from caps framerate
            fr = (self.sinkpad.caps.get("framerate")
                  if self.sinkpad.caps is not None else None)
            fr = fr or Fraction(30, 1)
            dur = int(1_000_000_000 * fr.denominator / max(1, fr.numerator))
        for i in range(frames.shape[0]):
            pts = pts_list[i] if i < len(pts_list) else None
            if pts is None and buf.pts is not None and \
                    buf.meta.get("frame_pts"):
                pts = buf.pts + i * dur
            if pts is None:
                pts = self._frame_count * dur
            self._frame_count += 1
            ret = self.srcpad.push(Buffer(frames[i], pts=pts, duration=dur))
            if ret != FlowReturn.OK:
                return ret
        return FlowReturn.OK
