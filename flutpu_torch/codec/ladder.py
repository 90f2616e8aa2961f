"""ABR ladder encoding on the GPU (port of flutpu/codec/ladder.py).

One input stream, N resolution/quality rungs: every GOP chunk is
uploaded once, scaled on the device per rung (bilinear, then + 0.5, a
clip and a cast to uint8) and encoded by that rung's ``FvcEncoder``;
only compressed bits come back per rung. With ``adaptive=true`` a
``src_active`` pad carries, per chunk, the highest rung whose bitrate
fits the port's bandwidth meter (``flutpu_torch.fluc.bwmeter``).

Element: ``cudafvcladderenc rungs="1920x1080@85,960x540@80,480x270@75"``
with one ``src_%u`` pad per rung (caps carry the rung geometry).
``Rung``, ``parse_rungs`` and the rung choice are copies of flutpu's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core import (Buffer, Caps, Element, Event, EventType, FlowReturn,
                    Pad, PadDirection, PropertySpec, register)
from .fvc import FvcEncoder
from .ops.colorspace import scale_bilinear


@dataclass(frozen=True)
class Rung:
    width: int
    height: int
    quality: int


def parse_rungs(spec: str) -> List[Rung]:
    """'1920x1080@85,960x540@80' → [Rung(1920,1080,85), ...]"""
    rungs = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        geo, _, q = part.partition("@")
        w, _, h = geo.partition("x")
        rungs.append(Rung(int(w), int(h), int(q) if q else 85))
    if not rungs:
        raise ValueError(f"no rungs in {spec!r}")
    return rungs


def scale_rung(frames: torch.Tensor, rung: Rung) -> torch.Tensor:
    """(F, H, W, 3) uint8 frames → the rung's (F, h, w, 3) uint8 frames,
    on the frames' device: bilinear, + 0.5, clipped, cast (flutpu's
    rounding)."""
    return (scale_bilinear(frames, rung.height, rung.width) + 0.5) \
        .clamp(0, 255).to(torch.uint8)


def encode_ladder_chunk(frames, rungs: List[Rung], motion: bool = False,
                        encoders: Optional[dict] = None,
                        bframes: int = 0, device="cuda") -> List[bytes]:
    """(F, H, W, 3) uint8 (numpy or tensor) → one FVC chunk per rung.

    The frames are uploaded to ``device`` once; each rung scales them
    there (``scale_rung``) and encodes them with its ``FvcEncoder``. Pass
    a dict to reuse the encoders (and their adopted sizes) across
    chunks. ``bframes`` (motion mode) encodes B frames per rung."""
    dev = torch.as_tensor(np.ascontiguousarray(frames)
                          if isinstance(frames, np.ndarray) else frames)
    dev = dev.to(device)
    out = []
    for r in rungs:
        key = (r.width, r.height, r.quality, motion, bframes)
        enc = None if encoders is None else encoders.get(key)
        if enc is None:
            enc = FvcEncoder(quality=r.quality, motion=motion,
                             bframes=bframes if motion else 0,
                             device=device)
            if encoders is not None:
                encoders[key] = enc
        out.append(enc.encode_chunk(scale_rung(dev, r)))
    return out


@register
class CudaFvcLadderEnc(Element):
    """cudafvcladderenc — encodes every GOP chunk at N rungs on a CUDA
    device (port of flutpu's ``fvcladderenc``); one src pad per rung
    (src_0 = first rung in the list)."""

    FACTORY = "cudafvcladderenc"
    PROPERTIES = [
        PropertySpec("rungs", "1920x1080@85", "comma list of WxH@quality; "
                     "setting it (re)builds one src_%u pad per rung"),
        PropertySpec("gop-size", 8),
        PropertySpec("motion", False, "v2 hybrid codec per rung"),
        PropertySpec("bframes", 0, "B frames between anchors per rung "
                     "(motion mode): smaller streams for the "
                     "bandwidth-constrained serving case the adaptive "
                     "ladder exists for"),
        PropertySpec("adaptive", False, "add a src_active pad carrying, per "
                     "chunk, the highest rung whose bitrate fits the "
                     "bwmeter's conservative bandwidth estimate"),
        PropertySpec("headroom", 0.8, "fraction of the estimated bandwidth "
                     "a rung may use before stepping down"),
        PropertySpec("device", "cuda", "torch device the scaling and the "
                     "encodes run on (cuda, cuda:N, or cpu for the plain "
                     "versions)"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-raw, format=RGB")))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self.rungs: List[Rung] = []
        self.srcpads: List[Pad] = []
        self._pending: List[Buffer] = []
        self._encoders: dict = {}
        self._caps_sent = False
        self._active_pad: Optional[Pad] = None
        from ..fluc.bwmeter import bwmeter
        self._meter = bwmeter  # injectable for tests / per-session meters
        self._rebuild_pads()

    def do_set_property(self, name, value):
        if "srcpads" not in vars(self):
            return  # a property given to __init__: it builds the pads last
        if name in ("rungs", "adaptive"):
            self._rebuild_pads()
        elif name in ("motion", "bframes", "device"):
            self._encoders = {}

    def _rebuild_pads(self) -> None:
        if self._caps_sent:
            raise ValueError("rungs cannot change while streaming")
        for pad in self.srcpads:
            self.pads.pop(pad.name, None)
        if self._active_pad is not None:
            self.pads.pop(self._active_pad.name, None)
            self._active_pad = None
        self.rungs = parse_rungs(str(self.get_property("rungs")))
        self.srcpads = [self.add_pad(Pad(f"src_{i}", PadDirection.SRC, self))
                        for i in range(len(self.rungs))]
        if bool(self.get_property("adaptive")):
            self._active_pad = self.add_pad(
                Pad("src_active", PadDirection.SRC, self))
        self._encoders = {}

    def _emit_caps(self, fps) -> None:
        if self._caps_sent:
            return
        from ..core import CapsEvent
        for pad, r in zip(self.srcpads, self.rungs):
            fields = {"width": r.width, "height": r.height}
            if fps is not None:
                fields["framerate"] = fps
            pad.push_event(CapsEvent(Caps.new("video/x-fvc", **fields)))
        if self._active_pad is not None:
            # geometry varies per chunk on the active pad (rung switches);
            # each buffer carries meta["rung"] naming its source rung
            self._active_pad.push_event(
                CapsEvent(Caps.new("video/x-fvc", adaptive=True)))
        self._caps_sent = True

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._pending.append(buf)
        if len(self._pending) >= int(self.get_property("gop-size")):
            self._flush()
        return FlowReturn.OK

    def _flush(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        frames = np.stack([np.asarray(b.data) for b in batch])
        chunks = encode_ladder_chunk(
            frames, self.rungs, motion=bool(self.get_property("motion")),
            encoders=self._encoders,
            bframes=int(self.get_property("bframes")),
            device=str(self.get_property("device")))
        first, last = batch[0], batch[-1]
        dur = None
        if first.pts is not None and last.pts is not None:
            dur = last.pts - first.pts + (last.duration or 0)
        for pad, chunk in zip(self.srcpads, chunks):
            pad.push(Buffer(chunk, pts=first.pts, dts=first.dts,
                            duration=dur, offset=first.offset))
        if self._active_pad is not None:
            idx = self._select_rung(chunks, dur, len(batch))
            out = Buffer(chunks[idx], pts=first.pts, dts=first.dts,
                         duration=dur, offset=first.offset)
            out.meta["rung"] = idx
            self._active_pad.push(out)

    def _select_rung(self, chunks: List[bytes], dur_ns, n_frames: int) -> int:
        """Highest rung whose chunk bitrate fits within ``headroom`` of the
        meter's conservative (asymmetric-EWMA) bandwidth estimate; the
        lowest rung is the floor. Candidates are ranked by actual chunk
        size (largest = highest quality), so the ``rungs`` property may be
        listed in any order. No estimate yet -> highest-quality rung."""
        dur_sec = dur_ns / 1e9 if dur_ns else n_frames / 30.0
        dur_sec = max(dur_sec, 1e-6)
        # rank by measured chunk size, descending — list order is irrelevant
        order = sorted(range(len(chunks)), key=lambda i: -len(chunks[i]))
        _, avg_bps, _ = self._meter.stats()
        headroom = float(self.get_property("headroom"))
        if avg_bps <= 0:
            return order[0]
        for i in order:
            if len(chunks[i]) * 8 / dur_sec <= avg_bps * headroom:
                return i
        return order[-1]

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            self._emit_caps(event.caps.get("framerate"))
            return True
        if event.type == EventType.EOS:
            self._flush()
        if event.type == EventType.FLUSH_STOP:
            self._pending = []
        ok = True
        for p in self.srcpads:
            ok = p.push_event(event) and ok
        return ok
