"""cudahype — GOP-chunk-parallel encoding in one dispatch on a CUDA
device (port of flutpu/hype/tpu.py:TpuHype).

Where the ``hype`` bin reproduces the reference's thread-per-branch
scatter/gather (one streaming thread per encoder), ``cudahype`` stacks C
GOP chunks into one (C, F, H, W, 3) batch and encodes it in ONE
dispatch on one card: the chunk axis is a batch axis of every kernel
(``flutpu_torch.parallel.gop``), the entropy stage packs the C x F
frames at once, and one copy brings every chunk back. Output leaves in
strict chunk order, the ordered-gather role of the reference's
scenecollector.

- ``codec=jpeg``: the C x F frames through ``JpegEncoder``'s dispatch
  (K1, then K2 on the segment layout, or K7 under
  ``FLUTPU_SEGMENTED=0``; one pinned copy, the native finalize); one JFIF buffer per frame,
  byte for byte a plain ``JpegEncoder`` encode of the same frames.
- ``codec=fvc`` / ``fvc-motion``: the FVC chunk codec over the C chunks
  (``FvcEncoder.encode_chunks_dispatch`` → ``fvc_chunks``); one
  container buffer per chunk, as flutpu writes it. A truncated last
  batch is padded with its last frame; with ``bframes`` a truncated chunk
  is re-encoded alone with the B structure of its real frame count.

Latency: batching C chunks trades latency for throughput as the
reference's round-robin over C branches does — output stalls at most
C * gop-size frames behind input. Chunks on several cards and spatial
striping are not ported yet (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..codec.base import VideoEncoder
from ..codec.fvc import FvcEncoder
from ..codec.jpeg import JpegEncoder
from ..core import Buffer, Caps, PropertySpec, register
from ..parallel.mesh import visible_devices


@register
class CudaHype(VideoEncoder):
    """GOP-parallel MJPEG / FVC encoder: C chunks per dispatch on one CUDA
    device."""

    FACTORY = "cudahype"
    SINK_CAPS = "video/x-raw, format=RGB"
    SRC_CAPS = "image/jpeg"
    PROPERTIES = [
        PropertySpec("gop-size", 8),
        PropertySpec("quality", 85),
        PropertySpec("chunks", 0, "GOP chunks per dispatch (0 = one per "
                                   "visible card)"),
        PropertySpec("spatial", 1, "row stripes per frame: 1 (striping is "
                                   "not ported yet)"),
        PropertySpec("codec", "jpeg", "jpeg | fvc | fvc-motion: MJPEG "
                                      "per-frame buffers, or FVC GOP chunks "
                                      "(one container buffer per chunk)"),
        PropertySpec("search-range", 7, "fvc-motion search window (±px)"),
        PropertySpec("search", "full", "full | hier fvc-motion estimation"),
        PropertySpec("subpel", False, "half-pel fvc-motion refinement "
                     "(not with bframes)"),
        PropertySpec("bframes", 0, "fvc-motion B frames between anchors"),
        PropertySpec("device", "cuda", "torch device the encode runs on "
                     "(cuda, cuda:N, or cpu for the plain versions)"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        self._frames: List[Buffer] = []
        self._jenc: Optional[JpegEncoder] = None
        self._fenc: Optional[FvcEncoder] = None
        self._tail_enc: Optional[FvcEncoder] = None
        super().__init__(name, **props)
        self._set_src_template()

    def _set_src_template(self) -> None:
        fvc = str(self.get_property("codec")).startswith("fvc")
        self.srcpad.template_caps = Caps.from_string(
            "video/x-fvc" if fvc else self.SRC_CAPS)

    def do_set_property(self, name, value):
        if name == "spatial" and int(value) > 1:
            raise NotImplementedError(
                "cudahype spatial > 1: spatial striping (row stripes with "
                "halo exchange, FVC header flags bit 4) is not ported yet "
                "(ROADMAP queue 1, item 5)")
        if name == "codec":
            codec = str(value)
            if codec not in ("jpeg", "fvc", "fvc-motion"):
                raise ValueError(f"cudahype codec={codec!r}: jpeg | fvc | "
                                 "fvc-motion")
            if hasattr(self, "srcpad"):
                self._set_src_template()
        self._jenc = self._fenc = self._tail_enc = None

    def set_format(self, caps: Caps):
        fields = {k: v for k, v in caps.fields.items()
                  if k in ("width", "height", "framerate")}
        if str(self.get_property("codec")).startswith("fvc"):
            return Caps.new("video/x-fvc", **fields)
        return Caps.new("image/jpeg", parsed=True, **fields)

    # -- sizing --------------------------------------------------------------
    @property
    def n_chunks(self) -> int:
        """C, the chunks of one dispatch: ``chunks``, or one per visible
        card (one on the CPU)."""
        n = int(self.get_property("chunks"))
        if n:
            return n
        if torch.device(str(self.get_property("device"))).type == "cuda":
            return max(1, len(visible_devices()))
        return 1

    @property
    def _batch_target(self) -> int:
        return self.n_chunks * int(self.get_property("gop-size"))

    def _motion_args(self):
        motion = str(self.get_property("codec")) == "fvc-motion"
        return dict(motion=motion,
                    search_range=int(self.get_property("search-range")),
                    hier=str(self.get_property("search")) == "hier",
                    subpel=motion and bool(self.get_property("subpel")),
                    bframes=int(self.get_property("bframes")) if motion
                    else 0)

    def _jpeg(self) -> JpegEncoder:
        if self._jenc is None:
            self._jenc = JpegEncoder(int(self.get_property("quality")),
                                     device=str(self.get_property("device")))
        return self._jenc

    def _fvc(self) -> FvcEncoder:
        if self._fenc is None:
            self._fenc = FvcEncoder(int(self.get_property("quality")),
                                    device=str(self.get_property("device")),
                                    **self._motion_args())
        return self._fenc

    # -- the element contract ---------------------------------------------------
    def encode_frame(self, buf: Buffer, keyframe: bool) -> Optional[Buffer]:
        self._frames.append(buf)
        if len(self._frames) >= self._batch_target:
            self._flush()
        return None

    def drain(self) -> None:
        self._flush()

    def reset(self) -> None:
        self._frames = []

    def finish(self):
        self._flush()
        return []

    def _flush(self) -> None:
        """Stack the held frames, pad a short batch by repeating its last
        frame (outputs past the real frames are dropped), and encode the
        C chunks in one dispatch; pad to the coded size happens on the
        device."""
        if not self._frames:
            return
        batch, self._frames = self._frames, []
        gop = int(self.get_property("gop-size"))
        n_chunks = self.n_chunks
        frames = np.stack([np.asarray(b.data) for b in batch])
        n, h, w, _ = frames.shape
        total = n_chunks * gop
        if n < total:
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], total - n, axis=0)], axis=0)
        dev = torch.device(str(self.get_property("device")))
        t = torch.from_numpy(frames).to(dev)
        if str(self.get_property("codec")).startswith("fvc"):
            self._flush_fvc(batch, t.reshape(n_chunks, gop, h, w, 3), n)
            return
        jenc = self._jpeg()
        payloads = jenc.encode_gop_finalize(jenc.encode_gop_dispatch(t, h, w))
        for src, data in zip(batch, payloads):
            self.srcpad.push(Buffer(data, pts=src.pts, dts=src.dts,
                                    duration=src.duration, offset=src.offset))

    def _flush_fvc(self, batch, chunks: torch.Tensor, n: int) -> None:
        """One container per chunk that holds real frames, in chunk order;
        flutpu's pts/dts/duration arithmetic."""
        c, gop = chunks.shape[:2]
        enc = self._fvc()
        counts = [max(0, min(gop, n - ci * gop)) for ci in range(c)]
        datas = enc.encode_chunks_finalize(enc.encode_chunks_dispatch(chunks),
                                           counts)
        for ci, (real, data) in enumerate(zip(counts, datas)):
            if not real:
                break   # wholly padding
            first = ci * gop
            if enc.bframes and real < gop:
                # a truncated chunk may end on a B frame whose next anchor
                # was cut (the batched encode used the full-gop structure):
                # re-encode its real frames, a structure that ends on an
                # anchor
                data = self._tail().encode_chunk(chunks[ci, :real])
            src, last = batch[first], batch[first + real - 1]
            dur = None
            if src.pts is not None and last.pts is not None:
                dur = last.pts - src.pts + (last.duration or 0)
            self.srcpad.push(Buffer(data, pts=src.pts, dts=src.dts,
                                    duration=dur, offset=src.offset))

    def _tail(self) -> FvcEncoder:
        if self._tail_enc is None:
            enc = self._fvc()
            self._tail_enc = FvcEncoder(
                enc.quality, segmented=enc._scan_coder.segmented,
                device=enc.device, bquality=enc.bquality,
                **self._motion_args())
        return self._tail_enc
