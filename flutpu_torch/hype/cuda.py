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

- ``codec=jpeg``: K1 over the C x F frames (``encode_chunks``), then
  ``JpegEncoder.scan_planes_dispatch`` (K2 on the segment layout, or K7
  under ``FLUTPU_SEGMENTED=0``; one pinned copy, the native finalize);
  one JFIF buffer per frame, byte for byte a plain ``JpegEncoder``
  encode of the same frames.
- ``codec=fvc`` / ``fvc-motion``: the FVC chunk codec over the C chunks
  (``FvcEncoder.encode_chunks_dispatch`` → ``fvc_chunks``); one
  container buffer per chunk, as flutpu writes it. A truncated last
  batch is padded with its last frame; with ``bframes`` a truncated chunk
  is re-encoded alone with the B structure of its real frame count.

Several cards and row stripes (flutpu's chunk x spatial mesh): with
``device=cuda`` the element deals a mesh of M chunk shards x ``spatial``
stripes round the visible cards (``deal_devices``; M the largest divisor
of C not above cards // spatial); with ``device=cuda:N`` or ``cpu``
every slot lies on that device, one chunk shard. Each shard's block of
chunks is one dispatch on its devices. ``spatial>1`` pads H to 16 x
stripes on the device; JPEG crops the coefficient planes back to the
standard MCU rows before the pack (``JpegEncoder.scan_planes_dispatch``),
so its JFIF are byte-identical to an unstriped encode; FVC writes the
coded size (header flags bit 4) where the padding exceeds the standard
one. On one card with ``spatial=1`` the mesh is one shard: C chunks in
one dispatch, as without a mesh.

Latency: batching C chunks trades latency for throughput as the
reference's round-robin over C branches does — output stalls at most
C * gop-size frames behind input.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..codec.base import VideoEncoder
from ..codec.fvc import FvcEncoder
from ..codec.jpeg import JpegEncoder, _pad_to, jpeg_headers
from ..core import Buffer, Caps, PropertySpec, register
from ..parallel.gop import chunk_blocks, encode_chunks
from ..parallel.mesh import (ChunkMesh, ChunkSpatialMesh, deal_devices,
                             visible_devices)


@register
class CudaHype(VideoEncoder):
    """GOP-parallel MJPEG / FVC encoder: C chunks per dispatch, dealt
    round the visible CUDA cards (all on one device with ``device=cuda:N``
    or ``cpu``)."""

    FACTORY = "cudahype"
    SINK_CAPS = "video/x-raw, format=RGB"
    SRC_CAPS = "image/jpeg"
    PROPERTIES = [
        PropertySpec("gop-size", 8),
        PropertySpec("quality", 85),
        PropertySpec("chunks", 0, "GOP chunks per dispatch (0 = one per "
                                   "chunk shard: visible cards // spatial, "
                                   "at least 1)"),
        PropertySpec("spatial", 1, "row-stripe each frame across this many "
                                   "shards (chunk x spatial mesh, for frame "
                                   "sizes too heavy for one card, e.g. 4K); "
                                   "fvc-motion exchanges halo rows between "
                                   "stripes and decides the frame type over "
                                   "all of them (integer-pel full search); "
                                   "FVC streams carry the coded size "
                                   "(header flags bit 4)"),
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
    def _spatial(self) -> int:
        return max(1, int(self.get_property("spatial")))

    def _cards(self):
        """The visible cards with ``device=cuda``; else None (one
        device)."""
        dev = str(self.get_property("device"))
        return visible_devices() if dev == "cuda" else None

    @property
    def n_chunks(self) -> int:
        """C, the chunks of one dispatch: ``chunks``, or one per chunk
        shard the visible cards hold (cards // spatial; one on the
        CPU)."""
        n = int(self.get_property("chunks"))
        if n:
            return n
        cards = self._cards()
        if cards is not None:
            return max(1, len(cards) // self._spatial)
        return 1

    def mesh(self) -> ChunkMesh:
        """The chunk x spatial mesh of one dispatch: with ``device=cuda``
        M chunk shards x ``spatial`` stripes dealt round the visible cards
        (M the largest divisor of C not above cards // spatial); else
        one shard whose stripes all lie on ``device``."""
        sp, c = self._spatial, self.n_chunks
        cards = self._cards()
        if cards is None:
            slots = [torch.device(str(self.get_property("device")))] * sp
            m = 1
        else:
            m = max(k for k in range(1, max(1, len(cards) // sp) + 1)
                    if c % k == 0)
            slots = deal_devices(m * sp, cards)
        return ChunkSpatialMesh(m, sp, slots)

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

    def _encoder_device(self) -> torch.device:
        """Where the encoders keep their tables: ``device``, or with
        ``device=cuda`` the first visible card (the mesh's first slot)."""
        cards = self._cards()
        if cards:
            return cards[0]
        return torch.device(str(self.get_property("device")))

    def _jpeg(self) -> JpegEncoder:
        if self._jenc is None:
            self._jenc = JpegEncoder(int(self.get_property("quality")),
                                     device=self._encoder_device())
        return self._jenc

    def _fvc(self) -> FvcEncoder:
        if self._fenc is None:
            args = self._motion_args()
            if self._spatial > 1 and args["motion"] and (args["hier"]
                                                         or args["subpel"]):
                raise ValueError("codec=fvc spatial striping supports "
                                 "full-search integer-pel motion (and v1)")
            self._fenc = FvcEncoder(int(self.get_property("quality")),
                                    device=self._encoder_device(), **args)
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
        C chunks over the mesh: one dispatch per chunk shard (one shard on
        one card: C chunks in one dispatch); pad to the coded size happens
        on the device."""
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
        mesh = self.mesh()
        t = torch.from_numpy(frames)
        if len(set(mesh.devices)) == 1:
            t = t.to(mesh.devices[0])   # one copy up for every shard
        chunks = t.reshape(n_chunks, gop, h, w, 3)
        if str(self.get_property("codec")).startswith("fvc"):
            self._flush_fvc(batch, chunks, n, mesh)
            return
        payloads = self._jpeg_mesh(self._jpeg(), chunks, h, w, mesh)
        for src, data in zip(batch, payloads):
            self.srcpad.push(Buffer(data, pts=src.pts, dts=src.dts,
                                    duration=src.duration, offset=src.offset))

    def _jpeg_mesh(self, jenc: JpegEncoder, chunks: torch.Tensor, h: int,
                   w: int, mesh: ChunkMesh) -> List[bytes]:
        """JPEG over a mesh: per chunk shard, K1 on each of its stripes,
        the coefficient planes gathered on its first device and cropped to
        the standard MCU rows (the stripes' padding is not the scan's),
        then the pack and one copy (``scan_planes_dispatch``); JFIF in
        chunk order."""
        mh = _pad_to(h, 16)
        handles = []
        for sl, shard in chunk_blocks(chunks.shape[0], mesh, spatial=True):
            sub = ChunkSpatialMesh(1, len(shard), shard)
            yq, cbq, crq = (x.flatten(0, 1) for x in encode_chunks(
                chunks[sl], jenc.scans.qy_dev, jenc.scans.qc_dev, mesh=sub,
                spatial=True))
            handles.append(jenc.scan_planes_dispatch(
                (yq[:, :mh // 8], cbq[:, :mh // 16], crq[:, :mh // 16])))
        hdr = jpeg_headers(h, w, jenc.qy, jenc.qc, True)
        return [hdr + scan + b"\xff\xd9" for hd in handles
                for scan in jenc.scan_planes_finalize(hd)]

    def _flush_fvc(self, batch, chunks: torch.Tensor, n: int,
                   mesh: ChunkMesh) -> None:
        """One container per chunk that holds real frames, in chunk order;
        flutpu's pts/dts/duration arithmetic. One dispatch per chunk shard
        of ``mesh``, striped as the mesh says."""
        c, gop = chunks.shape[:2]
        enc = self._fvc()
        counts = [max(0, min(gop, n - ci * gop)) for ci in range(c)]
        datas = enc.encode_chunks_finalize(
            enc.encode_chunks_dispatch(chunks, mesh), counts)
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
                enc.quality, segmented=enc.scans.segmented,
                device=enc.device, bquality=enc.bquality,
                **self._motion_args())
        return self._tail_enc
