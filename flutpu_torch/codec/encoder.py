"""cudajpegenc — the GPU intra-frame encoder element (port of
flutpu/codec/encoder.py:TpuJpegEnc).

Frames accumulate into GOP batches on the host; each batch is one device
dispatch of the flutpu_torch.codec.jpeg path (front-end kernel, then the
segment pack kernel and word-aligned segments, or with
``segmented=false`` the per-block pack kernel and the block concat) and
one copy back of the compressed bits; with ``engine=host`` the front end
and one copy back of the coefficient planes, which the native scan coder
codes on the host. Every frame is a sync point. Batch sizes are bucketed
to powers of two, as in the original.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import Buffer, Caps, PropertySpec, register

from .base import VideoEncoder
from .jpeg import JpegEncoder, segmented_property

_BUCKETS = (1, 2, 4, 8, 16, 32)

# name of the hype bin's chunk-boundary event; copy of
# flutpu.hype.events.SCENE_NEW_EVENT_NAME
SCENE_NEW_EVENT_NAME = "scene-new-hype-event"


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


@register
class CudaJpegEnc(VideoEncoder):
    """MJPEG encoder: whole-GOP device transforms and on-device Huffman
    packing on a CUDA device (host Huffman coding with ``engine=host``);
    every frame a sync point."""

    FACTORY = "cudajpegenc"
    SINK_CAPS = "video/x-raw, format=RGB"
    SRC_CAPS = "image/jpeg"
    PROPERTIES = [
        PropertySpec("quality", 85),
        PropertySpec("batch-frames", 8, "max frames batched per device dispatch"),
        PropertySpec("subsample", True, "4:2:0 chroma subsampling; false "
                     "encodes 4:4:4"),
        PropertySpec("engine", "auto", "auto | device | host entropy "
                     "coding; auto never leaves the device here"),
        PropertySpec("segmented", "auto", "bitstream layout of the device "
                     "stage: auto (FLUTPU_SEGMENTED, else segments) | true "
                     "| false (per-block pack); the bytes are the same"),
        PropertySpec("device", "cuda", "torch device the encode runs on "
                     "(cuda, cuda:N, or cpu for the plain versions)"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self._encoder: Optional[JpegEncoder] = None
        self._pending: List[Buffer] = []
        self._gop_size: Optional[int] = None  # learned from scene-new events
        self._frames_in_chunk = 0

    def _get_encoder(self) -> JpegEncoder:
        if self._encoder is None:
            self._encoder = JpegEncoder(
                quality=int(self.get_property("quality")),
                subsample=bool(self.get_property("subsample")),
                engine=str(self.get_property("engine")),
                segmented=segmented_property(self.get_property("segmented")),
                device=str(self.get_property("device")))
        return self._encoder

    def do_set_property(self, name, value):
        if name in ("quality", "subsample", "engine", "segmented", "device"):
            self._encoder = None  # rebuild with new tables / device

    def prewarm(self, caps=None) -> bool:
        """Build the kernels and run one GOP of ``caps``' geometry."""
        if caps is None:
            return False
        w, h = caps.get("width"), caps.get("height")
        if not w or not h:
            return False
        n = _bucket(int(self.get_property("batch-frames")))
        self._get_encoder().encode_gop(np.zeros((n, int(h), int(w), 3),
                                                np.uint8))
        return True

    def set_format(self, caps: Caps) -> Optional[Caps]:
        fields = {k: v for k, v in caps.fields.items()
                  if k in ("width", "height", "framerate")}
        return Caps.new("image/jpeg", parsed=True, **fields)

    # -- encoding ----------------------------------------------------------
    def encode_frame(self, buf: Buffer, keyframe: bool) -> Optional[Buffer]:
        self._pending.append(buf)
        self._frames_in_chunk += 1
        chunk_done = (self._gop_size is not None
                      and self._frames_in_chunk >= self._gop_size)
        if chunk_done or len(self._pending) >= int(self.get_property("batch-frames")):
            self._flush_batch()
            if chunk_done:
                self._frames_in_chunk = 0
        return None

    def finish(self):
        self._flush_batch()
        return []

    def drain(self) -> None:
        self._flush_batch()

    def reset(self) -> None:
        self._pending = []
        self._frames_in_chunk = 0

    def on_custom_event(self, event) -> None:
        if event.name == SCENE_NEW_EVENT_NAME:
            self._gop_size = int(event.structure["gop_size"])
            self._frames_in_chunk = 0

    def _flush_batch(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        frames = np.stack([np.asarray(b.data) for b in batch])
        n = len(batch)
        bn = _bucket(n)
        if bn != n:  # pad to the bucket: one batch shape per size class
            pad = np.repeat(frames[-1:], bn - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        payloads = self._get_encoder().encode_gop(frames)[:n]
        for src, data in zip(batch, payloads):
            out = Buffer(data, pts=src.pts, dts=src.dts,
                         duration=src.duration, offset=src.offset)
            self.srcpad.push(out)
