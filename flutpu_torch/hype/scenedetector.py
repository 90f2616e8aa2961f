"""scenedetector — GOP-chunk boundary generator.

A copy of flutpu/hype/scenedetector.py on the port's core.

In-place passthrough video filter: every ``gop_size`` frames (keyed off the
buffer ``offset``) it emits a SceneNewEvent downstream *before* the buffer,
marking the start of chunk ``offset // gop_size``. Fixed-GOP chunking, no
pixel analysis — faithful to the reference
(hype/src/scenedetector/imp.rs:141-161).
"""

from __future__ import annotations

from typing import Optional

from ..core import (Buffer, Element, FlowReturn, Pad, PadDirection,
                    PropertySpec, register)
from .events import SceneNewEvent
from ..core.log import category

CAT = category("hype", "GOP-parallel encoder")

DEFAULT_GOP_SIZE = 10


@register
class SceneDetector(Element):
    """GOP-chunk boundary generator.

    Default behavior matches the reference exactly: a SceneNewEvent every
    ``gop-size`` buffers keyed off the buffer offset (fixed GOP — the
    reference's scenedetector does no pixel analysis despite its name,
    hype/src/scenedetector/imp.rs:141-161).

    ``scene-threshold`` > 0 enables actual content-based detection on top:
    a chunk boundary is also emitted when the mean absolute luma difference
    between consecutive frames exceeds the threshold (a scene cut), so
    chunks align with content transitions and downstream codecs start cuts
    on I frames. gop-size then acts as the maximum chunk length.
    """

    FACTORY = "scenedetector"
    PROPERTIES = [
        PropertySpec("gop-size", DEFAULT_GOP_SIZE,
                     "emit a SceneNewEvent every gop-size buffers"),
        PropertySpec("scene-threshold", 0.0,
                     "mean |luma diff| cut threshold (0 = fixed GOP only)"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self._buffer_count = 0
        self._since_boundary = 0
        self._next_index = 0
        self._prev_luma = None

    def _is_cut(self, buf: Buffer) -> bool:
        threshold = float(self.get_property("scene-threshold") or 0.0)
        if threshold <= 0:
            return False
        import numpy as np
        data = buf.data
        if not isinstance(data, np.ndarray) or data.ndim < 2:
            return False
        # subsampled luma proxy; cheap host math on a decimated grid
        frame = data[::8, ::8]
        luma = frame.astype(np.float32).mean(axis=-1) if frame.ndim == 3 \
            else frame.astype(np.float32)
        prev, self._prev_luma = self._prev_luma, luma
        if prev is None or prev.shape != luma.shape:
            return False
        return float(np.abs(luma - prev).mean()) >= threshold

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        gop_size = int(self.get_property("gop-size"))
        offset = buf.offset if buf.offset is not None else self._buffer_count
        self._buffer_count += 1
        adaptive = float(self.get_property("scene-threshold") or 0.0) > 0
        if not adaptive:
            # reference behavior: fixed GOP keyed off the offset
            if offset % gop_size == 0:
                gop_index = offset // gop_size
                CAT.debug("scene event: gop_index=%d gop_size=%d", gop_index,
                          gop_size)
                self.srcpad.push_event(SceneNewEvent(gop_index, gop_size))
            return self.srcpad.push(buf)
        cut = self._is_cut(buf)
        if self._since_boundary == 0 or cut or \
                self._since_boundary >= gop_size:
            CAT.debug("scene event: index=%d (cut=%s)", self._next_index, cut)
            self.srcpad.push_event(SceneNewEvent(self._next_index, gop_size))
            self._next_index += 1
            self._since_boundary = 0
        self._since_boundary += 1
        return self.srcpad.push(buf)
