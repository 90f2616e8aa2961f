"""cudaoverlaycompositor — burn a sparse BGRA overlay stream into video
(port of flutpu/ttml/render/overlay_el.py).

The pipeline-element form of the burn-in: a ``video`` sink pad carries
raw frames, an ``overlay`` sink pad carries cudattmlrender's sparse
interval frames; each video frame is composited with the overlay active
at its timestamp on the element's ``device``. Overlays stay on the
device from their arrival on (``cudattmlrender device-out=true`` hands
them over without a host copy).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import torch

from ...core import (Buffer, Caps, Element, Event, FlowReturn, Pad,
                     PadDirection, PropertySpec, register)
from .composite import overlay_on_frames


@register
class OverlayCompositor(Element):
    """Burns a sparse BGRA overlay stream into raw video frames."""

    FACTORY = "cudaoverlaycompositor"

    PROPERTIES = [
        PropertySpec("device", "cuda",
                     "torch device of the blend; cpu runs the same PyTorch "
                     "code there"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.video_pad = self.add_pad(Pad(
            "video", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-raw, format=RGB")))
        self.overlay_pad = self.add_pad(Pad(
            "overlay", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-raw, format=BGRA")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.video_pad.chain_function = self._video_chain
        self.video_pad.event_function = self._video_event
        self.overlay_pad.chain_function = self._overlay_chain
        self.overlay_pad.event_function = self._overlay_event
        self._lock = threading.Lock()
        # (start, stop, overlay tensor on the device) intervals, sorted by
        # start; fully transparent overlays are not kept
        self._overlays: List[Tuple[int, Optional[int],
                                   Optional[torch.Tensor]]] = []

    def _device(self) -> torch.device:
        return torch.device(str(self.get_property("device")))

    def prewarm(self, caps=None) -> bool:
        """Run the burn-in blend once at ``caps``' geometry on the
        element's device (one zero frame under a zero overlay), so that
        an injectbin swap finds the device context and the blend's
        kernels loaded before it installs any dataflow block (see
        Element.prewarm). False without caps or a width and height."""
        if caps is None:
            return False
        w, h = caps.get("width"), caps.get("height")
        if not w or not h:
            return False
        dev = self._device()
        frames = torch.zeros((1, int(h), int(w), 3), dtype=torch.uint8,
                             device=dev)
        ov = torch.zeros((int(h), int(w), 4), dtype=torch.uint8, device=dev)
        overlay_on_frames(frames, ov).cpu()
        return True

    # -- overlay branch ----------------------------------------------------
    def _overlay_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        start = buf.pts if buf.pts is not None else 0
        stop = None if buf.duration is None else start + buf.duration
        ov = torch.as_tensor(buf.data).to(self._device())
        if not bool((ov[..., 3] != 0).any()):
            ov = None    # nothing to burn in during this interval
        with self._lock:
            self._overlays.append((start, stop, ov))
            self._overlays.sort(key=lambda x: x[0])
        return FlowReturn.OK

    def _overlay_event(self, pad: Pad, event: Event) -> bool:
        return True  # overlay branch events terminate here

    # -- video branch ------------------------------------------------------
    def _active_overlay(self, pts: Optional[int]) -> Optional[torch.Tensor]:
        if pts is None:
            return None
        with self._lock:
            # prune intervals that ended before this frame: video pts is
            # monotone on this pad, and a long-running pipeline otherwise
            # accumulates one full-frame BGRA tensor per subtitle interval
            # forever (~8 MB each at 1080p) with a linear scan per frame
            if self._overlays:
                self._overlays = [o for o in self._overlays
                                  if o[1] is None or pts < o[1]]
            for start, stop, ov in self._overlays:
                if start <= pts and (stop is None or pts < stop):
                    return ov
        return None

    def _video_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        ov = self._active_overlay(buf.pts)
        if ov is None:
            return self.srcpad.push(buf)
        frame = torch.as_tensor(buf.data).to(ov.device)
        if ov.shape[:2] != frame.shape[:2]:
            # scale the overlay to the video geometry
            from ...codec.ops.colorspace import scale_bilinear
            ov = (scale_bilinear(ov, frame.shape[0], frame.shape[1])
                  + 0.5).clamp(0, 255).to(torch.uint8)
        res = buf.copy()
        res.data = overlay_on_frames(frame[None], ov)[0].cpu().numpy()
        return self.srcpad.push(res)

    def _video_event(self, pad: Pad, event: Event) -> bool:
        return self.srcpad.push_event(event)
