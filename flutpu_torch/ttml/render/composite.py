"""Device compositing — the pixel-heavy half of the renderer (port of
flutpu/ttml/render/composite.py).

Region layers are alpha-over-composited into the output window, and
subtitle overlays are burned into whole video-frame batches
(premultiplied alpha). Plain PyTorch on the tensors' device, in flutpu's
expression order: flutpu's versions are XLA programs, not hand-written
TPU kernels. On the GOP encode path the burn-in does not run here but
inside the front-end kernel (``codec/ops/frontend.py:front_end``), which
``overlay_on_planes`` is the plain version of.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _c255(device: torch.device) -> torch.Tensor:
    return torch.full((), 255.0, dtype=torch.float32, device=device)


def _unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 in 0..1 by an IEEE division. The divisor is a
    tensor on ``x``'s device: given a Python number, torch's CUDA kernel
    multiplies by its reciprocal instead, which rounds some of the 256
    values another way than the CPU's division (and flutpu's) does."""
    return x.to(torch.float32) / _c255(x.device)


def _to_bgra_u8(frame: torch.Tensor) -> torch.Tensor:
    """(..., 4) float32 RGBA in 0..1 → uint8 BGRA (round half up)."""
    rgba = (frame * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
    return rgba[..., [2, 1, 0, 3]]


def compose_window(layers: torch.Tensor, boxes: torch.Tensor,
                   opacities: torch.Tensor, window_h: int,
                   window_w: int) -> torch.Tensor:
    """Composite R region layers into a transparent window.

    layers: (R, window_h, window_w, 4) uint8 RGBA — each layer already
    positioned at the origin of its box and zero elsewhere (host places
    region content; device does the ordered blending).
    boxes: (R, 4) int32 [x, y, w, h] — kept for masking sanity.
    opacities: (R,) float32.
    Returns (window_h, window_w, 4) uint8 BGRA.
    """
    frame = torch.zeros((window_h, window_w, 4), dtype=torch.float32,
                        device=layers.device)
    for i in range(layers.shape[0]):
        src = _unit(layers[i])
        sa = src[..., 3:] * opacities[i]
        out_a = sa + frame[..., 3:] * (1 - sa)
        rgb = (src[..., :3] * sa + frame[..., :3] * frame[..., 3:]
               * (1 - sa)) / out_a.clamp(min=1e-6)
        frame = torch.cat([rgb, out_a], dim=-1)
    return _to_bgra_u8(frame)


def overlay_on_frames(frames: torch.Tensor,
                      overlay_bgra: torch.Tensor) -> torch.Tensor:
    """Burn a BGRA overlay into a batch of RGB video frames.

    frames: (F, H, W, 3) uint8 RGB; overlay: (H, W, 4) uint8 BGRA.
    """
    ov_rgb = overlay_bgra[..., [2, 1, 0]].to(torch.float32)
    a = _unit(overlay_bgra[..., 3:4])
    out = frames.to(torch.float32) * (1 - a) + ov_rgb * a
    return (out + 0.5).clamp(0, 255).to(torch.uint8)


def overlay_on_planes(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                      overlay_bgra: torch.Tensor):
    """Channel-planar overlay_on_frames: (r, g, b) uint8 planes (F, H, W)
    + (H, W, 4) uint8 BGRA overlay → blended (r, g, b) uint8 planes.

    Per-channel math identical to overlay_on_frames (same blend
    expression, clip, cast), so the two formulations are byte-identical.
    The plain version of the front-end kernel's overlay branch."""
    a = _unit(overlay_bgra[..., 3])
    out = []
    for plane, c in ((r, 2), (g, 1), (b, 0)):   # BGRA channel order
        ov_c = overlay_bgra[..., c].to(torch.float32)
        o = plane.to(torch.float32) * (1 - a) + ov_c * a
        out.append((o + 0.5).clamp(0, 255).to(torch.uint8))
    return tuple(out)


def place_layers(region_layers, window_h: int, window_w: int):
    """Host helper: position each RegionLayout's layer into a window-sized
    canvas and stack for compose_window."""
    stacked = []
    boxes = []
    ops = []
    for rl in region_layers:
        canvas = np.zeros((window_h, window_w, 4), np.uint8)
        x0, y0 = max(0, rl.x), max(0, rl.y)
        x1 = min(window_w, rl.x + rl.layer.shape[1])
        y1 = min(window_h, rl.y + rl.layer.shape[0])
        if x1 > x0 and y1 > y0:
            canvas[y0:y1, x0:x1] = rl.layer[y0 - rl.y:y1 - rl.y,
                                            x0 - rl.x:x1 - rl.x]
        stacked.append(canvas)
        boxes.append([rl.x, rl.y, rl.layer.shape[1], rl.layer.shape[0]])
        ops.append(rl.opacity)
    if not stacked:
        stacked = [np.zeros((window_h, window_w, 4), np.uint8)]
        boxes = [[0, 0, 0, 0]]
        ops = [0.0]
    return (np.stack(stacked), np.asarray(boxes, np.int32),
            np.asarray(ops, np.float32))
