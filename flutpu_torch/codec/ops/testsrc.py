"""On-device test video source (port of flutpu/codec/ops/testsrc.py).

Frames are generated directly in device memory, so benchmarks and
self-tests of the encode path measure the pipeline, not the host link.
Patterns are deterministic functions of the frame index: there is no
random state.
"""

from __future__ import annotations

import torch


def _gradient_ball_channels(h: int, w: int, n: int, start, device):
    """Shared math of the gradient-ball pattern as three f32 channel
    planes (r, g, b), each (n, h, w), BEFORE clip/cast."""
    f32 = torch.float32
    # per-frame scalars (blue level, ball centre) are computed on the CPU
    # whatever the device: the card's sin and cos differ from the CPU's in
    # the last bit, which moves a pixel of the ball's edge
    idx = torch.as_tensor(start, dtype=f32).cpu() + torch.arange(n, dtype=f32)
    blue = ((idx * 5.0) % 256.0).to(device)[:, None, None]
    cx = ((0.5 + 0.4 * torch.sin(idx * 0.2)) * w).to(device)[:, None, None]
    cy = ((0.5 + 0.4 * torch.cos(idx * 0.23)) * h).to(device)[:, None, None]
    yy = torch.arange(h, dtype=f32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=f32, device=device)[None, None, :]

    # the divisors are tensors on the device: given a Python number,
    # torch's CUDA kernel multiplies by its reciprocal instead, which
    # rounds some ramp values one level below the CPU's IEEE division
    def span(size):
        return torch.tensor(float(max(size - 1, 1)), dtype=f32, device=device)

    r = (xx * 255.0 / span(w)).expand(n, h, w)
    g = (yy * 255.0 / span(h)).expand(n, h, w)
    b = blue.expand(n, h, w)

    rad = max(4.0, min(h, w) / 10.0)
    mask = ((xx - cx) ** 2 + (yy - cy) ** 2) <= rad * rad
    return tuple(torch.where(mask, 255.0, p) for p in (r, g, b))


def gradient_ball_frames(h: int, w: int, n: int, start, *,
                         device) -> torch.Tensor:
    """n frames of a moving bright ball over an animated gradient —
    realistic mixed content (smooth background + moving edge detail).
    Returns (n, h, w, 3) uint8 on ``device``."""
    r, g, b = _gradient_ball_channels(h, w, n, start, device)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def gradient_ball_planes(h: int, w: int, n: int, start, *, device):
    """gradient_ball_frames in channel-planar form: (r, g, b) uint8
    planes, each (n, h, w), value-identical to slicing the interleaved
    frames. The front-end kernel reads planes."""
    r, g, b = _gradient_ball_channels(h, w, n, start, device)
    return tuple(p.clamp(0, 255).to(torch.uint8) for p in (r, g, b))
