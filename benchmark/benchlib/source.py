"""Frame sources of the traffic mixes, made on the device from the seed.
The content is synthetic.

``pan``: per chunk a background texture (uniform noise smoothed by box
passes of 3x3) larger than the frame, each frame a crop of it moved a
fixed number of rows and columns a frame, so new content enters at the
leading edges and nothing wraps; over it textured rectangles, each moving
at a speed of its own, so their macroblocks and those they uncover find
no match in the pan; and independent Gaussian noise in every frame, so a
P frame codes a residual in every macroblock. Every seed gets the same
sizes and speeds: it draws the textures, the noise, and each object's
start and directions.
"""

from __future__ import annotations

import random

import torch


def _smooth(tex: torch.Tensor, passes: int) -> torch.Tensor:
    """Box passes of 3x3 over dims 1 and 2 of a float tensor, wrapping
    within the texture itself."""
    for _ in range(passes):
        acc = torch.zeros_like(tex)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc += torch.roll(tex, (dy, dx), dims=(1, 2))
        tex = acc / 9.0
    return tex


def _paths(rng, frames: int, size: int, extent: int, speed: int, what: str):
    """An object's start and direction along one axis: it stays inside
    ``extent`` for all ``frames``."""
    v = speed * rng.choice((-1, 1))
    lo = max(0, -v * (frames - 1))
    hi = extent - size - max(0, v * (frames - 1))
    if hi < lo:
        raise ValueError(f"an object of {size} moving {speed} a frame "
                         f"leaves the frame's {extent} {what}")
    return rng.randint(lo, hi), v


def pan_pool(n_chunks: int, frames: int, h: int, w: int, step, passes: int,
             seed: int, device, object_size=(0, 0), object_speeds=(),
             noise_sigma: float = 0.0) -> torch.Tensor:
    """(n_chunks, frames, h, w, 3) uint8 RGB. Chunk k, frame i: its
    background texture cropped at (step[0] * i, step[1] * i) (steps of
    0 or more), one rectangle of ``object_size`` per entry of
    ``object_speeds`` (rows, columns a frame) pasted at its place, then
    noise of ``noise_sigma`` levels, rounded and clamped. One
    generator on ``device`` seeded with ``seed`` draws the textures and
    the noise, a few calls per chunk."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    rng = random.Random(int(seed))
    if min(step) < 0:
        raise ValueError(f"pan steps {step}: 0 or more")
    th, tw = h + step[0] * (frames - 1), w + step[1] * (frames - 1)
    oh, ow = object_size
    n_obj = len(object_speeds)
    pool = torch.empty((n_chunks, frames, h, w, 3), dtype=torch.uint8,
                       device=device)
    for k in range(n_chunks):
        tex = _smooth(torch.randint(0, 256, (1, th, tw, 3), generator=g,
                                    device=device,
                                    dtype=torch.uint8).to(torch.float32),
                      passes)[0]
        clip = torch.stack([tex[step[0] * i:step[0] * i + h,
                                step[1] * i:step[1] * i + w]
                            for i in range(frames)])
        del tex
        if n_obj:
            objs = _smooth(torch.randint(0, 256, (n_obj, oh, ow, 3),
                                         generator=g, device=device,
                                         dtype=torch.uint8)
                           .to(torch.float32), passes)
            for j, (sy, sx) in enumerate(object_speeds):
                y0, vy = _paths(rng, frames, oh, h, sy, "rows")
                x0, vx = _paths(rng, frames, ow, w, sx, "columns")
                for i in range(frames):
                    y, x = y0 + vy * i, x0 + vx * i
                    clip[i, y:y + oh, x:x + ow] = objs[j]
        if noise_sigma:
            clip += noise_sigma * torch.randn(clip.shape, generator=g,
                                              device=device)
        pool[k] = clip.round_().clamp_(0, 255).to(torch.uint8)
    return pool


SOURCES = {"pan": pan_pool}
