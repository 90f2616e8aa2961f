"""GOP-chunk encode of C chunks in one dispatch (port of
flutpu/parallel/gop.py).

flutpu runs its per-chunk codec under ``shard_map`` over the ``chunk``
mesh axis and ``vmap``s it over the chunks of a shard, so every Pallas
kernel there runs with a batch grid axis. On one CUDA device the C
chunks are a batch axis of the same kind:

- ``encode_chunks``: the front-end kernel (K1) over (C, F, H, W) planes,
  C x F folded into its frame axis;
- ``fvc_chunks``: the FVC chunk codec over C chunks at once. Version 1 is
  K1 (the plain 4:4:4 front end without ``subsample``) and one residual
  chain per chunk; version 2 runs each frame step of all C chunks
  together: one search launch (K3, or K5 with ``hier``), one chroma
  launch (K4; with ``subpel`` instead the half-pel refine and bilinear
  compensation over the (C, ...) planes), the I/P decision per chunk,
  one batched in-loop transform, and with ``bframes`` the B pass
  likewise.

Each chunk is independent (frame 0 of every chunk is an I frame: the
forced-keyframe contract of the hype bin), so a chunk's output is what a
dispatch of it alone gives. Chunks on several cards and spatial striping
raise ``NotImplementedError`` (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..codec.fvc import (fvc_mc_encode_chunk, fvc_mc_encode_chunk_b,
                         fvc_residuals_chunks)
from ..codec.jpeg import _pad_to, _planes_front_end
from .mesh import ChunkMesh


def _striping_not_ported():
    return NotImplementedError(
        "spatial striping (row stripes with halo exchange, FVC header "
        "flags bit 4) is not ported yet (ROADMAP queue 1, item 5)")


def _chunk_planes(frames):
    """(C, F, H, W, 3) uint8 frames or an (r, g, b) tuple of (C, F, H, W)
    planes → the three planes."""
    if isinstance(frames, (tuple, list)):
        planes = tuple(frames)
    else:
        if frames.dim() != 5 or frames.shape[-1] != 3:
            raise ValueError("frames must be (C, F, H, W, 3), got "
                             f"{tuple(frames.shape)}")
        planes = (frames[..., 0], frames[..., 1], frames[..., 2])
    if any(p.dim() != 4 or p.shape != planes[0].shape for p in planes):
        raise ValueError("planes must be three (C, F, H, W) tensors of one "
                         "shape")
    return planes


def _on_mesh(planes, mesh: Optional[ChunkMesh]):
    """The planes on the mesh's device (a one-device mesh; None: where
    they lie)."""
    if mesh is None:
        return planes
    dev = mesh.single_device()
    return tuple(p.to(dev) for p in planes)


def encode_chunks(frames, qy: torch.Tensor, qc: torch.Tensor,
                  mesh: Optional[ChunkMesh] = None, spatial: bool = False,
                  subsample: bool = True):
    """(C, F, H, W, 3) uint8 — or a channel-planar (r, g, b) tuple of
    (C, F, H, W) planes — → (y, cb, cr) int16 (C, F, BH, BW, 64)
    zigzagged quantized coefficients of the frames edge-padded to
    multiples of 16: one launch of K1 over the C x F frames (without
    ``subsample``: multiples of 8 through the plain 4:4:4 front end)."""
    if spatial:
        raise _striping_not_ported()
    r, g, b = _on_mesh(_chunk_planes(frames), mesh)
    c, f, h, w = r.shape
    mult = 16 if subsample else 8
    coefs = _planes_front_end(*(p.flatten(0, 1) for p in (r, g, b)),
                              qy.to(r.device), qc.to(r.device),
                              _pad_to(h, mult), _pad_to(w, mult),
                              subsample=subsample)
    return tuple(x.reshape(c, f, *x.shape[1:]) for x in coefs)


def encode_chunks_single(frames, qy: torch.Tensor, qc: torch.Tensor):
    """flutpu's unsharded variant: (..., H, W, 3) uint8 frames, any
    leading shape → coefficients of that leading shape (one K1 launch)."""
    lead = frames.shape[:-3]
    flat = frames.reshape(-1, *frames.shape[-3:])
    coefs = encode_chunks(flat[None], qy, qc)
    return tuple(x.reshape(*lead, *x.shape[2:]) for x in coefs)


def fvc_chunks(frames, qy: torch.Tensor, qc: torch.Tensor,
               mesh: Optional[ChunkMesh] = None, motion: bool = False,
               search_range: int = 7, hier: bool = False,
               subpel: bool = False, spatial: bool = False,
               bframes: int = 0, qy_b=None, qc_b=None,
               subsample: bool = True):
    """The FVC chunk codec over C chunks in one dispatch (the counterpart
    of flutpu's ``fvc_chunks_sharded``): (C, F, H, W, 3) uint8 frames, or
    an (r, g, b) tuple of (C, F, H, W) planes, edge-padded to multiples of
    16. Each chunk is coded independently (frame 0 intra).

    Returns (ry, rcb, rcr) int16 (C, F, BH, BW, 64) residual planes; with
    ``motion`` also mvs (C, F, H/16, W/16, 2) int8 and itypes (C, F) int8;
    with ``bframes`` > 0 (motion only) instead (ry, rcb, rcr, fwd, bwd,
    modes, ftypes), as flutpu's. ``subpel`` (motion, no ``bframes``):
    half-pel vectors. ``subsample=False`` (version 1 only): 4:4:4."""
    if bframes and (not motion or subpel):
        raise ValueError("bframes needs motion=True and does not "
                         "support subpel")
    if spatial:
        raise _striping_not_ported()
    if motion and not subsample:
        raise ValueError("motion mode requires 4:2:0")
    planes = _on_mesh(_chunk_planes(frames), mesh)
    qy, qc = qy.to(planes[0].device), qc.to(planes[0].device)
    h, w = planes[0].shape[-2:]
    ph, pw = _pad_to(h, 16), _pad_to(w, 16)
    if not motion:
        return fvc_residuals_chunks(*encode_chunks(planes, qy, qc,
                                                   subsample=subsample))
    if bframes:
        return fvc_mc_encode_chunk_b(planes, qy, qc, ph, pw, search_range,
                                     bframes, hier, qy_b=qy_b, qc_b=qc_b)
    return fvc_mc_encode_chunk(planes, qy, qc, ph, pw, search_range, hier,
                               subpel)
