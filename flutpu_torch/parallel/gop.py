"""GOP-chunk encode of C chunks in one dispatch per shard (port of
flutpu/parallel/gop.py).

flutpu runs its per-chunk codec under ``shard_map`` over the ``chunk``
mesh axis and ``vmap``s it over the chunks of a shard, so every Pallas
kernel there runs with a batch grid axis. Here each shard's block of
chunks is a batch axis of the same kind on the shard's device:

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

A mesh of M chunk shards (``ChunkMesh``; devices may repeat) splits the
C chunks into M contiguous blocks of C / M, one dispatch per block on
its shard's device (``chunk_blocks``). With ``spatial`` and a
``ChunkSpatialMesh`` each shard also cuts its frames, edge-padded to
16 x stripes rows, into row stripes on its stripe devices: K1 runs per
stripe with no halo (v1, JPEG), and the motion loop searches each stripe
through the rounded-halo route (K3 and K4 on the stripe plus whole
macroblock rows of its ring neighbours) with one I/P decision per chunk
over all its stripes. Outputs come back in chunk order on the first
shard's device, equal to a one-shard call (the stripes' rows gathered).

Each chunk is independent (frame 0 of every chunk is an I frame: the
forced-keyframe contract of the hype bin), so a chunk's output is what a
dispatch of it alone gives.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..codec.fvc import (_check_striped, _gather_rows, fvc_mc_encode_chunk,
                         fvc_mc_encode_chunk_b, fvc_residuals_chunks)
from ..codec.jpeg import _edge_pad, _pad_to, _planes_front_end
from .mesh import ChunkMesh


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


def chunk_blocks(c: int, mesh: Optional[ChunkMesh], spatial: bool
                 ) -> List[Tuple[slice, Tuple[torch.device, ...]]]:
    """The chunk axis over a mesh: per chunk shard, (its contiguous slice
    of the C chunks, its stripes' devices). Without ``spatial`` a shard
    has one stripe (its first device). ValueError where the shards do not
    divide C (``shard_map`` refuses it)."""
    shards = mesh.shards()
    if not spatial:
        shards = tuple(s[:1] for s in shards)
    m = len(shards)
    if c % m:
        raise ValueError(f"{c} chunks do not split evenly over the {m} "
                         f"chunk shards of {mesh!r}")
    cb = c // m
    return [(slice(i * cb, (i + 1) * cb), shard)
            for i, shard in enumerate(shards)]


def _stripes(planes, shard: Sequence[torch.device], mult: int):
    """One block's (C, F, H, W) planes → per stripe of ``shard`` its
    (r, g, b) planes on its device: the frames edge-padded to (16 x
    stripes, 16) multiples (``mult`` for 4:4:4) on the shard's first
    device, then cut into equal row stripes (one stripe: the padded
    frames)."""
    n = len(shard)
    planes = tuple(p.to(shard[0]) for p in planes)
    h, w = planes[0].shape[-2:]
    ph, pw = _pad_to(h, mult * n), _pad_to(w, mult)
    planes = tuple(_edge_pad(p, ph, pw) for p in planes)
    hs = ph // n
    return [tuple(p[..., s * hs:(s + 1) * hs, :].to(d) for p in planes)
            for s, d in enumerate(shard)]


def _blocks(planes, mesh: Optional[ChunkMesh], spatial: bool, mult: int):
    """Per chunk shard (one shard on the planes' device without a mesh),
    its stripes' planes (``_stripes``)."""
    c = planes[0].shape[0]
    blocks = [(slice(0, c), (planes[0].device,))] if mesh is None \
        else chunk_blocks(c, mesh, spatial)
    return [_stripes(tuple(p[sl] for p in planes), shard, mult)
            for sl, shard in blocks]


def encode_chunks(frames, qy: torch.Tensor, qc: torch.Tensor,
                  mesh: Optional[ChunkMesh] = None, spatial: bool = False,
                  subsample: bool = True):
    """(C, F, H, W, 3) uint8 — or a channel-planar (r, g, b) tuple of
    (C, F, H, W) planes — → (y, cb, cr) int16 (C, F, BH, BW, 64)
    zigzagged quantized coefficients of the frames edge-padded to
    multiples of 16: one launch of K1 over the C x F frames (without
    ``subsample``: multiples of 8 through the plain 4:4:4 front end).

    ``mesh``: one launch per chunk shard on its block of C / M chunks;
    with ``spatial`` one per row stripe of a ``ChunkSpatialMesh`` (the
    frames padded to 16 x stripes rows, every MCU inside its stripe, no
    halo). The coefficients come back gathered on the first shard's
    device (None: where the frames lie)."""
    out = []
    for stripes in _blocks(_chunk_planes(frames), mesh, spatial,
                           16 if subsample else 8):
        coefs = []
        for r, g, b in stripes:
            c, f, ph, pw = r.shape
            cs = _planes_front_end(*(p.flatten(0, 1) for p in (r, g, b)),
                                   qy.to(r.device), qc.to(r.device), ph, pw,
                                   subsample=subsample)
            coefs.append(tuple(x.reshape(c, f, *x.shape[1:]) for x in cs))
        out.append(tuple(_gather_rows(p, 2) for p in zip(*coefs)))
    return tuple(_gather_rows(p, 0) for p in zip(*out))


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
    """The FVC chunk codec over C chunks, one dispatch per chunk shard
    (the counterpart of flutpu's ``fvc_chunks_sharded``): (C, F, H, W, 3)
    uint8 frames, or an (r, g, b) tuple of (C, F, H, W) planes,
    edge-padded to multiples of 16 (16 x stripes rows with ``spatial``).
    Each chunk is coded independently (frame 0 intra).

    Returns (ry, rcb, rcr) int16 (C, F, BH, BW, 64) residual planes; with
    ``motion`` also mvs (C, F, H/16, W/16, 2) int8 and itypes (C, F) int8;
    with ``bframes`` > 0 (motion only) instead (ry, rcb, rcr, fwd, bwd,
    modes, ftypes), as flutpu's. ``subpel`` (motion, no ``bframes``):
    half-pel vectors. ``subsample=False`` (version 1 only): 4:4:4.
    ``mesh``/``spatial``: as ``encode_chunks``; striped motion is the
    full integer search only (``hier``/``subpel``: flutpu's ValueError),
    its rows searched across stripes from halos, each chunk's frame type
    decided over all its stripes."""
    if bframes and (not motion or subpel):
        raise ValueError("bframes needs motion=True and does not "
                         "support subpel")
    _check_striped(spatial and motion, hier, subpel)
    if motion and not subsample:
        raise ValueError("motion mode requires 4:2:0")
    if not motion:
        return fvc_residuals_chunks(*encode_chunks(
            frames, qy, qc, mesh=mesh, spatial=spatial, subsample=subsample))
    out = []
    for stripes in _blocks(_chunk_planes(frames), mesh, spatial, 16):
        dev = stripes[0][0].device
        ph, pw = stripes[0][0].shape[-2:]
        striped = len(stripes) > 1
        block = stripes if striped else stripes[0]
        tabs = dict(qy=qy.to(dev), qc=qc.to(dev))
        if bframes:
            out.append(fvc_mc_encode_chunk_b(
                block, **tabs, pad_h=ph, pad_w=pw, search_range=search_range,
                bframes=bframes, hier=hier, qy_b=qy_b, qc_b=qc_b,
                striped=striped))
        else:
            out.append(fvc_mc_encode_chunk(
                block, **tabs, pad_h=ph, pad_w=pw, search_range=search_range,
                hier=hier, subpel=subpel, striped=striped))
    return tuple(_gather_rows(p, 0) for p in zip(*out))
