"""FVC — the GOP video codec on the GPU (port of flutpu/codec/fvc.py).

I + P (+ B) frames in one chunk, coded in the DCT domain with the JPEG
entropy stage. Version 1 codes each frame's quantized coefficients as a
residual against the accumulated previous ones (no motion). Version 2
(motion mode) runs the hybrid loop per frame: motion estimation against
the reconstructed reference (full search, or coarse-to-fine with
``hier``), motion-compensated prediction, DCT and quantization of the
pixel residual, and the in-loop reconstruction that the decoder mirrors.
A frame is coded intra (flat-128 prediction) when that leaves less luma
residual than the motion prediction, so a scene cut inside a chunk
becomes an I frame. With ``bframes`` (header flags bit 5) that loop runs
over the anchor frames only (every ``bframes + 1``-th and the last); each
frame between two anchors is a non-reference B frame, predicted per
macroblock from the previous reconstructed anchor, the next one, their
average or flat 128, and quantized at the ``bquality`` tables.

On a CUDA device version 1 runs the front-end kernel, an integer scan
and the Huffman pack kernel; version 2 runs a search kernel per frame
and reference (the full search, or the hier search's coarse-level and
refine kernels), the chroma compensation kernel, the in-loop DCT/IDCT
kernel (K9, ``ops/transform_kernels.py``: per 8x8 block, in the CPU's
summation order, so a block's coefficients and samples are the CPU's
bits whatever the batch, shard or stripe), and the pack kernel once per
chunk: the segment pack (K2), or with ``segmented=False`` the per-block
pack (K7, or K8a under ``FLUTPU_NO_FUSED_PACK=1``) and the block concat,
as the JPEG encoder's layouts; the chunk's bytes are the same. The
per-frame I/P and per-macroblock B mode decisions stay on the device.
The chunk's compressed words, its vectors (and B modes) and its
frame-type word come back in one copy into pinned memory.

Bitstream: byte-compatible with flutpu's (``MAGIC``, the header layout
and the per-frame records are copies). The in-loop DCT/IDCT is codec
state and its formulation travels in header flags bit 3: per 8x8 block
(bit clear, the port's default on every device) or, with the encoder's
``planar`` attribute, as products of whole planes with block-diagonal
DCT matrices (``ops/dct.plane_dct_planar``, flutpu's default on its
accelerator; here in a fixed order of fp32 operations, so a plane's
planar products do not depend on the device, the plane's height or the
batch). The decoder reconstructs through the one the header names, and
rebuilds a planar encoder's in-loop planes bit for bit, also where the
encoder ran on row stripes.

``engine="host"`` (flutpu's host entropy engine) runs the same codec on
the device, copies the residual coefficient planes (and the vectors and
frame types) back once, and codes the scans on the host with the native
coder; the bytes are the device engine's. It takes the array and the
source-fed entries (``encode_chunk_dispatch_src``, and the batch of
``encode_chunk_batch_dispatch_src`` in one codec call and one copy);
``encode_chunks_dispatch`` stays device-only. ``"auto"`` never leaves
the device.

C GOP chunks in one dispatch: ``encode_chunks_dispatch`` /
``encode_chunks_finalize`` (``cudahype``) run the same code with a
leading chunk axis; a chunk's bytes are those of its own dispatch.

Half-pel motion (``subpel``, header flags bit 2) refines K3's (K5's)
integer vectors with ``subpel_refine`` and predicts luma and chroma with
``motion_compensate_subpel``, plain PyTorch on the device (flutpu's XLA
programs). Version 1 also codes 4:4:4 (``subsample=False``, flags bit 0
clear) through the plain 4:4:4 front end. ``FvcDecoder`` reads every
chunk kind flutpu writes, and ``split_stream``/``decode_stream`` read
concatenated chunks.

Search ranges run to flutpu's limit, 126 (62 with ``subpel``): above 32
the search kernels stage their windows in bands (csrc/motion.cu).
``encode_chunk_batch_dispatch_src`` / ``encode_chunk_batch_finalize``
run ``batch`` chunks from the on-device source as one dispatch of the
chunk axis and one copy back. ``cudafvcenc bitrate=`` runs flutpu's
per-chunk quality controller.

Several shards and row stripes (``encode_chunks_dispatch(frames,
mesh)``, ``cudahype``): each chunk shard's block of chunks is one
dispatch on its device; with a ``ChunkSpatialMesh`` each frame is cut
into row stripes on the shard's stripe devices, which search from their
ring neighbours' halo rows (the anchor loop and the B pass), and a
chunk's I/P decision sums its stripes' SADs. The stripes' residuals are
gathered onto the shard's first device for the pack kernel and the one
copy back. A coded size beyond the minimum macroblock padding (the
frame padded to 16 x stripes rows) travels in header flags bit 4.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import Buffer, Caps, PropertySpec, register
from ..core.env import env_flag
from ..core.log import SPAN_PREFIX, trace_span
from .base import VideoEncoder
from .convert import encoder_state_from_numpy
from .decode import coefs_to_rgb, decode_scan_to_coefs
from .encoder import SCENE_NEW_EVENT_NAME
from .jpeg import JpegEncoder, _edge_pad, _HostCopy, _pad_to, \
    segmented_property
from .ops.colorspace import i420_to_rgb, planes_to_i420
from .ops.constants import on_device
from .ops.dct import (blockize, check_full_fp32, plane_dct, plane_dct_planar,
                      plane_idct, plane_idct_planar, unblockize)
from .ops.entropy import encode_gop_scans_layout
from .ops.motion import (MB, _mb_sums, motion_compensate,
                         motion_compensate_subpel, subpel_refine)
from .ops.motion_kernels import (chroma_mc, chroma_mc_striped,
                                motion_search_mc, motion_search_mc_dygrid,
                                motion_search_mc_hier,
                                motion_search_mc_striped)
from .ops.quant import (CHROMA_QTABLE, LUMA_QTABLE, dequantize,
                        dequantize_planar, quantize, quantize_planar,
                        scale_qtable, zigzag_flatten, zigzag_unflatten)

# copies of flutpu.codec.fvc's constants
MAGIC = b"FVC1"
VERSION = 1
_CLAMP = 1023  # keeps every residual within standard-table magnitude range


# ----------------------------------------------------------------------------
# device programs
# ----------------------------------------------------------------------------

def fvc_residuals(yq: torch.Tensor, cbq: torch.Tensor, crq: torch.Tensor):
    """Quantized coefficient planes (F, BH, BW, 64) → clamped residual
    planes (int16). The zero initial state makes frame 0 the I frame;
    each later frame codes against the accumulated reconstruction."""
    out = []
    for plane in (yq, cbq, crq):
        rec = torch.zeros(plane.shape[1:], dtype=torch.int32,
                          device=plane.device)
        res = []
        for f in range(plane.shape[0]):
            r = (plane[f].to(torch.int32) - rec).clamp(-_CLAMP, _CLAMP)
            rec = rec + r
            res.append(r.to(torch.int16))
        out.append(torch.stack(res))
    return tuple(out)


def fvc_accumulate(ry: torch.Tensor, rcb: torch.Tensor, rcr: torch.Tensor):
    """Decoder side: residual planes → absolute coefficient planes
    (cumulative sum over the frame axis)."""
    return tuple(torch.cumsum(r.to(torch.int32), dim=0)
                 for r in (ry, rcb, rcr))


def _quant_plane(resid: torch.Tensor, qtab: torch.Tensor,
                 planar: bool = False) -> torch.Tensor:
    """Pixel residual plane → clamped quantized coefficients: (BH, BW, 8,
    8) by the per-block DCT, or with ``planar`` (header flags bit 3) in
    plane layout (H, W) by the block-diagonal products."""
    if planar:
        coefs = quantize_planar(plane_dct_planar(resid), qtab)
    else:
        coefs = quantize(plane_dct(resid), qtab)
    return coefs.clamp(-_CLAMP, _CLAMP)


def _zigzagged(coefs: torch.Tensor, planar: bool = False) -> torch.Tensor:
    """``_quant_plane``'s coefficients → (BH, BW, 64) int16 zigzag."""
    return zigzag_flatten(blockize(coefs) if planar else coefs) \
        .to(torch.int16)


def _code_plane(resid: torch.Tensor, qtab: torch.Tensor,
                planar: bool = False):
    """Pixel residual plane → (zigzagged int16 coefficients, the
    reconstructed residual), through either formulation."""
    coefs = _quant_plane(resid, qtab, planar)
    if planar:
        rec = plane_idct_planar(dequantize_planar(coefs, qtab))
    else:
        rec = plane_idct(dequantize(coefs, qtab))
    return _zigzagged(coefs, planar), rec


def _planes(frames):
    """(r, g, b) channel planes or interleaved (..., H, W, 3) frames →
    the three channel planes."""
    if isinstance(frames, (tuple, list)):
        return tuple(frames)
    return frames[..., 0], frames[..., 1], frames[..., 2]


def _chunked(frames):
    """One chunk's frames ((r, g, b) planes (F, H, W) or interleaved (F,
    H, W, 3)) or C chunks' ((C, F, H, W) planes or (C, F, H, W, 3)) →
    (the frames with a leading chunk axis, whether it was added)."""
    if isinstance(frames, (tuple, list)):
        if frames[0].dim() == 3:
            return tuple(p[None] for p in frames), True
        return tuple(frames), False
    if frames.dim() == 4:
        return frames[None], True
    return frames, False


def _unchunked(parts, added: bool):
    return tuple(p[0] for p in parts) if added else tuple(parts)


def _i420_planes(frames, pad_h: int, pad_w: int):
    """(r, g, b) uint8 planes (..., H, W) or interleaved (..., H, W, 3)
    frames, edge-padded to (pad_h, pad_w) → float32 (Y, Cb, Cr) planes."""
    r, g, b = (_edge_pad(p, pad_h, pad_w) for p in _planes(frames))
    check_full_fp32(r.device)
    return planes_to_i420(r, g, b)


def _search_fn(hier: bool, dygrid: bool = False):
    """The search + luma prediction the motion loop runs: K5 for
    ``search=hier``, else K6b where the dy-grid arm is chosen, else K3."""
    if hier:
        return motion_search_mc_hier
    return motion_search_mc_dygrid if dygrid else motion_search_mc


def _stripe_search(search, cur, ref, r: int):
    """The search over a frame's stripe lists: one stripe searches alone,
    several through the rounded-halo route (``motion_search_mc_striped``)."""
    if len(cur) == 1:
        mv, pred = search(cur[0], ref[0], r)
        return [mv], [pred]
    return motion_search_mc_striped(cur, ref, r, search)


def _stripe_chroma(cb, cr, mv, r: int):
    """K4 over a frame's stripe lists (``chroma_mc_striped`` for
    several)."""
    if len(cb) == 1:
        pcb, pcr = chroma_mc(cb[0], cr[0], mv[0], r)
        return [pcb], [pcr]
    return chroma_mc_striped(cb, cr, mv, r)


def _stripe_total(parts):
    """Per-stripe (C,) float64 sums → their sum over the frame, added in
    stripe order on the first stripe's device (flutpu's ``psum``)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def _gather_rows(parts, dim: int):
    """Per-stripe (or per-shard) outputs → one tensor on the first part's
    device, concatenated along ``dim`` in order."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _anchor_loop(y, cb, cr, qy, qc, search, search_range: int,
                 subpel: bool = False, planar: bool = False):
    """The hybrid loop over (C, F, ...) planes: C GOP chunks side by side,
    frame 0 of each intra. Per frame step, for every chunk at once: the
    search against its reconstructed reference (one launch for all C),
    the chroma kernel, the device-side I/P decision of each chunk over
    its own plane, DCT + quantization of the pixel residual and the
    in-loop reconstruction. With ``subpel`` the search's integer vectors
    are refined to half-pel (``subpel_refine``, plain PyTorch over the C
    planes) and both predictions are bilinear
    (``motion_compensate_subpel``): the search's own prediction is
    discarded and the chroma kernel, whose contract is integer vectors,
    is not launched. ``planar``: the in-loop DCT/IDCT of header flags bit
    3 (``_code_plane``).

    ``y``, ``cb``, ``cr`` are lists of row stripes of the frames, in ring
    order, each on its shard's device (one stripe: the whole frame).
    Several stripes search and compensate through the rounded-halo route
    from their ring neighbours' reconstructed rows, and each chunk's I/P
    decision sums the stripes' float64 SADs in stripe order, so every
    stripe decides alike. Returns per stripe (ry, rcb, rcr) (C, F, BH,
    BW, 64) int16 zigzagged residual coefficients and mvs (C, F, H/16,
    W/16, 2) int8 (half-pel units with ``subpel``), the itypes (C, F) int8
    (1 = intra) on the first stripe's device, and each frame's
    reconstructed per-stripe (C, ...) planes."""
    c, f = y[0].shape[:2]
    devs = [p.device for p in y]
    # frame-major: a frame step of all chunks is one contiguous (C, H, W)
    # block, as the kernels read it (no copy where C is 1)
    y, cb, cr = ([p.transpose(0, 1).contiguous() for p in planes]
                 for planes in (y, cb, cr))
    qys, qcs = [qy.to(d) for d in devs], [qc.to(d) for d in devs]
    no_mv = [torch.zeros((c, p.shape[-2] // MB, p.shape[-1] // MB, 2),
                         dtype=torch.int32, device=p.device) for p in y]
    outs, mvs, itypes, recs = [], [], [], []
    rec_y = rec_cb = rec_cr = None
    for i in range(f):
        cy, ccb, ccr = ([p[i] for p in planes] for planes in (y, cb, cr))
        if i == 0:   # each chunk starts on an I frame: no search to run
            is_i = [torch.ones((c,), dtype=torch.bool, device=d)
                    for d in devs]
            mv = no_mv
            pred_y = pred_cb = pred_cr = [128.0] * len(devs)
        else:
            mv, pred_p_y = _stripe_search(search, cy, rec_y, search_range)
            if subpel:
                mv = [subpel_refine(cy[0], rec_y[0], mv[0])]
                pred_p_y = [motion_compensate_subpel(rec_y[0], mv[0])]
            # the in-codec scene-cut detector, per chunk: intra when flat
            # 128 leaves less luma residual than the motion prediction
            # (sums in float64, so the CPU and the card decide alike)
            sad_p = _stripe_total([
                (a - b).abs().sum(dim=(1, 2), dtype=torch.float64)
                for a, b in zip(cy, pred_p_y)])
            sad_i = _stripe_total([
                (a - 128.0).abs().sum(dim=(1, 2), dtype=torch.float64)
                for a in cy])
            is_i = [(sad_i < sad_p).to(d) for d in devs]
            intra = [t[:, None, None] for t in is_i]
            mv = [torch.where(t[..., None], z, m)
                  for t, z, m in zip(intra, no_mv, mv)]
            if subpel:
                pcb = [motion_compensate_subpel(rec_cb[0], mv[0], mb=8)]
                pcr = [motion_compensate_subpel(rec_cr[0], mv[0], mb=8)]
            else:
                pcb, pcr = _stripe_chroma(rec_cb, rec_cr, mv, search_range)
            pred_y = [torch.where(t, 128.0, p) for t, p in zip(intra,
                                                               pred_p_y)]
            pred_cb = [torch.where(t, 128.0, p) for t, p in zip(intra, pcb)]
            pred_cr = [torch.where(t, 128.0, p) for t, p in zip(intra, pcr)]
        step_out, rec_y, rec_cb, rec_cr = [], [], [], []
        for s in range(len(devs)):
            oy, ry_rec = _code_plane(cy[s] - pred_y[s], qys[s], planar)
            ocb, rcb_rec = _code_plane(ccb[s] - pred_cb[s], qcs[s], planar)
            ocr, rcr_rec = _code_plane(ccr[s] - pred_cr[s], qcs[s], planar)
            rec_y.append((pred_y[s] + ry_rec).clamp(0.0, 255.0))
            rec_cb.append((pred_cb[s] + rcb_rec).clamp(0.0, 255.0))
            rec_cr.append((pred_cr[s] + rcr_rec).clamp(0.0, 255.0))
            step_out.append((oy, ocb, ocr, mv[s].to(torch.int8)))
        outs.append(step_out)
        itypes.append(is_i[0].to(torch.int8))
        recs.append((rec_y, rec_cb, rec_cr))
    per_stripe = [tuple(torch.stack(p, dim=1) for p in zip(*(o[s]
                                                           for o in outs)))
                  for s in range(len(devs))]
    return per_stripe, torch.stack(itypes, dim=1), recs


def _stripes_in(frames, pad_h: int, pad_w: int, striped: bool):
    """The codec's input → (per-stripe float32 (Y, Cb, Cr) planes with a
    chunk axis, whether the chunk axis was added). ``striped``: ``frames``
    is a list of row stripes' frames, each on its shard's device."""
    parts = list(frames) if striped else [frames]
    ys, cbs, crs, added = [], [], [], False
    for part in parts:
        part, added = _chunked(part)
        y, cb, cr = _i420_planes(part, pad_h, pad_w)
        ys.append(y)
        cbs.append(cb)
        crs.append(cr)
    return ys, cbs, crs, added


def _check_striped(striped: bool, hier: bool, subpel: bool = False) -> None:
    if striped and (hier or subpel):
        raise ValueError("spatial sharding supports full-search "
                         "integer-pel motion only")


def fvc_mc_encode_chunk(frames, qy: torch.Tensor, qc: torch.Tensor,
                        pad_h: int, pad_w: int, search_range: int = 7,
                        hier: bool = False, subpel: bool = False,
                        planar: Optional[bool] = False,
                        striped: bool = False):
    """Motion-compensated chunk encode (FVC v2, P frames only): the hybrid
    loop (``_anchor_loop``) over every frame, with the full search (K3;
    K6b under ``FLUTPU_SEARCH_DYGRID=1``, as flutpu selects it) or, with
    ``hier``, the coarse-to-fine search (K5); with ``subpel`` the
    search's vectors refined to half-pel and bilinear predictions.
    ``frames``: (r, g, b) uint8 planes (F, H, W) or interleaved (F, H, W,
    3), edge-padded here to (pad_h, pad_w); or C chunks' ((C, F, H, W)
    planes, (C, F, H, W, 3)), encoded side by side. ``striped``:
    ``frames`` is a list of the frames' row stripes in ring order, each
    on its shard's device and (pad_h, pad_w) the stripe's coded size
    (flutpu's ``spatial_axis``); the outputs are gathered onto the first
    stripe's device, equal to the unstriped encode's. Not with ``hier``
    or ``subpel`` (flutpu's ValueError). ``planar``: the in-loop DCT/IDCT
    as block-diagonal products (header flags bit 3; None takes the
    port's per-block default, which flutpu's is on its CPU).

    Returns (ry, rcb, rcr) int16 zigzagged residual coefficients,
    mvs ([C,] F, H/16, W/16, 2) int8 (half-pel units with ``subpel``) and
    itypes ([C,] F) int8 (1 = intra)."""
    _check_striped(striped, hier, subpel)
    y, cb, cr, added = _stripes_in(frames, pad_h, pad_w, striped)
    search = _search_fn(hier, env_flag("FLUTPU_SEARCH_DYGRID", False))
    per_stripe, itypes, _ = _anchor_loop(y, cb, cr, qy, qc, search,
                                         search_range, subpel, bool(planar))
    parts = [_gather_rows(p, 2) for p in zip(*per_stripe)]
    return _unchunked((*parts, itypes), added)


def _bframe_structure(f: int, bframes: int):
    """Static anchor/B index maps for an ``f``-frame chunk (a copy of
    flutpu.codec.fvc._bframe_structure).

    Returns (anchor_idx, b_idx, prev_map, next_map): display indices of
    anchors and B frames, and for each B frame the position IN THE ANCHOR
    ARRAY of its previous/next reference."""
    s = bframes + 1
    anchor_idx = list(range(0, f, s))
    if anchor_idx[-1] != f - 1:
        anchor_idx.append(f - 1)
    aset = set(anchor_idx)
    b_idx = [i for i in range(f) if i not in aset]
    prev_map, next_map = [], []
    for j in b_idx:
        k = max(p for p, a in enumerate(anchor_idx) if a < j)
        prev_map.append(k)
        next_map.append(k + 1)
    return anchor_idx, b_idx, prev_map, next_map


def _select_mode(mode_px: torch.Tensor, bi, fwd, bwd) -> torch.Tensor:
    """Per-pixel prediction of a B frame: bi / fwd / bwd / flat 128 for
    mode 0 / 1 / 2 / 3."""
    return torch.where(mode_px == 0, bi, torch.where(
        mode_px == 1, fwd, torch.where(mode_px == 2, bwd, 128.0)))


def _repeat_blocks(a: torch.Tensor, n: int) -> torch.Tensor:
    """(..., BH, BW) → (..., BH * n, BW * n), each value over an n x n
    block."""
    return a.repeat_interleave(n, -2).repeat_interleave(n, -1)


def fvc_mc_encode_chunk_b(frames, qy: torch.Tensor, qc: torch.Tensor,
                          pad_h: int, pad_w: int, search_range: int = 7,
                          bframes: int = 1, hier: bool = False,
                          planar: Optional[bool] = False,
                          qy_b: Optional[torch.Tensor] = None,
                          qc_b: Optional[torch.Tensor] = None,
                          striped: bool = False):
    """Bidirectional chunk encode (FVC v2 + flags bit 5). The anchor
    frames (every ``bframes + 1``-th, plus the last) run the hybrid loop;
    then each B frame runs the search (K3, or K5 with ``hier``) against
    its previous and its next reconstructed anchor, and per macroblock
    takes the least-SAD of four predictions (0 = their average, 1 =
    forward, 2 = backward, 3 = flat 128; ties to the lower mode). B frames
    are non-reference: their residuals are quantized at ``qy_b``/``qc_b``
    (default: the anchor tables) and never reconstructed. Chroma is
    compensated with both vectors before the unused ones are zeroed.

    ``frames``: one chunk's, or C chunks' with a leading chunk axis (as
    ``fvc_mc_encode_chunk``): every step below then covers all C chunks
    at once, each chunk's searches, costs and modes its own. ``striped``
    (as ``fvc_mc_encode_chunk``; not with ``hier``): the anchor loop and
    the B pass run on row stripes with halos from their ring neighbours;
    a B macroblock's mode stays stripe-local (stripes are whole
    macroblock rows), as in flutpu. ``planar``: as
    ``fvc_mc_encode_chunk``'s, for the anchors and the B residuals.

    Returns, in display order: (ry, rcb, rcr) int16 zigzagged residual
    coefficients; fwd and bwd ([C,] F, H/16, W/16, 2) int8 (anchor P
    vectors in fwd; zero where a B macroblock does not use them); modes
    ([C,] F, H/16, W/16) int8 (zero for anchors); ftypes ([C,] F) int8 (0
    = P anchor, 1 = I anchor, 2 = B)."""
    _check_striped(striped, hier)
    planar = bool(planar)
    qy_b = qy if qy_b is None else qy_b
    qc_b = qc if qc_b is None else qc_b
    y, cb, cr, added = _stripes_in(frames, pad_h, pad_w, striped)
    search = _search_fn(hier)
    r = search_range
    anchor_idx, b_idx, prev_map, next_map = _bframe_structure(y[0].shape[1],
                                                              bframes)
    a_stripes, ais_i, recs = _anchor_loop(
        [p[:, anchor_idx] for p in y], [p[:, anchor_idx] for p in cb],
        [p[:, anchor_idx] for p in cr], qy, qc, search, r, planar=planar)
    if not b_idx:
        parts = [_gather_rows(p, 2) for p in zip(*a_stripes)]
        return _unchunked((*parts, torch.zeros_like(parts[3]),
                           torch.zeros_like(parts[3][..., 0]), ais_i), added)

    qybs = [qy_b.to(p.device) for p in y]
    qcbs = [qc_b.to(p.device) for p in y]
    outs = []
    for j, p, n in zip(b_idx, prev_map, next_map):
        cy, ccb, ccr = ([q[:, j] for q in planes] for planes in (y, cb, cr))
        (py, pcb, pcr), (ny, ncb, ncr) = recs[p], recs[n]
        fwd, pred_f = _stripe_search(search, cy, py, r)
        bwd, pred_b = _stripe_search(search, cy, ny, r)
        fcb, fcr = _stripe_chroma(pcb, pcr, fwd, r)
        bcb, bcr = _stripe_chroma(ncb, ncr, bwd, r)
        step = []
        for s in range(len(y)):
            pred_bi = (pred_f[s] + pred_b[s]) * 0.5
            # first minimum on the CPU and on CUDA alike: ties go to mode 0
            mode = torch.argmin(torch.stack([
                _mb_sums((cy[s] - pred_bi).abs(), MB),
                _mb_sums((cy[s] - pred_f[s]).abs(), MB),
                _mb_sums((cy[s] - pred_b[s]).abs(), MB),
                _mb_sums((cy[s] - 128.0).abs(), MB)]), dim=0)
            mode_y, mode_c = _repeat_blocks(mode, MB), _repeat_blocks(mode, 8)
            pred_y = _select_mode(mode_y, pred_bi, pred_f[s], pred_b[s])
            pred_cb = _select_mode(mode_c, (fcb[s] + bcb[s]) * 0.5, fcb[s],
                                   bcb[s])
            pred_cr = _select_mode(mode_c, (fcr[s] + bcr[s]) * 0.5, fcr[s],
                                   bcr[s])
            coefs = [_zigzagged(_quant_plane(c - pr, q, planar), planar)
                     for c, pr, q in ((cy[s], pred_y, qybs[s]),
                                      (ccb[s], pred_cb, qcbs[s]),
                                      (ccr[s], pred_cr, qcbs[s]))]
            # zero unused vectors: smaller zlib'd fields, and the decode
            # never reads them
            use_f = ((mode == 0) | (mode == 1))[..., None]
            use_b = ((mode == 0) | (mode == 2))[..., None]
            step.append((*coefs, torch.where(use_f, fwd[s], 0).to(torch.int8),
                         torch.where(use_b, bwd[s], 0).to(torch.int8),
                         mode.to(torch.int8)))
        outs.append(step)
    # per field: the stripes gathered onto the first stripe's device
    ary, arcb, arcr, amv = (_gather_rows(p, 2) for p in zip(*a_stripes))
    boy, bocb, bocr, bfwd, bbwd, bmode = (
        _gather_rows([torch.stack([o[s][k] for o in outs], dim=1)
                      for s in range(len(y))], 2) for k in range(6))
    zero_mv = torch.zeros_like(amv)
    zero_mode = torch.zeros_like(amv[..., 0])
    # interleave back to display order
    dev = ary.device
    order = tuple(anchor_idx + b_idx)
    perm = on_device(("display_order", order), np.argsort(order), dev,
                     torch.long)

    def cat(a, b):
        return torch.cat([a, b], dim=1)[:, perm]

    btypes = torch.full((ary.shape[0], len(b_idx)), 2, dtype=torch.int8,
                        device=dev)
    return _unchunked((cat(ary, boy), cat(arcb, bocb), cat(arcr, bocr),
                       cat(amv, bfwd), cat(zero_mv, bbwd),
                       cat(zero_mode, bmode), cat(ais_i, btypes)), added)


def fvc_residuals_chunks(yq: torch.Tensor, cbq: torch.Tensor,
                         crq: torch.Tensor):
    """``fvc_residuals`` of C chunks at once: (C, F, BH, BW, 64) quantized
    coefficient planes → (C, F, ...) int16 residual planes, each chunk's
    chain its own (frame 0 of every chunk is its I frame)."""
    out = fvc_residuals(*(p.transpose(0, 1) for p in (yq, cbq, crq)))
    return tuple(p.transpose(0, 1) for p in out)


def _combined_rows(parts, layout, prefix_words, seg_g, seg_words):
    """The chunk codec's output for C chunks of F frames (``fvc_chunks``:
    (ry, rcb, rcr), and with motion the vectors (or fwd, bwd and modes)
    and the frame types) → one (C * F, X) int32 array, a row per frame
    in chunk order, so one copy brings back every chunk: the frame's
    scan words (``encode_gop_scans_layout``: the segment layout, or the
    non-segment one where ``seg_words`` is None), then with motion its
    int8 side columns packed four to a word and its frame-type word (0
    P, 1 I, 2 B)."""
    c, f = parts[0].shape[:2]
    ry, rcb, rcr = (p.flatten(0, 1) for p in parts[:3])
    combined = encode_gop_scans_layout(ry, rcb, rcr, layout, prefix_words,
                                       seg_g, seg_words)
    if len(parts) == 3:
        return combined
    side = torch.cat([p.reshape(c * f, -1) for p in parts[3:-1]], dim=1)
    pad = (-side.shape[1]) % 4
    if pad:
        side = torch.nn.functional.pad(side, (0, pad))
    side_words = side.contiguous().view(torch.int32)   # little-endian bytes
    itypes = parts[-1].reshape(c * f).to(torch.int32)
    return torch.cat([combined, side_words, itypes[:, None]], dim=1)


# ----------------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------------

def _table_quality(qy, qc) -> int:
    """The quality whose scaled tables are (qy, qc): the FVC header
    carries a quality, not tables."""
    qy, qc = np.asarray(qy), np.asarray(qc)
    for q in range(1, 101):
        if (np.array_equal(scale_qtable(LUMA_QTABLE, q), qy)
                and np.array_equal(scale_qtable(CHROMA_QTABLE, q), qc)):
            return q
    raise ValueError("the quant tables are not those of any quality 1..100")


class _HostChunkHandle(NamedTuple):
    """A dispatch of the host engine: the codec's outputs (residual planes,
    and with motion the vectors or fwd, bwd and modes, and the frame
    types) on their way into pinned memory."""
    parts: _HostCopy
    f: int
    h: int
    w: int
    ph: int
    pw: int


class _ChunkHandle(NamedTuple):
    combined: _HostCopy
    prefix: int
    prefix_bound: int         # theoretical words/frame of this geometry
    n_segs: int               # 0: the non-segment layout
    seg_words: Optional[int]  # None: the non-segment layout
    build: Optional[object]   # None once a redispatch was made
    f: int
    h: int
    w: int
    ph: int
    pw: int


class FvcEncoder:
    """Encode GOP chunks of RGB frames into FVC bitstream chunks on one
    device. ``motion=True`` selects the v2 hybrid codec; ``hier`` its
    coarse-to-fine search; ``subpel`` half-pel vectors (header flags bit
    2; search range at most 62); ``bframes`` (1..7, motion only, not with
    ``subpel``) the number of B frames between anchors, quantized at
    ``bquality`` (default ``max(10, quality - 8)``). ``subsample=False``
    codes version 1 chunks in 4:4:4 (flags bit 0 clear); motion needs
    4:2:0. ``device`` is where the encode runs: a
    CUDA device launches the kernels; ``"cpu"`` runs their plain PyTorch
    versions. The bitstream layout of the entropy stage (``segmented``)
    and its sizing (compressed-prefix window, segment staging, overflow
    redispatch) are the port's JpegEncoder's, as in flutpu. ``engine``:
    ``"auto"`` or ``"device"`` code the scans on the device; ``"host"``
    runs the codec on the device and the native scan coder on the host
    (``encode_chunk`` and ``encode_chunk_dispatch`` only, as flutpu's
    host route; the source-fed, batched and multi-chunk dispatches raise
    ValueError). The attribute ``planar`` (default False, on every
    device) selects the in-loop DCT of header flags bit 3."""

    #: the in-loop DCT/IDCT as block-diagonal products (header flags bit
    #: 3); the per-block formulation where False
    planar = False

    def __init__(self, quality: int = 85, subsample: bool = True,
                 motion: bool = False, search_range: int = 7, *,
                 engine: str = "auto", hier: bool = False,
                 subpel: bool = False, segmented: Optional[bool] = None,
                 bframes: int = 0, bquality: Optional[int] = None,
                 device="cuda"):
        # flutpu's checks, in its order
        if bframes:
            if not motion:
                raise ValueError("bframes requires motion=True")
            if subpel:
                raise ValueError("bframes does not support subpel")
            if not 0 < bframes <= 7:
                raise ValueError("bframes must be in 0..7")
        self.bframes = int(bframes)
        self.bquality = None
        if bframes:
            self.bquality = int(bquality) if bquality is not None \
                else max(10, quality - 8)
            if not 1 <= self.bquality <= 100:
                raise ValueError("bquality must be in 1..100")
        if motion and not subsample:
            raise ValueError("motion mode requires 4:2:0")
        # half-pel vectors reach ±(2 * search_range + 1): int8 bounds the
        # range at 62 (flutpu's limit)
        limit = 62 if subpel else 126
        if not 0 < search_range <= limit:
            raise ValueError(
                f"search_range must be in 1..{limit} "
                f"(subpel={subpel}; vectors are int8 in the bitstream)")
        self.quality = quality
        self.subsample = bool(subsample)
        self.motion = bool(motion)
        self.hier = bool(hier)
        self.subpel = bool(subpel)
        self.search_range = int(search_range)
        self.device = torch.device(device)
        # shared scan coder: its tables, engine, sizing policy and
        # overflow bounds (it refuses an unknown engine)
        self._scan_coder = JpegEncoder(quality, subsample=subsample,
                                       engine=engine, segmented=segmented,
                                       device=self.device)
        self.engine = engine
        self.qy, self.qc = self._scan_coder.qy, self._scan_coder.qc
        self._qyb_dev = self._qcb_dev = None
        if self.bquality is not None:
            self._qyb_dev, self._qcb_dev = (
                torch.as_tensor(scale_qtable(t, self.bquality)
                                .astype(np.int32), device=self.device)
                for t in (LUMA_QTABLE, CHROMA_QTABLE))

    @classmethod
    def from_numpy_state(cls, qy, qc, search_range: int = 7, *,
                         motion: bool = False, hier: bool = False,
                         subpel: bool = False, subsample: bool = True,
                         bframes: int = 0, bquality: Optional[int] = None,
                         seg_words: Optional[int] = None,
                         prefix_window: Optional[int] = None,
                         segmented: Optional[bool] = None,
                         engine: str = "auto",
                         device="cuda") -> "FvcEncoder":
        """An encoder with given quantization tables and adaptive sizes
        (e.g. flutpu's ``qy``, ``qc``, ``search_range``, ``hier``,
        ``subpel``, ``subsample``, ``bframes``, ``bquality`` and its scan
        coder's ``_seg_words``,
        ``_prefix_window``). The tables must be a quality's: the chunk
        header carries the quality."""
        enc = cls(_table_quality(qy, qc), subsample=subsample, motion=motion,
                  search_range=search_range, hier=hier, subpel=subpel,
                  segmented=segmented, bframes=bframes, bquality=bquality,
                  engine=engine, device=device)
        enc._scan_coder._set_state(encoder_state_from_numpy(
            qy, qc, seg_words=seg_words, prefix_window=prefix_window,
            device=enc.device))
        return enc

    # -- dispatch / finalize ------------------------------------------------
    def _codec(self, frames, mesh=None, spatial: bool = False):
        """The chunk codec of either engine (``fvc_chunks``) over C chunks'
        frames: the residual planes, and with motion the vectors (or fwd,
        bwd and modes) and the frame types, each with a leading chunk
        axis."""
        from ..parallel.gop import fvc_chunks
        sc = self._scan_coder
        return fvc_chunks(
            frames, sc._qy_dev, sc._qc_dev, mesh=mesh, motion=self.motion,
            search_range=self.search_range, hier=self.hier,
            subpel=self.subpel, spatial=spatial, bframes=self.bframes,
            qy_b=self._qyb_dev, qc_b=self._qcb_dev, subsample=self.subsample,
            planar=self.planar)

    def _dispatch(self, frames_fn, f: int, h: int, w: int,
                  shard=None) -> _ChunkHandle:
        """Enqueue ``frames_fn()``'s chunks (one chunk's frames, or C
        chunks' with a leading chunk axis) through ``fvc_chunks`` and the
        entropy stage, one row per frame in chunk order. ``shard``: the
        devices of one chunk shard's row stripes (None: the frames'
        device, unstriped); the pack and the copy run on the first."""
        from ..parallel.mesh import ChunkMesh, ChunkSpatialMesh
        sc = self._scan_coder
        n_sp = 1 if shard is None else len(shard)
        ph, pw = _pad_to(h, sc.mult * n_sp), _pad_to(w, sc.mult)
        mesh = None
        if shard is not None:
            mesh = ChunkSpatialMesh(1, n_sp, shard) if n_sp > 1 \
                else ChunkMesh(shard)

        def program(layout, prefix_words, seg_words):
            with trace_span(SPAN_PREFIX + "fvc.codec"):
                parts = self._codec(_chunked(frames_fn())[0], mesh, n_sp > 1)
            with trace_span(SPAN_PREFIX + "jpeg.pack"):
                return _combined_rows(parts, layout, prefix_words, sc.SEG_G,
                                      seg_words)

        return _ChunkHandle(*sc._run_sized(program, ph, pw), f, h, w, ph,
                            pw)

    def _host_dispatch(self, frames, f: int, h: int, w: int):
        """The host engine's device half (flutpu's ``_encode_host`` up to
        its fetch): the device engine's codec on the frames' device (one
        chunk's frames, or C chunks' with a leading chunk axis), then one
        copy of its outputs into pinned memory in place of the entropy
        stage."""
        mult = self._scan_coder.mult
        parts = self._codec(_chunked(frames)[0])
        return _HostChunkHandle(_HostCopy(*parts), f, h, w,
                                _pad_to(h, mult), _pad_to(w, mult))

    def _finalize_host(self, handle: _HostChunkHandle) -> List[bytes]:
        """The host engine's host half: the scans of every chunk's frames
        by the native coder (``JpegEncoder._scans_host``), then each
        chunk's container, in chunk order."""
        arrs = [a.reshape(-1, *a.shape[2:]) for a in handle.parts.arrays()]
        payloads = self._scan_coder._scans_host(arrs[:3])
        mvs = itypes = None
        if self.motion and self.bframes:
            fwd, bwd, modes, ftypes = arrs[3:]
            mvs = list(zip(fwd, bwd, modes))
            itypes = ftypes.astype(np.int64)
        elif self.motion:
            mvs, itypes = list(arrs[3]), arrs[4].astype(np.int64)
        f = handle.f
        return [self._build_chunk(
            payloads[i:i + f], None if mvs is None else mvs[i:i + f],
            None if itypes is None else itypes[i:i + f], f, handle.h,
            handle.w, handle.ph, handle.pw)
            for i in range(0, len(payloads), f)]

    def _device_only(self, entry: str) -> None:
        """Raise for an entry point without a host route: the multi-chunk
        dispatch, which exists only in the port (flutpu's
        ``fvc_chunks_sharded`` takes no engine); never code such a call on
        the device for an encoder asked for the host."""
        if self.engine == "host":
            raise ValueError(f"FvcEncoder.{entry}: engine='host' has no "
                             "route here; use encode_chunk,"
                             " encode_chunk_dispatch or the source-fed "
                             "entries, or engine='device'")

    def encode_chunk_dispatch(self, frames):
        """Enqueue the encode of (F, H, W, 3) uint8 RGB frames (numpy or
        tensor) on the encoder's device. Non-blocking on a CUDA device;
        returns a handle for ``encode_chunk_finalize``."""
        t = torch.as_tensor(np.ascontiguousarray(frames)
                            if isinstance(frames, np.ndarray) else frames)
        t = t.to(self.device)
        f, h, w, _ = t.shape
        if self.engine == "host":
            return self._host_dispatch(t, f, h, w)
        return self._dispatch(lambda: t, f, h, w)

    def encode_chunks_dispatch(self, frames, mesh=None):
        """Enqueue C GOP chunks of (C, F, H, W, 3) uint8 RGB frames (numpy
        or tensor) as ONE dispatch: each chunk an independent chunk
        (frame 0 intra), every frame step of the motion loop one launch
        per kernel for all C, one entropy pack over the C * F frames and
        one copy back. Returns a handle for ``encode_chunks_finalize``.

        ``mesh`` (a ``ChunkMesh`` or ``ChunkSpatialMesh``; None: the
        encoder's device): shard m takes the m-th contiguous block of C /
        M chunks as one dispatch on its devices (M does not divide C:
        ValueError), its frames cut into the mesh's row stripes; the
        handle is the list of the blocks' handles."""
        self._device_only("encode_chunks_dispatch")
        t = torch.as_tensor(np.ascontiguousarray(frames)
                            if isinstance(frames, np.ndarray) else frames)
        c, f, h, w, _ = t.shape
        if mesh is None:
            t = t.to(self.device)
            return self._dispatch(lambda: t, f, h, w)
        from ..parallel.gop import chunk_blocks
        return [self._dispatch(lambda b=t[sl].to(shard[0]): b, f, h, w,
                               shard)
                for sl, shard in chunk_blocks(c, mesh, spatial=True)]

    def encode_chunk_dispatch_src(self, src_fn, start, n: int, h: int,
                                  w: int) -> _ChunkHandle:
        """encode_chunk_dispatch with an on-device frame source:
        ``src_fn(ph, pw, n, start)`` returns (r, g, b) uint8 planes, each
        (n, ph, pw), or interleaved (n, ph, pw, 3) frames, at the coded
        size (h, w rounded up to 16, or to 8 for 4:4:4). The host engine
        codes the source's frames through its own route, with the device
        engine's bytes (flutpu's gives them too)."""
        mult = self._scan_coder.mult
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        if self.engine == "host":
            return self._host_dispatch(src_fn(ph, pw, n, start), n, h, w)
        return self._dispatch(lambda: src_fn(ph, pw, n, start), n, h, w)

    def encode_chunk_batch_dispatch_src(self, src_fn, start, n: int, h: int,
                                        w: int, batch: int = 2
                                        ) -> _ChunkHandle:
        """``batch`` chunks of ``n`` frames from the on-device source as ONE
        dispatch and ONE copy back: chunk b's frames are ``src_fn(ph, pw,
        n, start + b * n)`` (as flutpu's
        ``_fvc_gop_program_batched_src``), stacked on the chunk axis of
        ``encode_chunks_dispatch``. Each chunk is independent (frame 0
        intra): its bytes are those of its own
        ``encode_chunk_dispatch_src``, on the CPU and on the card. The
        host engine runs the batch as one codec call and one copy, and
        codes the scans on the host. Finalize with
        ``encode_chunk_batch_finalize``."""
        mult = self._scan_coder.mult
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)

        def frames():
            outs = [src_fn(ph, pw, n, start + b * n) for b in range(batch)]
            if isinstance(outs[0], (tuple, list)):
                return tuple(torch.stack(p) for p in zip(*outs))
            return torch.stack(outs)

        if self.engine == "host":
            return self._host_dispatch(frames(), n, h, w)
        return self._dispatch(frames, n, h, w)

    def encode_chunk_batch_finalize(self, handle) -> List[bytes]:
        """Blocking half of ``encode_chunk_batch_dispatch_src``: the one
        copy, then each chunk's container, in chunk order (for the host
        engine, after its scans are coded on the host)."""
        if isinstance(handle, _HostChunkHandle):
            return self._finalize_host(handle)
        return self.encode_chunks_finalize(handle)

    def encode_chunk_finalize(self, handle) -> bytes:
        """Blocking half: wait for the copy, check the sizes (redispatch
        once on overflow), compact the scans, assemble the chunk; for the
        host engine, code the scans on the host."""
        if isinstance(handle, _HostChunkHandle):
            return self._finalize_host(handle)[0]
        return self.encode_chunks_finalize(handle)[0]

    def encode_chunks_finalize(self, handle: _ChunkHandle,
                               counts=None) -> List[bytes]:
        """``encode_chunk_finalize`` of a dispatch of C chunks → C chunk
        containers in chunk order. ``counts[i]`` keeps the first frames of
        chunk i alone (default: all F); the P chain is causal, so they
        are the bytes of an encode of those frames alone (a truncated B
        structure is not: re-encode such a tail). A mesh dispatch's list
        of handles finalizes block by block, in chunk order."""
        if isinstance(handle, list):
            out = []
            for hd in handle:
                n = hd.combined.bufs[0].shape[0] // hd.f
                out += self.encode_chunks_finalize(
                    hd, None if counts is None else counts[len(out):
                                                           len(out) + n])
            return out
        payloads, mvs, itypes = self._finalize(handle)
        f = handle.f
        out = []
        with trace_span(SPAN_PREFIX + "fvc.container"):
            for ci in range(len(payloads) // f):
                n = f if counts is None else int(counts[ci])
                rows = slice(ci * f, ci * f + n)
                out.append(self._build_chunk(
                    payloads[rows], None if mvs is None else mvs[rows],
                    None if itypes is None else itypes[rows], n, handle.h,
                    handle.w, handle.ph, handle.pw))
        return out

    def encode_chunk(self, frames) -> bytes:
        """(F, H, W, 3) uint8 → one FVC chunk (frame 0 is the I frame)."""
        return self.encode_chunk_finalize(self.encode_chunk_dispatch(frames))

    def _finalize(self, handle: _ChunkHandle):
        """Per frame, segments: [0] = aligned words, [1..S] = segment
        bits, [S+1..S+prefix] = word-aligned stream; blocks (S = 0): [0] =
        bits, [1..prefix] = the stream. Then (motion) the side words
        (vectors, or fwd | bwd | modes with B frames) and the frame-type
        word."""
        arr, handle = self._scan_coder._fetch(handle)
        n = handle.n_segs
        scan_end = 1 + n + handle.prefix
        with trace_span(SPAN_PREFIX + "jpeg.compact"):
            payloads = [JpegEncoder._scan_bytes(row, n, handle.prefix)
                        for row in arr]
        mvs = itypes = None
        if self.motion:
            with trace_span(SPAN_PREFIX + "fvc.vectors"):
                mvs, itypes = self._side_words(arr, scan_end, handle)
        return payloads, mvs, itypes

    def _side_words(self, arr, scan_end: int, handle: _ChunkHandle):
        """Each frame's vectors (fwd, or with B frames (fwd, bwd, modes))
        and the frame-type words from the combined rows' side columns."""
        mbh, mbw = handle.ph // 16, handle.pw // 16
        mv_len = mbh * mbw * 2
        mvs = []
        for i in range(arr.shape[0]):
            raw = np.frombuffer(arr[i, scan_end:-1].tobytes(), np.int8)
            fwd = raw[:mv_len].reshape(mbh, mbw, 2)
            if self.bframes:   # side columns: fwd | bwd | modes
                mvs.append((fwd,
                            raw[mv_len:2 * mv_len].reshape(mbh, mbw, 2),
                            raw[2 * mv_len:2 * mv_len + mbh * mbw]
                            .reshape(mbh, mbw)))
            else:
                mvs.append(fwd)
        return mvs, arr[:, -1].astype(np.int64)   # 1 = I frame, 2 = B

    def _build_chunk(self, payloads, mvs, itypes, f: int, h: int,
                     w: int, ph: Optional[int] = None,
                     pw: Optional[int] = None) -> bytes:
        """Container assembly (flutpu's ``_build_chunk``, and ``tpuhype``'s
        coded-size extension: header flags bit 4 and ``>HH`` (pw, ph)
        after the search-range byte where the coded size (ph, pw) exceeds
        the minimum macroblock padding; None: that padding)."""
        version = 2 if self.motion else VERSION
        mult = self._scan_coder.mult
        ph = _pad_to(h, mult) if ph is None else ph
        pw = _pad_to(w, mult) if pw is None else pw
        coded_ext = (ph, pw) != (_pad_to(h, mult), _pad_to(w, mult))
        flags = 1 if self.subsample else 0
        if self.motion:
            flags |= 2                 # vectors are zlib-compressed
            if self.subpel:
                flags |= 4             # vectors are in half-pel units
            if self.planar:
                flags |= 8             # in-loop DCT by block-diagonal products
        if coded_ext:
            flags |= 16                # the coded size follows
        if self.bframes:
            flags |= 32                # the chunk may hold B frames
        out = [MAGIC, struct.pack(">BBHHBB", version, flags, w, h,
                                  self.quality, f)]
        if self.motion:
            out.append(struct.pack(">B", self.search_range))
        if coded_ext:
            out.append(struct.pack(">HH", pw, ph))
        if self.bframes:
            out.append(struct.pack(">B", self.bquality))
        for i in range(f):
            payload = payloads[i]
            if self.motion:
                # itypes: 1 = I anchor, 0 = P anchor, 2 = B
                it = int(itypes[i])
                ftype = 2 if it == 2 else (0 if (i == 0 or it) else 1)
                if ftype == 2:
                    mv_bytes = zlib.compress(b"".join(
                        a.astype(np.int8).tobytes() for a in mvs[i]), 6)
                elif ftype == 0:
                    mv_bytes = b""
                else:
                    mv = mvs[i][0] if isinstance(mvs[i], tuple) else mvs[i]
                    mv_bytes = zlib.compress(mv.astype(np.int8).tobytes(), 6)
                out.append(struct.pack(">BHI", ftype, len(mv_bytes),
                                       len(payload)))
                out.append(mv_bytes)
            else:
                ftype = 0 if i == 0 else 1
                out.append(struct.pack(">BI", ftype, len(payload)))
            out.append(payload)
        return b"".join(out)


# ----------------------------------------------------------------------------
# decoder
# ----------------------------------------------------------------------------

def _residual_plane(q: torch.Tensor, qtab: torch.Tensor,
                    planar: bool) -> torch.Tensor:
    """Zigzagged quantized (BH, BW, 64) coefficients → the residual plane,
    through the formulation the encoder used (header flags bit 3): the
    inverse of ``_code_plane``'s reconstruction."""
    if not planar:
        return plane_idct(dequantize(zigzag_unflatten(q.to(torch.float32)),
                                     qtab))
    cp = unblockize(zigzag_unflatten(q.to(torch.int32)))
    return plane_idct_planar(dequantize_planar(cp, qtab))


class FvcDecoder:
    """Decode FVC chunks back to RGB frames: native scan decode on the
    host, reconstruction in plain PyTorch on ``device`` (flutpu's XLA
    programs; no Pallas kernel runs on the decode side). Reads every
    chunk flutpu writes: version 1 in 4:2:0 and 4:4:4 (header flags bit
    0), version 2 with P and B frames (bit 5; all B frames of a chunk in
    one pass, ``fvc_mc_decode_chunk_b``), zlib'd vectors (bit 1),
    half-pel vectors (bit 2), either in-loop DCT (bit 3) and an explicit
    coded size (bit 4). ``decode_stream`` reads concatenated chunks."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    @staticmethod
    def parse_chunk(data: bytes):
        """Header walk of one chunk → (header dict: ``version``, ``flags``,
        ``width``, ``height``, ``coded_width``, ``coded_height``,
        ``subsample``, ``subpel``, ``quality``, ``search_range``,
        ``bquality``; per frame (frame_type, vectors, payload)). Vectors
        are None for an intra frame, (H/16, W/16, 2) int8 for a P frame,
        and (fwd, bwd, modes (H/16, W/16) int8) for a B frame, on the
        coded size's macroblock grid. Raises ValueError on a corrupt or
        truncated chunk."""
        if data[:4] != MAGIC:
            raise ValueError("not an FVC chunk")
        if len(data) < 12:
            raise ValueError("truncated FVC chunk header")
        version, flags, w, h, quality, f = struct.unpack(">BBHHBB",
                                                         data[4:12])
        subsample = bool(flags & 1)
        mult = 16 if subsample else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        if ph == 0 or pw == 0:
            raise ValueError("zero-sized FVC chunk")
        off = 12
        search_range = 7
        if version >= 2:
            if len(data) < 13:
                raise ValueError("truncated FVC v2 header")
            search_range = data[12]
            off = 13
        if flags & 16:
            # explicit coded size (bit 4): the coded geometry exceeds the
            # minimum macroblock padding (flutpu's striped encodes pad H
            # to 16 * stripes)
            if len(data) < off + 4:
                raise ValueError("truncated coded-size extension")
            pw, ph = struct.unpack(">HH", data[off:off + 4])
            off += 4
            if ph < h or pw < w or ph % mult or pw % mult:
                raise ValueError("invalid coded-size extension")
        if version >= 2 and not subsample:
            raise ValueError("motion-compensated FVC chunks are 4:2:0 only")
        mbh, mbw = ph // 16, pw // 16
        mbn = mbh * mbw
        bquality = quality
        if flags & 32:
            # B-frame quantizer quality (after any coded-size extension)
            if len(data) < off + 1:
                raise ValueError("truncated bquality extension")
            bquality = data[off]
            off += 1
            if not 1 <= bquality <= 100:
                raise ValueError("invalid bquality extension")
        frames = []
        for i in range(f):
            mv = None
            if version >= 2:
                if len(data) - off < 7:
                    raise ValueError(f"truncated frame header (frame {i})")
                ftype, mv_len, plen = struct.unpack(">BHI",
                                                    data[off:off + 7])
                off += 7
                if mv_len:
                    if len(data) - off < mv_len:
                        raise ValueError(f"bad motion block (frame {i})")
                    raw = data[off:off + mv_len]
                    if flags & 2:
                        try:
                            raw = zlib.decompress(raw)
                        except zlib.error as e:
                            raise ValueError(
                                f"corrupt motion block (frame {i}): {e}")
                    b8 = np.frombuffer(raw, np.int8)
                    if len(raw) != mbn * (5 if ftype == 2 else 2):
                        raise ValueError(f"bad motion block (frame {i})")
                    if ftype == 2:   # fwd vectors | bwd vectors | modes
                        mv = (b8[:mbn * 2].reshape(mbh, mbw, 2),
                              b8[mbn * 2:mbn * 4].reshape(mbh, mbw, 2),
                              b8[mbn * 4:].reshape(mbh, mbw))
                    else:
                        mv = b8.reshape(mbh, mbw, 2)
                    off += mv_len
                elif ftype == 2:
                    raise ValueError(f"B frame without motion block "
                                     f"(frame {i})")
            else:
                if len(data) - off < 5:
                    raise ValueError(f"truncated frame header (frame {i})")
                ftype, plen = struct.unpack(">BI", data[off:off + 5])
                off += 5
            if len(data) - off < plen:
                raise ValueError(f"truncated payload (frame {i})")
            frames.append((ftype, mv, data[off:off + plen]))
            off += plen
        if flags & 4 and version >= 2 and any(t == 2 for t, _, _ in frames):
            raise ValueError("B frames with subpel vectors are not a valid "
                             "stream")
        header = {"version": version, "flags": flags, "width": w,
                  "height": h, "coded_width": pw, "coded_height": ph,
                  "subsample": subsample, "subpel": bool(flags & 4),
                  "quality": quality, "search_range": search_range,
                  "bquality": bquality}
        return header, frames

    def decode_chunk(self, data: bytes) -> Tuple[np.ndarray, dict]:
        """One chunk → ((F, H, W, 3) uint8 frames, info with ``quality``,
        ``types`` (0 = I, 1 = P, 2 = B), ``width``, ``height``)."""
        hdr, frames = self.parse_chunk(data)
        h, w, quality = hdr["height"], hdr["width"], hdr["quality"]
        ph, pw = hdr["coded_height"], hdr["coded_width"]
        sub = hdr["subsample"]
        cbw, cbh = (pw // 16, ph // 16) if sub else (pw // 8, ph // 8)
        planes = []
        for i, (_, _, payload) in enumerate(frames):
            coefs = decode_scan_to_coefs(payload, pw // 8, ph // 8, cbw, cbh,
                                         sub)
            if coefs is None:
                raise ValueError(f"corrupt FVC payload (frame {i})")
            planes.append(coefs)
        types = [t for t, _, _ in frames]
        mvs = [m for _, m, _ in frames]

        dev = self.device

        def tables(q):
            return (torch.as_tensor(scale_qtable(LUMA_QTABLE, q), device=dev),
                    torch.as_tensor(scale_qtable(CHROMA_QTABLE, q),
                                    device=dev))

        qy, qc = tables(quality)
        ry, rcb, rcr = (torch.as_tensor(np.stack([p[c] for p in planes]),
                                        device=dev) for c in range(3))
        planar = bool(hdr["flags"] & 8)
        if hdr["version"] >= 2 and 2 in types:
            frames = _to_rgb8(*self._reconstruct_mc_b(
                ry, rcb, rcr, mvs, types, qy, qc, *tables(hdr["bquality"]),
                planar=planar))
        elif hdr["version"] >= 2:
            frames = _to_rgb8(*self._reconstruct_mc(
                ry, rcb, rcr, mvs, qy, qc, planar=planar,
                subpel=hdr["subpel"]))
        else:
            frames = coefs_to_rgb(*fvc_accumulate(ry, rcb, rcr), qy, qc, h,
                                  w, subsample=sub)
        frames = frames[:, :h, :w].cpu().numpy()
        return frames, {"quality": quality, "types": types, "width": w,
                        "height": h}

    @staticmethod
    def _mc_arrays(mvs, mbh: int, mbw: int):
        """P/I frames' vectors → ((F, mbh, mbw, 2) int8, (F,) int8 itypes:
        1 where a frame carries no vectors, an intra frame)."""
        mv_arr = np.zeros((len(mvs), mbh, mbw, 2), np.int8)
        itypes = np.zeros(len(mvs), np.int8)
        for i, mv in enumerate(mvs):
            if mv is None:
                itypes[i] = 1
            else:
                mv_arr[i] = mv
        return mv_arr, itypes

    @classmethod
    def _reconstruct_mc(cls, ry, rcb, rcr, mvs, qy, qc, planar: bool,
                        subpel: bool = False):
        """v2 P-only frames → (Y, Cb, Cr) planes: the in-loop
        reconstruction (``fvc_mc_decode_chunk``)."""
        mv_arr, itypes = cls._mc_arrays(mvs, ry.shape[1] // 2,
                                        ry.shape[2] // 2)
        return fvc_mc_decode_chunk(
            ry, rcb, rcr, torch.from_numpy(mv_arr).to(ry.device),
            torch.from_numpy(itypes), qy, qc, subpel=subpel, planar=planar)

    @classmethod
    def _reconstruct_mc_b(cls, ry, rcb, rcr, mvs, types, qy, qc, qy_b, qc_b,
                          planar: bool):
        """B-frame chunk → (Y, Cb, Cr) planes in display order: the
        anchors through the P reconstruction, then every B frame at once
        from its anchor pair (``fvc_mc_decode_chunk_b``)."""
        a_idx = [i for i, t in enumerate(types) if t != 2]
        b_idx = [i for i, t in enumerate(types) if t == 2]
        if not a_idx or b_idx[0] < a_idx[0] or b_idx[-1] > a_idx[-1]:
            raise ValueError("B frame without surrounding anchor frames")
        prev_map = [max(k for k, a in enumerate(a_idx) if a < j)
                    for j in b_idx]
        next_map = [k + 1 for k in prev_map]
        dev = ry.device
        a_mv, a_it = cls._mc_arrays([mvs[i] for i in a_idx],
                                    ry.shape[1] // 2, ry.shape[2] // 2)

        def stack(c):
            return torch.as_tensor(np.stack([mvs[i][c] for i in b_idx]),
                                   device=dev)

        (ay, acb, acr), (by, bcb, bcr) = fvc_mc_decode_chunk_b(
            ry[a_idx], rcb[a_idx], rcr[a_idx],
            torch.from_numpy(a_mv).to(dev), torch.from_numpy(a_it),
            ry[b_idx], rcb[b_idx], rcr[b_idx], stack(0), stack(1), stack(2),
            prev_map, next_map, qy, qc, planar=planar, qy_b=qy_b, qc_b=qc_b)
        perm = torch.as_tensor(np.argsort(np.asarray(a_idx + b_idx)),
                               device=dev)
        return tuple(torch.cat([a, b])[perm]
                     for a, b in ((ay, by), (acb, bcb), (acr, bcr)))

    @staticmethod
    def split_stream(data: bytes) -> List[bytes]:
        """Walk a concatenated stream into per-chunk byte slices (a header
        walk, a copy of flutpu's; raises ValueError on a corrupt
        boundary)."""
        chunks = []
        off = 0
        while off < len(data):
            if len(data) - off < 12 or data[off:off + 4] != MAGIC:
                raise ValueError(f"bad or truncated chunk boundary at {off}")
            ver, cflags, w, h, _, f = struct.unpack(">BBHHBB",
                                                    data[off + 4:off + 12])
            end = off + (13 if ver >= 2 else 12)
            if cflags & 16:
                end += 4  # explicit coded-size extension
            if cflags & 32:
                end += 1  # B-frame bquality extension
            hdr = 7 if ver >= 2 else 5
            for _ in range(f):
                if len(data) - end < hdr:
                    raise ValueError(f"truncated frame header at {end}")
                if ver >= 2:
                    _, mv_len, plen = struct.unpack(">BHI", data[end:end + 7])
                    end += 7 + mv_len + plen
                else:
                    _, plen = struct.unpack(">BI", data[end:end + 5])
                    end += 5 + plen
            if end > len(data):
                raise ValueError("truncated chunk payload")
            chunks.append(data[off:end])
            off = end
        return chunks

    def decode_stream(self, data: bytes, parallel: bool = True) -> np.ndarray:
        """Concatenated chunks → all frames in chunk order. Chunks are
        independent (each starts on an I frame), so with ``parallel``
        they decode in a pool of up to 8 threads (the native scan decoder
        releases the GIL); the output keeps the chunks' order."""
        chunks = self.split_stream(data)
        if parallel and len(chunks) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(8, len(chunks))) as pool:
                out = list(pool.map(lambda c: self.decode_chunk(c)[0],
                                    chunks))
        else:
            out = [self.decode_chunk(c)[0] for c in chunks]
        return np.concatenate(out, axis=0)


def _to_rgb8(y, cb, cr) -> torch.Tensor:
    """(F, H, W) and (F, H/2, W/2) x 2 planes → (F, H, W, 3) uint8 RGB."""
    rgb = i420_to_rgb(y, cb, cr)
    return (rgb + 0.5).clamp(0, 255).to(torch.uint8)


def fvc_mc_decode_chunk(ry, rcb, rcr, mvs, itypes, qy, qc,
                        search_range: int = 7, subpel: bool = False,
                        planar: bool = False):
    """The encoder's in-loop reconstruction, frame by frame.

    ry/rcb/rcr: (F, BH, BW, 64) zigzagged residual coefficients; mvs
    (F, H/16, W/16, 2) vectors, integer or (``subpel``, header flags bit
    2) half-pel; itypes (F,) — nonzero where the frame is intra
    (flat-128 prediction; frame 0 always is). ``planar`` is header flags
    bit 3. Returns the (F, H, W), (F, H/2, W/2) x 2 float32 planes.
    ``search_range`` is accepted for the reference's signature."""
    out = []
    rec = None
    for i in range(ry.shape[0]):
        if i == 0 or int(itypes[i]):
            pred = (128.0, 128.0, 128.0)
        elif subpel:
            m = mvs[i]
            pred = (motion_compensate_subpel(rec[0], m),
                    motion_compensate_subpel(rec[1], m, mb=8),
                    motion_compensate_subpel(rec[2], m, mb=8))
        else:
            m = mvs[i]
            pred = (motion_compensate(rec[0], m),
                    motion_compensate(rec[1], m, mb=8),
                    motion_compensate(rec[2], m, mb=8))
        rec = tuple(
            (p + _residual_plane(q[i], t, planar)).clamp(0.0, 255.0)
            for p, q, t in zip(pred, (ry, rcb, rcr), (qy, qc, qc)))
        out.append(rec)
    return tuple(torch.stack(p) for p in zip(*out))


def fvc_mc_decode_chunk_b(a_ry, a_rcb, a_rcr, a_mvs, a_itypes,
                          b_ry, b_rcb, b_rcr, b_fwd, b_bwd, b_modes,
                          prev_map, next_map, qy, qc,
                          search_range: int = 7, planar: bool = False,
                          qy_b=None, qc_b=None):
    """Decode of a B-frame chunk: the anchors through
    ``fvc_mc_decode_chunk``, then all B frames in ONE pass, batched over
    a leading B-frame axis: each B frame's forward and backward
    predictions from its anchor pair (``prev_map``/``next_map`` index the
    anchor arrays), per macroblock the average, forward, backward or flat
    128 of its mode, plus its residual at the ``bquality`` tables
    (``qy_b``/``qc_b``; default the anchor tables). Returns the anchor
    planes and the B planes (the caller interleaves display order)."""
    qy_b = qy if qy_b is None else qy_b
    qc_b = qc if qc_b is None else qc_b
    ay, acb, acr = fvc_mc_decode_chunk(a_ry, a_rcb, a_rcr, a_mvs, a_itypes,
                                       qy, qc, planar=planar)
    dev = ay.device
    pm, nm = (on_device(("anchor_map", tuple(m)), np.asarray(m), dev,
                        torch.long) for m in (prev_map, next_map))
    fwd, bwd = b_fwd.to(torch.int64), b_bwd.to(torch.int64)
    mode = b_modes.to(torch.int64)
    mode_y, mode_c = _repeat_blocks(mode, MB), _repeat_blocks(mode, 8)
    pf, pb = motion_compensate(ay[pm], fwd), motion_compensate(ay[nm], bwd)
    preds = [_select_mode(mode_y, (pf + pb) * 0.5, pf, pb)]
    for a in (acb, acr):
        fc = motion_compensate(a[pm], fwd, mb=8)
        bc = motion_compensate(a[nm], bwd, mb=8)
        preds.append(_select_mode(mode_c, (fc + bc) * 0.5, fc, bc))
    b_out = tuple(
        (pred + _residual_plane(q, t, planar)).clamp(0.0, 255.0)
        for pred, q, t in zip(preds, (b_ry, b_rcb, b_rcr),
                              (qy_b, qc_b, qc_b)))
    return (ay, acb, acr), b_out


# ----------------------------------------------------------------------------
# element
# ----------------------------------------------------------------------------

def _scene_gop_size(event) -> Optional[int]:
    """The chunk size a hype scene-new event announces, or None for any
    other event (flutpu.hype.events.SceneNewEvent.parse, copied)."""
    if event.name != SCENE_NEW_EVENT_NAME:
        return None
    return int(event.structure["gop_size"])


@register
class CudaFvcEnc(VideoEncoder):
    """cudafvcenc — the FVC chunk encoder element on a CUDA device (port
    of flutpu's ``fvcenc``). Each chunk is one device dispatch; a
    ForceKeyUnit (chunk start) begins a new chunk with an I frame."""

    FACTORY = "cudafvcenc"
    SINK_CAPS = "video/x-raw, format=RGB"
    SRC_CAPS = "video/x-fvc"
    PROPERTIES = [
        PropertySpec("quality", 85),
        PropertySpec("gop-size", 8, "frames per chunk when not driven by "
                                    "hype scene events"),
        PropertySpec("motion", False, "v2 hybrid codec: motion-compensated "
                                      "prediction with in-loop recon"),
        PropertySpec("search-range", 7, "motion full-search window (±px)"),
        PropertySpec("engine", "auto", "auto | device | host entropy coding; "
                                       "auto never leaves the device here"),
        PropertySpec("search", "full", "full | hier motion estimation "
                                       "(hier = coarse-to-fine)"),
        PropertySpec("subpel", False, "half-pel motion refinement + "
                     "bilinear compensation (motion mode, no bframes)"),
        PropertySpec("bframes", 0, "B frames between anchors (motion mode "
                                   "only): bidirectional per-macroblock "
                                   "prediction from the surrounding "
                                   "reconstructed anchors"),
        PropertySpec("bitrate", 0, "target bits/sec; 0 = constant quality. "
                                   "Per-chunk log-proportional quality "
                                   "controller (flutpu's fvcenc), one "
                                   "re-encode when a chunk is far over "
                                   "budget"),
        PropertySpec("segmented", "auto", "bitstream layout of the device "
                     "stage: auto (FLUTPU_SEGMENTED, else segments) | true "
                     "| false (per-block pack); the bytes are the same"),
        PropertySpec("device", "cuda", "torch device the encode runs on "
                     "(cuda, cuda:N, or cpu for the plain versions)"),
    ]

    # flutpu's rate controller: qualities it may pick
    _RC_MIN_Q, _RC_MAX_Q = 10, 97

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._encoders: dict = {}
        self._pending: List[Buffer] = []
        self._chunk_gop: Optional[int] = None
        self._rc_quality: Optional[float] = None

    def _enc(self, quality: Optional[int] = None) -> FvcEncoder:
        """The encoder at ``quality`` (default: the property), one per
        quality the rate controller has picked."""
        q = int(self.get_property("quality")) if quality is None else quality
        enc = self._encoders.get(q)
        if enc is None:
            enc = self._encoders[q] = FvcEncoder(
                q,
                motion=bool(self.get_property("motion")),
                search_range=int(self.get_property("search-range")),
                engine=str(self.get_property("engine")),
                hier=str(self.get_property("search")) == "hier",
                subpel=bool(self.get_property("subpel")),
                segmented=segmented_property(self.get_property("segmented")),
                bframes=int(self.get_property("bframes")),
                device=str(self.get_property("device")))
        return enc

    def do_set_property(self, name, value):
        self._encoders = {}  # rebuild with the new settings

    def set_format(self, caps: Caps):
        fields = {k: v for k, v in caps.fields.items()
                  if k in ("width", "height", "framerate")}
        return Caps.new("video/x-fvc", **fields)

    def prewarm(self, caps=None) -> bool:
        """Build the kernels and encode one chunk of ``caps``' geometry."""
        if caps is None:
            return False
        w, h = caps.get("width"), caps.get("height")
        if not w or not h:
            return False
        gop = self._chunk_gop or int(self.get_property("gop-size"))
        self._enc().encode_chunk(np.zeros((gop, int(h), int(w), 3),
                                          np.uint8))
        return True

    def encode_frame(self, buf: Buffer, keyframe: bool) -> Optional[Buffer]:
        if keyframe and self._pending:
            self._flush_chunk()  # new sync point closes the open chunk
        self._pending.append(buf)
        target = self._chunk_gop or int(self.get_property("gop-size"))
        if len(self._pending) >= target:
            self._flush_chunk()
        return None

    def on_custom_event(self, event) -> None:
        gop = _scene_gop_size(event)
        if gop is not None:
            self._chunk_gop = gop

    def drain(self) -> None:
        self._flush_chunk()

    def reset(self) -> None:
        self._pending = []

    def finish(self):
        self._flush_chunk()
        return []

    def _chunk_target_bytes(self, batch: List[Buffer]) -> Optional[int]:
        bitrate = int(self.get_property("bitrate"))
        if bitrate <= 0:
            return None
        dur_ns = sum((b.duration or 0) for b in batch)
        if dur_ns <= 0 and self.input_caps is not None:
            fr = self.input_caps.get("framerate")
            if fr:
                dur_ns = int(len(batch) * 1e9 * fr.denominator / fr.numerator)
        if dur_ns <= 0:
            dur_ns = int(len(batch) * 1e9 / 30)
        return max(1, int(bitrate / 8 * dur_ns / 1e9))

    def _flush_chunk(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        frames = np.stack([np.asarray(b.data) for b in batch])
        target = self._chunk_target_bytes(batch)
        if target is None:
            chunk = self._enc().encode_chunk(frames)
        else:
            # rate control: log-proportional per-chunk quality adaptation,
            # one in-chunk retry when far over budget
            if self._rc_quality is None:
                self._rc_quality = float(self.get_property("quality"))
            q = int(round(self._rc_quality))
            chunk = self._enc(q).encode_chunk(frames)
            if len(chunk) > target * 1.3:
                q2 = max(self._RC_MIN_Q,
                         q - int(round(12 * np.log2(len(chunk) / target))))
                if q2 < q:
                    chunk = self._enc(q2).encode_chunk(frames)
                    q = q2
            ratio = len(chunk) / target
            self._rc_quality = float(np.clip(
                q - 12 * np.log2(max(ratio, 1e-6)),
                self._RC_MIN_Q, self._RC_MAX_Q))
        first = batch[0]
        last = batch[-1]
        duration = None
        if first.pts is not None and last.pts is not None:
            duration = last.pts - first.pts + (last.duration or 0)
        out = Buffer(chunk, pts=first.pts, dts=first.dts, duration=duration,
                     offset=first.offset)
        out.meta["n_frames"] = len(batch)
        out.meta["frame_pts"] = [b.pts for b in batch]
        self.srcpad.push(out)
