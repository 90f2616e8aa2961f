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
refine kernels), the chroma compensation kernel, the in-loop DCT/IDCT in
plain PyTorch (per 8x8 block, full fp32), and the pack kernel once per
chunk: the segment pack (K2), or with ``segmented=False`` the per-block
pack (K7, or K8a under ``FLUTPU_NO_FUSED_PACK=1``) and the block concat,
as the JPEG encoder's layouts; the chunk's bytes are the same. The
per-frame I/P and per-macroblock B mode decisions stay on the device.
The chunk's compressed words, its vectors (and B modes) and its
frame-type word come back in one copy into pinned memory.

Bitstream: byte-compatible with flutpu's (``MAGIC``, the header layout
and the per-frame records are copies). The port writes header flags
bit 3 = 0: its in-loop reconstruction uses the per-block DCT, which is
what flutpu's decoder on the CPU expects for such streams.

Not ported (each raises ``NotImplementedError``): half-pel motion
(``subpel``), 4:4:4, batched chunk dispatch, rate control
(``bitrate``), spatial striping.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import Buffer, Caps, PropertySpec, register
from ..core.env import env_flag
from .base import VideoEncoder
from .convert import encoder_state_from_numpy
from .decode import coefs_to_rgb, decode_scan_to_coefs
from .encoder import SCENE_NEW_EVENT_NAME
from .jpeg import JpegEncoder, _edge_pad, _HostCopy, _pad_to, \
    _planes_front_end, segmented_property
from .ops.colorspace import i420_to_rgb, planes_to_i420
from .ops.dct import dct_matrix, plane_dct, plane_idct, unblockize
from .ops.entropy import encode_gop_scans_layout
from .ops.motion import MB, _mb_sums, motion_compensate
from .ops.motion_kernels import MAX_SEARCH_RANGE, chroma_mc, \
    motion_search_mc, motion_search_mc_dygrid, motion_search_mc_hier
from .ops.quant import (CHROMA_QTABLE, LUMA_QTABLE, dequantize, quant_map,
                        quantize, scale_qtable, zigzag_flatten,
                        zigzag_unflatten)

# copies of flutpu.codec.fvc's constants
MAGIC = b"FVC1"
VERSION = 1
_CLAMP = 1023  # keeps every residual within standard-table magnitude range


def _check_full_fp32(device: torch.device) -> None:
    """The in-loop DCT/IDCT is codec state: the decoder reconstructs in
    full fp32, so a TF32 matmul on the card would drift the P chain."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "FVC motion mode needs full-fp32 matmuls on the card: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


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


def _quant_plane(resid: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """Pixel residual plane → clamped quantized (BH, BW, 8, 8) coefficients,
    per-block DCT (header flags bit 3 = 0)."""
    return quantize(plane_dct(resid), qtab).clamp(-_CLAMP, _CLAMP)


def _code_plane(resid: torch.Tensor, qtab: torch.Tensor):
    """Pixel residual plane → (zigzagged int16 coefficients, the
    reconstructed residual)."""
    coefs = _quant_plane(resid, qtab)
    rec = plane_idct(dequantize(coefs, qtab))
    return zigzag_flatten(coefs).to(torch.int16), rec


def _planes(frames):
    """(r, g, b) channel planes or interleaved (F, H, W, 3) frames →
    the three channel planes."""
    if isinstance(frames, (tuple, list)):
        return tuple(frames)
    return frames[..., 0], frames[..., 1], frames[..., 2]


def _i420_planes(frames, pad_h: int, pad_w: int):
    """(r, g, b) uint8 planes (F, H, W) or interleaved (F, H, W, 3)
    frames, edge-padded to (pad_h, pad_w) → float32 (Y, Cb, Cr) planes."""
    r, g, b = (_edge_pad(p, pad_h, pad_w) for p in _planes(frames))
    _check_full_fp32(r.device)
    return planes_to_i420(r, g, b)


def _search_fn(hier: bool, dygrid: bool = False):
    """The search + luma prediction the motion loop runs: K5 for
    ``search=hier``, else K6b where the dy-grid arm is chosen, else K3."""
    if hier:
        return motion_search_mc_hier
    return motion_search_mc_dygrid if dygrid else motion_search_mc


def _anchor_loop(y, cb, cr, qy, qc, search, search_range: int):
    """The hybrid loop over (F, ...) planes, frame 0 intra: per frame the
    search against the reconstructed reference, the chroma kernel, the
    device-side I/P decision, DCT + quantization of the pixel residual
    and the in-loop reconstruction. Returns (ry, rcb, rcr) int16
    zigzagged residual coefficients, mvs (F, H/16, W/16, 2) int8, itypes
    (F,) int8 (1 = intra) and each frame's reconstructed planes."""
    f = y.shape[0]
    dev = y.device
    mbh, mbw = y.shape[1] // MB, y.shape[2] // MB
    no_mv = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
    outs, mvs, itypes, recs = [], [], [], []
    rec_y = rec_cb = rec_cr = None
    for i in range(f):
        cy, ccb, ccr = y[i], cb[i], cr[i]
        if i == 0:   # the chunk starts on an I frame: no search to run
            is_i = torch.ones((), dtype=torch.bool, device=dev)
            mv = no_mv
            pred_y = pred_cb = pred_cr = 128.0
        else:
            mv, pred_p_y = search(cy, rec_y, search_range)
            # the in-codec scene-cut detector: intra when flat 128 leaves
            # less luma residual than the motion prediction (sums in
            # float64, so the CPU and the card decide alike)
            sad_p = (cy - pred_p_y).abs().sum(dtype=torch.float64)
            sad_i = (cy - 128.0).abs().sum(dtype=torch.float64)
            is_i = sad_i < sad_p
            mv = torch.where(is_i, no_mv, mv)
            pcb, pcr = chroma_mc(rec_cb, rec_cr, mv, search_range)
            pred_y = torch.where(is_i, 128.0, pred_p_y)
            pred_cb = torch.where(is_i, 128.0, pcb)
            pred_cr = torch.where(is_i, 128.0, pcr)
        oy, ry_rec = _code_plane(cy - pred_y, qy)
        ocb, rcb_rec = _code_plane(ccb - pred_cb, qc)
        ocr, rcr_rec = _code_plane(ccr - pred_cr, qc)
        rec_y = (pred_y + ry_rec).clamp(0.0, 255.0)
        rec_cb = (pred_cb + rcb_rec).clamp(0.0, 255.0)
        rec_cr = (pred_cr + rcr_rec).clamp(0.0, 255.0)
        outs.append((oy, ocb, ocr))
        mvs.append(mv.to(torch.int8))
        itypes.append(is_i.to(torch.int8))
        recs.append((rec_y, rec_cb, rec_cr))
    ry, rcb, rcr = (torch.stack(p) for p in zip(*outs))
    return ry, rcb, rcr, torch.stack(mvs), torch.stack(itypes), recs


def fvc_mc_encode_chunk(frames, qy: torch.Tensor, qc: torch.Tensor,
                        pad_h: int, pad_w: int, search_range: int = 7,
                        hier: bool = False, subpel: bool = False,
                        planar: Optional[bool] = None):
    """Motion-compensated chunk encode (FVC v2, P frames only): the hybrid
    loop (``_anchor_loop``) over every frame, with the full search (K3;
    K6b under ``FLUTPU_SEARCH_DYGRID=1``, as flutpu selects it) or, with
    ``hier``, the coarse-to-fine search (K5). ``frames``: (r, g, b) uint8
    planes (F, H, W) or interleaved (F, H, W, 3), edge-padded here to
    (pad_h, pad_w).

    Returns (ry, rcb, rcr) int16 zigzagged residual coefficients,
    mvs (F, H/16, W/16, 2) int8 and itypes (F,) int8 (1 = intra)."""
    if subpel:
        raise NotImplementedError("half-pel motion is not ported yet")
    if planar:
        raise NotImplementedError("the port reconstructs with the per-block "
                                  "DCT (header flags bit 3 = 0)")
    y, cb, cr = _i420_planes(frames, pad_h, pad_w)
    search = _search_fn(hier, env_flag("FLUTPU_SEARCH_DYGRID", False))
    return _anchor_loop(y, cb, cr, qy, qc, search, search_range)[:5]


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
    return a.repeat_interleave(n, 0).repeat_interleave(n, 1)


def fvc_mc_encode_chunk_b(frames, qy: torch.Tensor, qc: torch.Tensor,
                          pad_h: int, pad_w: int, search_range: int = 7,
                          bframes: int = 1, hier: bool = False,
                          planar: Optional[bool] = None,
                          qy_b: Optional[torch.Tensor] = None,
                          qc_b: Optional[torch.Tensor] = None):
    """Bidirectional chunk encode (FVC v2 + flags bit 5). The anchor
    frames (every ``bframes + 1``-th, plus the last) run the hybrid loop;
    then each B frame runs the search (K3, or K5 with ``hier``) against
    its previous and its next reconstructed anchor, and per macroblock
    takes the least-SAD of four predictions (0 = their average, 1 =
    forward, 2 = backward, 3 = flat 128; ties to the lower mode). B frames
    are non-reference: their residuals are quantized at ``qy_b``/``qc_b``
    (default: the anchor tables) and never reconstructed. Chroma is
    compensated with both vectors before the unused ones are zeroed.

    Returns, in display order: (ry, rcb, rcr) int16 zigzagged residual
    coefficients; fwd and bwd (F, H/16, W/16, 2) int8 (anchor P vectors in
    fwd; zero where a B macroblock does not use them); modes (F, H/16,
    W/16) int8 (zero for anchors); ftypes (F,) int8 (0 = P anchor, 1 = I
    anchor, 2 = B)."""
    if planar:
        raise NotImplementedError("the port reconstructs with the per-block "
                                  "DCT (header flags bit 3 = 0)")
    qy_b = qy if qy_b is None else qy_b
    qc_b = qc if qc_b is None else qc_b
    y, cb, cr = _i420_planes(frames, pad_h, pad_w)
    search = _search_fn(hier)
    r = search_range
    anchor_idx, b_idx, prev_map, next_map = _bframe_structure(y.shape[0],
                                                              bframes)
    ary, arcb, arcr, amv, ais_i, recs = _anchor_loop(
        y[anchor_idx], cb[anchor_idx], cr[anchor_idx], qy, qc, search, r)
    zero_mv = torch.zeros_like(amv)
    zero_mode = torch.zeros_like(amv[..., 0])
    if not b_idx:
        return ary, arcb, arcr, amv, zero_mv, zero_mode, ais_i

    outs = []
    for j, p, n in zip(b_idx, prev_map, next_map):
        cy, ccb, ccr = y[j], cb[j], cr[j]
        (py, pcb, pcr), (ny, ncb, ncr) = recs[p], recs[n]
        fwd, pred_f = search(cy, py, r)
        bwd, pred_b = search(cy, ny, r)
        pred_bi = (pred_f + pred_b) * 0.5
        # first minimum on the CPU and on CUDA alike: ties go to mode 0
        mode = torch.argmin(torch.stack([
            _mb_sums((cy - pred_bi).abs(), MB),
            _mb_sums((cy - pred_f).abs(), MB),
            _mb_sums((cy - pred_b).abs(), MB),
            _mb_sums((cy - 128.0).abs(), MB)]), dim=0)
        fcb, fcr = chroma_mc(pcb, pcr, fwd, r)
        bcb, bcr = chroma_mc(ncb, ncr, bwd, r)
        mode_y, mode_c = _repeat_blocks(mode, MB), _repeat_blocks(mode, 8)
        pred_y = _select_mode(mode_y, pred_bi, pred_f, pred_b)
        pred_cb = _select_mode(mode_c, (fcb + bcb) * 0.5, fcb, bcb)
        pred_cr = _select_mode(mode_c, (fcr + bcr) * 0.5, fcr, bcr)
        coefs = [zigzag_flatten(_quant_plane(c - pr, q)).to(torch.int16)
                 for c, pr, q in ((cy, pred_y, qy_b), (ccb, pred_cb, qc_b),
                                  (ccr, pred_cr, qc_b))]
        # zero unused vectors: smaller zlib'd fields, and the decode never
        # reads them
        use_f = ((mode == 0) | (mode == 1))[..., None]
        use_b = ((mode == 0) | (mode == 2))[..., None]
        outs.append((*coefs, torch.where(use_f, fwd, 0).to(torch.int8),
                     torch.where(use_b, bwd, 0).to(torch.int8),
                     mode.to(torch.int8)))
    boy, bocb, bocr, bfwd, bbwd, bmode = (torch.stack(p) for p in zip(*outs))
    # interleave back to display order
    perm = torch.as_tensor(np.argsort(np.asarray(anchor_idx + b_idx)),
                           device=y.device)

    def cat(a, b):
        return torch.cat([a, b])[perm]

    btypes = torch.full((len(b_idx),), 2, dtype=torch.int8, device=y.device)
    return (cat(ary, boy), cat(arcb, bocb), cat(arcr, bocr), cat(amv, bfwd),
            cat(zero_mv, bbwd), cat(zero_mode, bmode), cat(ais_i, btypes))


def _fvc_gop_program_v1(frames, qy, qc, pad_h, pad_w, layout, prefix_words,
                        seg_g, seg_words):
    """Front-end kernel → temporal residuals → pack kernel → combined
    int32 words (see encode_gop_scans_layout: the segment layout, or the
    non-segment one where ``seg_words`` is None)."""
    r, g, b = _planes(frames)
    coefs = _planes_front_end(r, g, b, qy, qc, pad_h, pad_w)
    ry, rcb, rcr = fvc_residuals(*coefs)
    return encode_gop_scans_layout(ry, rcb, rcr, layout, prefix_words, seg_g,
                                   seg_words)


def _fvc_gop_program_v2(frames, qy, qc, pad_h, pad_w, search_range, layout,
                        prefix_words, seg_g, seg_words, hier=False,
                        bframes=0, qy_b=None, qc_b=None):
    """The v1 program's layout with the motion loop in front and two
    more fields per frame: the int8 side columns packed four to a word
    (the vectors; with ``bframes`` fwd | bwd | modes), then the
    frame-type word (0 P, 1 I, 2 B) — one array, so one copy brings back
    the chunk."""
    if bframes:
        ry, rcb, rcr, fwd, bwd, modes, itypes = fvc_mc_encode_chunk_b(
            frames, qy, qc, pad_h, pad_w, search_range, bframes, hier,
            qy_b=qy_b, qc_b=qc_b)
        f = fwd.shape[0]
        side = torch.cat([fwd.reshape(f, -1), bwd.reshape(f, -1),
                          modes.reshape(f, -1)], dim=1)
    else:
        ry, rcb, rcr, mvs, itypes = fvc_mc_encode_chunk(
            frames, qy, qc, pad_h, pad_w, search_range, hier)
        f = mvs.shape[0]
        side = mvs.reshape(f, -1)
    combined = encode_gop_scans_layout(ry, rcb, rcr, layout, prefix_words,
                                       seg_g, seg_words)
    pad = (-side.shape[1]) % 4
    if pad:
        side = torch.nn.functional.pad(side, (0, pad))
    side_words = side.contiguous().view(torch.int32)   # little-endian bytes
    return torch.cat([combined, side_words, itypes.to(torch.int32)[:, None]],
                     dim=1)


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
    coarse-to-fine search; ``bframes`` (1..7, motion only) the number of
    B frames between anchors, quantized at ``bquality`` (default
    ``max(10, quality - 8)``). ``device`` is where the encode runs: a
    CUDA device launches the kernels; ``"cpu"`` runs their plain PyTorch
    versions. The bitstream layout of the entropy stage (``segmented``)
    and its sizing (compressed-prefix window, segment staging, overflow
    redispatch) are the port's JpegEncoder's, as in flutpu."""

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
        if not subsample:
            raise NotImplementedError("the port encodes 4:2:0 only; 4:4:4 "
                                      "is not ported yet")
        if subpel:
            raise NotImplementedError("half-pel motion is not ported yet")
        if engine not in ("auto", "device"):
            raise NotImplementedError(f"engine={engine!r}: the port codes on "
                                      "the device only (auto | device)")
        if not 0 < search_range <= 126:
            raise ValueError("search_range must be in 1..126 (vectors are "
                             "int8 in the bitstream)")
        if search_range > MAX_SEARCH_RANGE:
            raise NotImplementedError(
                f"search ranges above {MAX_SEARCH_RANGE} are not ported")
        self.quality = quality
        self.motion = bool(motion)
        self.hier = bool(hier)
        self.search_range = int(search_range)
        self.device = torch.device(device)
        # shared scan coder: its tables, sizing policy and overflow bounds
        self._scan_coder = JpegEncoder(quality, segmented=segmented,
                                       device=self.device)
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
                         bframes: int = 0, bquality: Optional[int] = None,
                         seg_words: Optional[int] = None,
                         prefix_window: Optional[int] = None,
                         segmented: Optional[bool] = None,
                         device="cuda") -> "FvcEncoder":
        """An encoder with given quantization tables and adaptive sizes
        (e.g. flutpu's ``qy``, ``qc``, ``search_range``, ``hier``,
        ``bframes``, ``bquality`` and its scan coder's ``_seg_words``,
        ``_prefix_window``). The tables must be a quality's: the chunk
        header carries the quality."""
        enc = cls(_table_quality(qy, qc), motion=motion,
                  search_range=search_range, hier=hier, segmented=segmented,
                  bframes=bframes, bquality=bquality, device=device)
        enc._scan_coder._set_state(encoder_state_from_numpy(
            qy, qc, seg_words=seg_words, prefix_window=prefix_window,
            device=enc.device))
        return enc

    # -- dispatch / finalize ------------------------------------------------
    def _dispatch(self, frames_fn, f: int, h: int, w: int) -> _ChunkHandle:
        sc = self._scan_coder
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        qy, qc = sc._qy_dev, sc._qc_dev

        def program(layout, prefix_words, seg_words):
            if self.motion:
                return _fvc_gop_program_v2(
                    frames_fn(), qy, qc, ph, pw, self.search_range, layout,
                    prefix_words, sc.SEG_G, seg_words, self.hier,
                    self.bframes, self._qyb_dev, self._qcb_dev)
            return _fvc_gop_program_v1(frames_fn(), qy, qc, ph, pw, layout,
                                       prefix_words, sc.SEG_G, seg_words)

        return _ChunkHandle(*sc._run_sized(program, ph, pw), f, h, w, ph,
                            pw)

    def encode_chunk_dispatch(self, frames) -> _ChunkHandle:
        """Enqueue the device encode of (F, H, W, 3) uint8 RGB frames
        (numpy or tensor). Non-blocking on a CUDA device; returns a handle
        for ``encode_chunk_finalize``."""
        t = torch.as_tensor(np.ascontiguousarray(frames)
                            if isinstance(frames, np.ndarray) else frames)
        t = t.to(self.device)
        f, h, w, _ = t.shape
        return self._dispatch(lambda: t, f, h, w)

    def encode_chunk_dispatch_src(self, src_fn, start, n: int, h: int,
                                  w: int) -> _ChunkHandle:
        """encode_chunk_dispatch with an on-device frame source:
        ``src_fn(ph, pw, n, start)`` returns (r, g, b) uint8 planes, each
        (n, ph, pw), or interleaved (n, ph, pw, 3) frames, at the coded
        size (h, w rounded up to 16)."""
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        return self._dispatch(lambda: src_fn(ph, pw, n, start), n, h, w)

    def encode_chunk_finalize(self, handle: _ChunkHandle) -> bytes:
        """Blocking half: wait for the copy, check the sizes (redispatch
        once on overflow), compact the scans, assemble the chunk."""
        payloads, mvs, itypes = self._finalize(handle)
        return self._build_chunk(payloads, mvs, itypes, handle.f, handle.h,
                                 handle.w)

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
        payloads = [JpegEncoder._scan_bytes(row, n, handle.prefix)
                    for row in arr]
        mvs = itypes = None
        if self.motion:
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
            itypes = arr[:, -1].astype(np.int64)   # 1 = I frame, 2 = B
        return payloads, mvs, itypes

    def _build_chunk(self, payloads, mvs, itypes, f: int, h: int,
                     w: int) -> bytes:
        """Container assembly (flutpu's ``_build_chunk`` for streams with
        integer-pel vectors and the per-block in-loop DCT)."""
        version = 2 if self.motion else VERSION
        flags = 1                      # 4:2:0
        if self.motion:
            flags |= 2                 # vectors are zlib-compressed
            if self.bframes:
                flags |= 32            # the chunk may hold B frames
        out = [MAGIC, struct.pack(">BBHHBB", version, flags, w, h,
                                  self.quality, f)]
        if self.motion:
            out.append(struct.pack(">B", self.search_range))
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

@functools.lru_cache()
def _bd_dct_matrix(dim: int) -> np.ndarray:
    """(dim, dim) block-diagonal matrix with the 8x8 DCT on the diagonal
    (copy of flutpu.codec.ops.dct._bd_dct_matrix)."""
    c = dct_matrix(8)
    m = np.zeros((dim, dim), np.float32)
    for b in range(dim // 8):
        m[b * 8:(b + 1) * 8, b * 8:(b + 1) * 8] = c
    return m


def _residual_plane(q: torch.Tensor, qtab: torch.Tensor,
                    planar: bool) -> torch.Tensor:
    """Zigzagged quantized (BH, BW, 64) coefficients → the residual plane,
    through the formulation the encoder used (header flags bit 3)."""
    if not planar:
        return plane_idct(dequantize(zigzag_unflatten(q.to(torch.float32)),
                                     qtab))
    cp = unblockize(zigzag_unflatten(q.to(torch.int32)))
    h, w = cp.shape[-2:]
    x = cp.to(torch.float32) * quant_map(qtab, h, w)
    bh = torch.as_tensor(_bd_dct_matrix(h), device=q.device)
    bw = torch.as_tensor(_bd_dct_matrix(w), device=q.device)
    return bh.T @ x @ bw


class FvcDecoder:
    """Decode FVC chunks back to RGB frames: native scan decode on the
    host, reconstruction in plain PyTorch on ``device``. Reads version 1
    and version 2 chunks with P and B frames (header flags bits 0, 1, 3
    and 5); half-pel vectors (bit 2), coded-size extensions (bit 4) and
    4:4:4 raise ``NotImplementedError``."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    @staticmethod
    def parse_chunk(data: bytes):
        """Header walk of one chunk → (header dict: ``version``, ``flags``,
        ``width``, ``height``, ``quality``, ``search_range``,
        ``bquality``; per frame (frame_type, vectors, payload)). Vectors
        are None for an intra frame, (H/16, W/16, 2) int8 for a P frame,
        and (fwd, bwd, modes (H/16, W/16) int8) for a B frame."""
        if data[:4] != MAGIC:
            raise ValueError("not an FVC chunk")
        if len(data) < 12:
            raise ValueError("truncated FVC chunk header")
        version, flags, w, h, quality, f = struct.unpack(">BBHHBB",
                                                         data[4:12])
        if not flags & 1:
            raise NotImplementedError("4:4:4 FVC chunks are not ported yet")
        if flags & 16:
            raise NotImplementedError("FVC coded-size extensions are not "
                                      "ported yet")
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        if ph == 0 or pw == 0:
            raise ValueError("zero-sized FVC chunk")
        mbh, mbw = ph // 16, pw // 16
        mbn = mbh * mbw
        off = 12
        search_range = 7
        if version >= 2:
            if len(data) < 13:
                raise ValueError("truncated FVC v2 header")
            search_range = data[12]
            off = 13
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
        if flags & 4:
            if version >= 2 and any(t == 2 for t, _, _ in frames):
                raise ValueError("B frames with subpel vectors are not a "
                                 "valid stream")
            raise NotImplementedError("FVC half-pel vectors are not ported "
                                      "yet")
        header = {"version": version, "flags": flags, "width": w,
                  "height": h, "quality": quality,
                  "search_range": search_range, "bquality": bquality}
        return header, frames

    def decode_chunk(self, data: bytes) -> Tuple[np.ndarray, dict]:
        """One chunk → ((F, H, W, 3) uint8 frames, info with ``quality``,
        ``types`` (0 = I, 1 = P, 2 = B), ``width``, ``height``)."""
        hdr, frames = self.parse_chunk(data)
        h, w, quality = hdr["height"], hdr["width"], hdr["quality"]
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        planes = []
        for i, (_, _, payload) in enumerate(frames):
            coefs = decode_scan_to_coefs(payload, pw // 8, ph // 8, pw // 16,
                                         ph // 16, True)
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
            y, cb, cr = self._reconstruct_mc_b(
                ry, rcb, rcr, mvs, types, qy, qc, *tables(hdr["bquality"]),
                planar=planar)
            frames = _to_rgb8(y, cb, cr)
        elif hdr["version"] >= 2:
            frames = _to_rgb8(*self._reconstruct_mc(ry, rcb, rcr, mvs, qy,
                                                    qc, planar=planar))
        else:
            frames = coefs_to_rgb(*fvc_accumulate(ry, rcb, rcr), qy, qc, h,
                                  w)
        frames = frames[:, :h, :w].cpu().numpy()
        return frames, {"quality": quality, "types": types, "width": w,
                        "height": h}

    @staticmethod
    def _reconstruct_mc(ry, rcb, rcr, mvs, qy, qc, planar: bool):
        """v2 P-only frames → (Y, Cb, Cr) planes: vectors as an (F, H/16,
        W/16, 2) array, frames without vectors intra, then the in-loop
        reconstruction."""
        mbh, mbw = ry.shape[1] // 2, ry.shape[2] // 2
        mv_arr = np.zeros((len(mvs), mbh, mbw, 2), np.int8)
        itypes = np.zeros(len(mvs), np.int8)
        for i, mv in enumerate(mvs):
            if mv is None:
                itypes[i] = 1
            else:
                mv_arr[i] = mv
        return fvc_mc_decode_chunk(
            ry, rcb, rcr, torch.from_numpy(mv_arr).to(ry.device),
            torch.from_numpy(itypes), qy, qc, planar=planar)

    @classmethod
    def _reconstruct_mc_b(cls, ry, rcb, rcr, mvs, types, qy, qc, qy_b, qc_b,
                          planar: bool):
        """B-frame chunk → (Y, Cb, Cr) planes in display order: the
        anchors through the P reconstruction, then each B frame by pure
        selection from its anchor pair (per macroblock average / forward /
        backward / flat 128) plus its residual at the bquality tables."""
        a_idx = [i for i, t in enumerate(types) if t != 2]
        b_idx = [i for i, t in enumerate(types) if t == 2]
        if not a_idx or b_idx[0] < a_idx[0] or b_idx[-1] > a_idx[-1]:
            raise ValueError("B frame without surrounding anchor frames")
        ay, acb, acr = cls._reconstruct_mc(ry[a_idx], rcb[a_idx], rcr[a_idx],
                                           [mvs[i] for i in a_idx], qy, qc,
                                           planar)
        out = []
        for j in b_idx:
            p = max(k for k, a in enumerate(a_idx) if a < j)
            fwd, bwd, mode = (torch.from_numpy(np.asarray(m, np.int32))
                              .to(ry.device) for m in mvs[j])
            mode_y, mode_c = _repeat_blocks(mode, MB), _repeat_blocks(mode, 8)
            pf, pb = motion_compensate(ay[p], fwd), \
                motion_compensate(ay[p + 1], bwd)
            planes = [_select_mode(mode_y, (pf + pb) * 0.5, pf, pb)]
            for a in (acb, acr):
                fc = motion_compensate(a[p], fwd, mb=8)
                bc = motion_compensate(a[p + 1], bwd, mb=8)
                planes.append(_select_mode(mode_c, (fc + bc) * 0.5, fc, bc))
            out.append(tuple(
                (pred + _residual_plane(q[j], t, planar)).clamp(0.0, 255.0)
                for pred, q, t in zip(planes, (ry, rcb, rcr),
                                      (qy_b, qc_b, qc_b))))
        perm = torch.as_tensor(np.argsort(np.asarray(a_idx + b_idx)),
                               device=ry.device)
        return tuple(torch.cat([a, torch.stack(b)])[perm]
                     for a, b in zip((ay, acb, acr), zip(*out)))


def _to_rgb8(y, cb, cr) -> torch.Tensor:
    """(F, H, W) and (F, H/2, W/2) x 2 planes → (F, H, W, 3) uint8 RGB."""
    rgb = i420_to_rgb(y, cb, cr)
    return (rgb + 0.5).clamp(0, 255).to(torch.uint8)


def fvc_mc_decode_chunk(ry, rcb, rcr, mvs, itypes, qy, qc,
                        search_range: int = 7, planar: bool = False):
    """The encoder's in-loop reconstruction, frame by frame.

    ry/rcb/rcr: (F, BH, BW, 64) zigzagged residual coefficients; mvs
    (F, H/16, W/16, 2) integer vectors; itypes (F,) — nonzero where the
    frame is intra (flat-128 prediction; frame 0 always is). ``planar``
    is header flags bit 3. Returns the (F, H, W), (F, H/2, W/2) x 2
    float32 planes. ``search_range`` is accepted for the reference's
    signature."""
    out = []
    rec = None
    for i in range(ry.shape[0]):
        if i == 0 or int(itypes[i]):
            pred = (128.0, 128.0, 128.0)
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
        PropertySpec("engine", "auto", "auto | device: entropy coding always "
                                       "runs on the device here"),
        PropertySpec("search", "full", "full | hier motion estimation "
                                       "(hier = coarse-to-fine)"),
        PropertySpec("subpel", False, "half-pel motion (not ported yet)"),
        PropertySpec("bframes", 0, "B frames between anchors (motion mode "
                                   "only): bidirectional per-macroblock "
                                   "prediction from the surrounding "
                                   "reconstructed anchors"),
        PropertySpec("bitrate", 0, "target bits/sec; 0 = constant quality "
                                   "(rate control is not ported yet)"),
        PropertySpec("segmented", "auto", "bitstream layout of the device "
                     "stage: auto (FLUTPU_SEGMENTED, else segments) | true "
                     "| false (per-block pack); the bytes are the same"),
        PropertySpec("device", "cuda", "torch device the encode runs on "
                     "(cuda, cuda:N, or cpu for the plain versions)"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._encoder: Optional[FvcEncoder] = None
        self._pending: List[Buffer] = []
        self._chunk_gop: Optional[int] = None

    def _enc(self) -> FvcEncoder:
        if self._encoder is None:
            if int(self.get_property("bitrate")) > 0:
                raise NotImplementedError("cudafvcenc: bitrate (rate control) "
                                          "is not ported yet")
            self._encoder = FvcEncoder(
                int(self.get_property("quality")),
                motion=bool(self.get_property("motion")),
                search_range=int(self.get_property("search-range")),
                engine=str(self.get_property("engine")),
                hier=str(self.get_property("search")) == "hier",
                subpel=bool(self.get_property("subpel")),
                segmented=segmented_property(self.get_property("segmented")),
                bframes=int(self.get_property("bframes")),
                device=str(self.get_property("device")))
        return self._encoder

    def do_set_property(self, name, value):
        self._encoder = None  # rebuild with the new settings

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

    def _flush_chunk(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        frames = np.stack([np.asarray(b.data) for b in batch])
        chunk = self._enc().encode_chunk(frames)
        first, last = batch[0], batch[-1]
        duration = None
        if first.pts is not None and last.pts is not None:
            duration = last.pts - first.pts + (last.duration or 0)
        out = Buffer(chunk, pts=first.pts, dts=first.dts, duration=duration,
                     offset=first.offset)
        out.meta["n_frames"] = len(batch)
        out.meta["frame_pts"] = [b.pts for b in batch]
        self.srcpad.push(out)
