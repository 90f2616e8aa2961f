"""JPEG entropy stage (port of flutpu/codec/ops/entropy.py): the
segment layout and the non-segment (block) layout.

Segment layout, device half, plain PyTorch around the pack kernel:

1. ``_mcu_blocks``: MCU reorder of the zigzagged coefficient planes and
   DC prediction per component, per frame;
2. ``pack_segments`` (ops/entropy_kernels.py, the CUDA kernel K2):
   Huffman coding of ``seg_g`` consecutive blocks into one bit segment;
3. ``_concat_segments_aligned``: every segment placed at the next 32-bit
   word boundary of the frame's stream.

``encode_gop_scans_segmented`` runs the three and returns one combined
array per frame; the host half (``compact_segments_finalize``) merges the
word-aligned segments into the exact bitstream and byte-stuffs it with
the native library.

Non-segment layout (``encode_gop_scans``, and
``encode_gop_scans_combined`` for the encoders' one copy): after
``_mcu_blocks``, each block is Huffman-coded into its own 64-word buffer
(``pack_block_bits_fused``, K7; or, under ``FLUTPU_NO_FUSED_PACK=1``,
``_slot_tables_merged`` and ``pack_block_bits64``, K8a), and
``_concat_blocks_v3`` joins the blocks into the bit-contiguous stream on
the device; the host only byte-stuffs it (``stuff_and_finalize``). The
32-bit slot tables (``_slot_tables``) feed K8b, which no encoder path
runs. flutpu's other concat formulations (v1, v2, v4, v5) are not
ported, and ``FLUTPU_CONCAT`` is not read.

The slot and concat arithmetic runs in int64: torch on the CPU has no
uint32 shifts or compares. The layout and the table logic are copies of
the original, which cannot be imported without jax.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import jpeg_tables as T
from ...core.env import env_flag
from .constants import on_device
from .entropy_kernels import (BLOCK_WORDS, _as_word_bits, _magnitude,
                              _tables, pack_block_bits64,
                              pack_block_bits_fused, pack_segments)

#: blocks per chunk of the slot-table computation (bounds its memory)
_SLOT_CHUNK = 1 << 18
_WORD_MASK = 0xFFFFFFFF


class McuLayout:
    """Static (per geometry) index maps for MCU-ordered processing.
    Copy of flutpu.codec.ops.entropy.McuLayout."""

    __slots__ = ("block_sel", "comp_is_chroma", "prev_same_comp",
                 "n_blocks", "max_span", "_key")

    def __init__(self, block_sel, comp_is_chroma, prev_same_comp,
                 n_blocks, key):
        self.block_sel = block_sel          # (B,) into concat [Y|Cb|Cr]
        self.comp_is_chroma = comp_is_chroma  # (B,) 0/1
        self.prev_same_comp = prev_same_comp  # (B,) prev same-comp idx, -1 first
        self.n_blocks = n_blocks
        self.max_span = _layout_max_span(comp_is_chroma)
        self._key = key

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, McuLayout) and self._key == other._key

    def __repr__(self):
        return f"McuLayout{self._key}"


@functools.lru_cache()
def _min_block_bits() -> Tuple[int, int]:
    """Provable minimum bits of one encoded block, per component class."""
    dc_code, dc_len, ac_code, ac_len = _device_tables()
    mins = []
    for comp in range(2):
        dc_min = min(int(dc_len[comp, s]) + s for s in range(12))
        tail_min = int(ac_len[comp, 0x00])  # EOB
        for run in range(16):
            for size in range(1, 11):
                tail_min = min(tail_min,
                               int(ac_len[comp, (run << 4) | size]) + size)
        mins.append(dc_min + tail_min)
    return mins[0], mins[1]


def _layout_max_span(comp_is_chroma: np.ndarray) -> int:
    """Max blocks overlapping one 32-bit word for this MCU comp sequence."""
    luma_min, chroma_min = _min_block_bits()
    minbits = np.where(np.asarray(comp_is_chroma) > 0, chroma_min,
                       luma_min).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(minbits)])
    ends = np.searchsorted(cum, cum[:-1] + 31, side="right")
    return int((ends - np.arange(len(minbits))).max()) + 1


@functools.lru_cache(maxsize=32)
def mcu_layout(ybw: int, ybh: int, cbw: int, cbh: int,
               subsample: bool) -> McuLayout:
    """Block processing order of a baseline interleaved scan.

    4:2:0 MCU = 4 Y (2x2) + Cb + Cr; 4:4:4 MCU = Y + Cb + Cr. Y blocks
    occupy rows [0, ybw*ybh) of the concatenated coefficient array, Cb the
    next cbw*cbh, then Cr.
    """
    order = []
    comp = []
    y_base, cb_base = 0, ybw * ybh
    cr_base = cb_base + cbw * cbh
    if subsample:
        for my in range(ybh // 2):
            for mx in range(ybw // 2):
                for sy in range(2):
                    for sx in range(2):
                        order.append(y_base + (2 * my + sy) * ybw + (2 * mx + sx))
                        comp.append(0)
                order.append(cb_base + my * cbw + mx)
                comp.append(1)
                order.append(cr_base + my * cbw + mx)
                comp.append(2)
    else:
        for by in range(ybh):
            for bx in range(ybw):
                order.append(y_base + by * ybw + bx)
                comp.append(0)
                order.append(cb_base + by * ybw + bx)
                comp.append(1)
                order.append(cr_base + by * ybw + bx)
                comp.append(2)
    order = np.asarray(order, dtype=np.int32)
    comp = np.asarray(comp, dtype=np.int32)
    prev = np.full(len(order), -1, dtype=np.int32)
    last: Dict[int, int] = {}
    for i, c in enumerate(comp):
        if int(c) in last:
            prev[i] = last[int(c)]
        last[int(c)] = i
    return McuLayout(order, (comp > 0).astype(np.int32), prev, len(order),
                     key=(ybw, ybh, cbw, cbh, subsample))


@functools.lru_cache()
def _device_tables():
    """Huffman tables as (2, 256) arrays [luma, chroma] for code and len."""
    arrs = T.code_arrays()
    dc_code = np.stack([arrs["dc_luma"][0], arrs["dc_chroma"][0]]).astype(np.int32)
    dc_len = np.stack([arrs["dc_luma"][1], arrs["dc_chroma"][1]]).astype(np.int32)
    ac_code = np.stack([arrs["ac_luma"][0], arrs["ac_chroma"][0]]).astype(np.int32)
    ac_len = np.stack([arrs["ac_luma"][1], arrs["ac_chroma"][1]]).astype(np.int32)
    return dc_code, dc_len, ac_code, ac_len


#: the dtype of each McuLayout index map on the device
_LAYOUT_DTYPES = {"block_sel": torch.long, "prev_same_comp": torch.long,
                  "comp_is_chroma": torch.int32}


def layout_table(layout: McuLayout, name: str,
                 device: torch.device) -> torch.Tensor:
    """The layout's index map ``name`` (``block_sel``, ``prev_same_comp``
    or ``comp_is_chroma``) on ``device``, uploaded once per geometry
    (``constants.on_device``)."""
    return on_device(("mcu", name, layout._key), getattr(layout, name),
                     device, _LAYOUT_DTYPES[name])


def _mcu_blocks(yq: torch.Tensor, cbq: torch.Tensor, crq: torch.Tensor,
                layout: McuLayout):
    """MCU reorder (a reshape/permute for the standard interleaves) + DC
    prediction per component, per frame. Returns (mcu (F, B, 64) int32
    DC-diffed blocks, comp (B,) int32)."""
    f = yq.shape[0]
    dev = yq.device
    ybw, ybh, cbw, cbh, subsample = layout._key
    y32 = yq.reshape(f, ybh, ybw, 64).to(torch.int32)
    cb32 = cbq.reshape(f, cbh, cbw, 64).to(torch.int32)
    cr32 = crq.reshape(f, cbh, cbw, 64).to(torch.int32)
    if subsample and ybh % 2 == 0 and ybw % 2 == 0:
        ym = y32.reshape(f, ybh // 2, 2, ybw // 2, 2, 64) \
            .permute(0, 1, 3, 2, 4, 5).reshape(f, -1, 4, 64)
        m = ym.shape[1]
        mcu = torch.cat([ym, cb32.reshape(f, m, 1, 64),
                         cr32.reshape(f, m, 1, 64)], dim=2).reshape(f, -1, 64)
    elif not subsample:
        mcu = torch.cat([y32.reshape(f, -1, 1, 64), cb32.reshape(f, -1, 1, 64),
                         cr32.reshape(f, -1, 1, 64)], dim=2).reshape(f, -1, 64)
    else:
        allb = torch.cat([y32.reshape(f, -1, 64), cb32.reshape(f, -1, 64),
                          cr32.reshape(f, -1, 64)], dim=1)
        mcu = allb[:, layout_table(layout, "block_sel", dev)]
    prev = layout_table(layout, "prev_same_comp", dev)
    dc = mcu[:, :, 0]
    prev_dc = torch.where(prev >= 0, dc[:, prev.clamp(min=0)],
                          torch.zeros_like(dc))
    mcu = torch.cat([(dc - prev_dc)[..., None], mcu[..., 1:]], dim=-1)
    return mcu, layout_table(layout, "comp_is_chroma", dev)


def _concat_segments_aligned(segbuf: torch.Tensor, segbits: torch.Tensor,
                             out_words: int):
    """Word-aligned segment placement, batched over frames.

    segbuf (F, S, C) int32 words, segbits (F, S) int32. Segment s starts
    at word fo[s] = sum of the earlier segments' word counts; output word
    w comes from the segment whose word range holds it (a sorted search
    over the running word ends) by one gather. Words past the stream, or
    past a segment's C staged words (a capacity overflow), are 0. Returns
    (out (F, out_words) int32, total_words (F,) int64)."""
    f, s_count, c = segbuf.shape
    wcnt = (segbits.to(torch.int64) + 31) >> 5
    ends = wcnt.cumsum(dim=1)
    fo = ends - wcnt
    total = ends[:, -1]
    w = torch.arange(out_words, dtype=torch.int64, device=segbuf.device)
    seg = torch.searchsorted(ends, w.expand(f, -1).contiguous(), right=True) \
        .clamp(max=s_count - 1)
    k = w - fo.gather(1, seg)
    valid = (w < total[:, None]) & (k < c)
    out = segbuf.reshape(f, s_count * c).gather(1, seg * c + k.clamp(0, c - 1))
    return torch.where(valid, out, torch.zeros_like(out)), total


def segment_blocks(yq: torch.Tensor, cbq: torch.Tensor, crq: torch.Tensor,
                   layout: McuLayout, seg_g: int = 16):
    """The pack kernel's input for a GOP: (zz (F * B', 64) int32 DC-diffed
    MCU-ordered blocks, comp (F * B',) int32), each frame padded with
    zero ``comp = -1`` blocks to B', a multiple of ``seg_g``, so segments
    never span frames."""
    f = yq.shape[0]
    mcu, comp = _mcu_blocks(yq, cbq, crq, layout)
    b = mcu.shape[1]
    b_pad = ((b + seg_g - 1) // seg_g) * seg_g
    if b_pad != b:
        mcu = torch.cat([mcu, mcu.new_zeros((f, b_pad - b, 64))], dim=1)
        comp = torch.cat([comp, comp.new_full((b_pad - b,), -1)])
    return mcu.reshape(f * b_pad, 64), comp.repeat(f)


def encode_gop_scans_segmented(yq: torch.Tensor, cbq: torch.Tensor,
                               crq: torch.Tensor, layout: McuLayout,
                               prefix_words: int, seg_g: int = 16,
                               seg_words: int = 64) -> torch.Tensor:
    """Segment-layout scan encode of (F, BH, BW, 64) int16 coefficient
    planes. Returns combined (F, 1 + S + prefix_words) int32 (uint32 bit
    patterns) per frame: [0] = aligned words used (prefix-overflow
    check), [1..S] = per-segment bit counts (capacity check + host
    compaction), [S+1..] = the word-aligned stream."""
    f = yq.shape[0]
    zz, comp = segment_blocks(yq, cbq, crq, layout, seg_g)
    s_per_frame = zz.shape[0] // (f * seg_g)
    segbuf, segbits = pack_segments(zz, comp, seg_g=seg_g,
                                    seg_words=seg_words)
    segbuf = segbuf.view(f, s_per_frame, seg_words)
    segbits = segbits.view(f, s_per_frame)
    out, total = _concat_segments_aligned(segbuf, segbits, prefix_words)
    return torch.cat([total.to(torch.int32)[:, None], segbits, out], dim=1)


# ----------------------------------------------------------------------------
# non-segment layout (device half)
# ----------------------------------------------------------------------------

def _slot_pieces(z: torch.Tensor, comp: torch.Tensor):
    """Shared symbol computation of both slot-table layouts, int64:
    (dc_len, dc_val, A_len, A_val, B_len, B_val, C_len, C_val, eob_len,
    eob_val); DC and EOB are (B,), the AC pieces (B, 63). Per AC
    position, slot A holds up to two ZRLs, slot B the third, slot C the
    (run, size) code and the extra bits."""
    dc_code_t, dc_len_t, ac_code_t, ac_len_t = _tables(z.device)
    z = z.to(torch.int64)
    b = z.shape[0]
    t = (comp == 1).long()
    zero = torch.zeros((), dtype=torch.int64, device=z.device)

    diff = z[:, 0]
    dsize = _magnitude(diff, 12)
    extra = torch.where(diff < 0, diff + (1 << dsize) - 1, diff)
    dc_slot_len = dc_len_t[t, dsize] + dsize
    dc_slot_val = (dc_code_t[t, dsize] << dsize) | (extra & ((1 << dsize) - 1))

    ac = z[:, 1:]
    k = torch.arange(1, 64, device=z.device)
    nz = ac != 0
    prev_incl = torch.cummax(torch.where(nz, k, zero), dim=1).values
    prev = torch.cat([prev_incl.new_zeros((b, 1)), prev_incl[:, :-1]], dim=1)
    run = k - prev - 1
    asize = _magnitude(ac, 11)
    zrl_count = torch.where(nz, run >> 4, zero)
    sym = ((run & 15) << 4) | asize
    ac_code = ac_code_t[t[:, None], sym]
    ac_len = ac_len_t[t[:, None], sym]
    aextra = torch.where(ac < 0, ac + (1 << asize) - 1, ac)

    zc = ac_code_t[t, 0xF0][:, None]
    zl = ac_len_t[t, 0xF0][:, None]
    c2 = zrl_count.clamp(max=2)
    slot_a_len = torch.where(nz, c2 * zl, zero)
    slot_a_val = torch.where(c2 == 2, (zc << zl) | zc,
                             torch.where(c2 == 1, zc, zero))
    slot_b_len = torch.where(nz & (zrl_count >= 3), zl, zero)
    slot_b_val = torch.where(slot_b_len > 0, zc, zero)
    slot_c_len = torch.where(nz, ac_len + asize, zero)
    slot_c_val = torch.where(
        nz, (ac_code << asize) | (aextra & ((1 << asize) - 1)), zero)

    eob_needed = prev_incl[:, -1] < 63
    eob_len = torch.where(eob_needed, ac_len_t[t, 0x00], zero)
    eob_val = torch.where(eob_needed, ac_code_t[t, 0x00], zero)
    return (dc_slot_len, dc_slot_val, slot_a_len, slot_a_val, slot_b_len,
            slot_b_val, slot_c_len, slot_c_val, eob_len, eob_val)


def _chunked(fn, zz: torch.Tensor, comp: torch.Tensor):
    """``fn`` over blocks in chunks of ``_SLOT_CHUNK``, outputs joined."""
    outs = [fn(zz[i:i + _SLOT_CHUNK], comp[i:i + _SLOT_CHUNK])
            for i in range(0, max(1, zz.shape[0]), _SLOT_CHUNK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _slot_tables(zz: torch.Tensor, comp: torch.Tensor):
    """Per-block 32-bit slot tables (K8b's input): zz (B, 64) DC-diffed
    MCU-ordered coefficients, comp (B,) 0 luma / 1 chroma → (lens, vals)
    (B, 191) int32: DC, then slots A, B, C per AC position, then EOB.
    Every value holds exactly its length's bits (≤ 26)."""
    def tables(z, c):
        dl, dv, la, va, lb, vb, lc, vc, el, ev = _slot_pieces(z, c)
        b = z.shape[0]
        lens = torch.cat([dl[:, None], torch.stack([la, lb, lc], dim=-1)
                          .reshape(b, -1), el[:, None]], dim=1)
        vals = torch.cat([dv[:, None], torch.stack([va, vb, vc], dim=-1)
                          .reshape(b, -1), ev[:, None]], dim=1)
        return lens.to(torch.int32), vals.to(torch.int32)
    return _chunked(tables, zz, comp)


def _slot_tables_merged(zz: torch.Tensor, comp: torch.Tensor):
    """Merged-slot tables (K8a's input): per AC position the up-to-three
    codes of ``_slot_tables`` composed into one slot of at most 59 bits.
    Returns (lens, his, los) (B, 65) int32; the slot value is the low
    ``len`` bits of (hi << 32) | lo, hi and lo as uint32 bit patterns."""
    def tables(z, c):
        dl, dv, la, va, lb, vb, lc, vc, el, ev = _slot_pieces(z, c)
        v = (((va << lb) | vb) << lc) | vc          # ≤ 59 bits in int64
        zero = dv.new_zeros((z.shape[0], 1))
        lens = torch.cat([dl[:, None], la + lb + lc, el[:, None]], dim=1)
        his = torch.cat([zero, v >> 32, zero], dim=1)
        los = torch.cat([dv[:, None], v & _WORD_MASK, ev[:, None]], dim=1)
        return lens.to(torch.int32), _as_word_bits(his), _as_word_bits(los)
    return _chunked(tables, zz, comp)


def _concat_blocks_v3(buf: torch.Tensor, nbits: torch.Tensor,
                      out_words: int):
    """Block concatenation into bit-contiguous streams, batched over
    frames (scatter formulation of flutpu's ``_concat_blocks_v3``).

    buf (F, B, 64) int32 words MSB-first (every word written, bits past
    the block's count zero), nbits (F, B). The block containing word w's
    first bit is a cummax of a scatter-max of block indices into their
    ceiling words, its start bit likewise; blocks starting strictly
    inside a word add their first word's bits (disjoint, so ADD == OR);
    two gathers fetch the containing block's words. Targets past the
    window go to a junk column (flutpu's ``mode="drop"``). Returns (out
    (F, out_words) int32 words, total bits (F,) int64)."""
    f, b, _ = buf.shape
    dev = buf.device
    ends = nbits.to(torch.int64).cumsum(dim=1)
    starts = ends - nbits.to(torch.int64)
    total = ends[:, -1]

    def target(words):
        return torch.where(words < out_words, words,
                           torch.full_like(words, out_words))

    wce = target((starts + 31) >> 5)
    bidx = torch.arange(b, device=dev).expand(f, b)
    first = torch.full((f, out_words + 1), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce_(1, wce, bidx, "amax")[:, :out_words]
    first = torch.cummax(first, dim=1).values.clamp(0, b - 1)
    fo = torch.zeros((f, out_words + 1), dtype=torch.int64, device=dev) \
        .scatter_reduce_(1, wce, starts, "amax")[:, :out_words]
    fo = torch.cummax(fo, dim=1).values

    sh = starts & 31
    lead = (buf[:, :, 0].to(torch.int64) & _WORD_MASK) >> sh
    extra = torch.zeros((f, out_words + 1), dtype=torch.int64, device=dev) \
        .scatter_add_(1, target(starts >> 5),
                      torch.where(sh != 0, lead, torch.zeros_like(lead)))

    wbit = torch.arange(out_words, device=dev) << 5
    pos = wbit - fo
    p = pos & 31
    base = first * BLOCK_WORDS + (pos >> 5).clamp(0, BLOCK_WORDS - 1)
    flat = buf.reshape(f, b * BLOCK_WORDS)
    b0 = flat.gather(1, base).to(torch.int64) & _WORD_MASK
    b1 = flat.gather(1, (base + 1).clamp(max=b * BLOCK_WORDS - 1)) \
        .to(torch.int64) & _WORD_MASK
    inside = ((b0 << p) & _WORD_MASK) | (b1 >> (32 - p))   # >> 32 is 0
    out = torch.where(wbit < total[:, None], inside,
                      torch.zeros_like(inside)) + extra[:, :out_words]
    return _as_word_bits(out), total


def _resolve_pack_variant() -> bool:
    """The non-segment pack: K7 unless ``FLUTPU_NO_FUSED_PACK=1`` selects
    the merged slot tables and K8a (flutpu's ``_resolve_pack_variant``;
    the port has one concat)."""
    return not env_flag("FLUTPU_NO_FUSED_PACK", False)


def encode_gop_scans(yq: torch.Tensor, cbq: torch.Tensor, crq: torch.Tensor,
                     layout: McuLayout, out_words: int,
                     fused: Optional[bool] = None):
    """(F, BH, BW, 64) int16 coefficient planes → packed scan bits:
    MCU order and DC prediction, the per-block pack (``fused``: K7; else
    the merged slot tables and K8a; None: ``_resolve_pack_variant``), the
    block concat. Returns (packed (F, out_words) int32 holding uint32 bit
    patterns, the first ``out_words`` words of each frame's
    bit-contiguous scan; bits (F,) int32, every bit counted, also past
    ``out_words * 32``). CUDA tensors launch the kernels, CPU tensors
    take their plain versions. flutpu's ``use_pallas``, ``interpret``
    and ``concat`` choose among its TPU formulations and are not ported:
    the port has one of each."""
    if fused is None:
        fused = _resolve_pack_variant()
    f = yq.shape[0]
    mcu, comp = _mcu_blocks(yq, cbq, crq, layout)
    b = mcu.shape[1]
    flat = mcu.reshape(f * b, 64)
    comp_flat = comp.repeat(f)
    if fused:
        buf, nbits = pack_block_bits_fused(flat, comp_flat)
    else:
        buf, nbits = pack_block_bits64(*_slot_tables_merged(flat, comp_flat))
    packed, bits = _concat_blocks_v3(buf.view(f, b, BLOCK_WORDS),
                                     nbits.view(f, b), out_words)
    return packed, bits.to(torch.int32)


def encode_gop_scans_combined(yq: torch.Tensor, cbq: torch.Tensor,
                              crq: torch.Tensor, layout: McuLayout,
                              prefix_words: int) -> torch.Tensor:
    """Non-segment scan encode of (F, BH, BW, 64) int16 coefficient
    planes (``encode_gop_scans``) as one array for one copy: combined
    (F, 1 + prefix_words) int32 per frame, [0] = the frame's bit count,
    [1:] = the first ``prefix_words`` words of its bit-contiguous scan (a
    count above ``prefix_words * 32`` is an overflow: the caller
    redispatches at the reported size)."""
    packed, bits = encode_gop_scans(yq, cbq, crq, layout, prefix_words)
    return torch.cat([bits[:, None], packed], dim=1)


def encode_gop_scans_layout(yq: torch.Tensor, cbq: torch.Tensor,
                            crq: torch.Tensor, layout: McuLayout,
                            prefix_words: int, seg_g: int,
                            seg_words: Optional[int]) -> torch.Tensor:
    """The combined array of either layout: the segment layout at
    ``seg_words`` words of staging per segment, or the non-segment layout
    where ``seg_words`` is None (as flutpu's programs choose)."""
    if seg_words is None:
        return encode_gop_scans_combined(yq, cbq, crq, layout, prefix_words)
    return encode_gop_scans_segmented(yq, cbq, crq, layout, prefix_words,
                                      seg_g, seg_words)


# ----------------------------------------------------------------------------
# host half (copies of flutpu.codec.ops.entropy's numpy functions)
# ----------------------------------------------------------------------------

def compact_aligned_segments(seg_bits: np.ndarray, words: np.ndarray):
    """Merge word-aligned segments into the exact contiguous bitstream
    (vectorized numpy). seg_bits (S,) per-segment bit counts (zeros =
    padding segments), words (>= sum ceil(bits/32),) uint32. Returns
    (stream_words uint32, total_bits)."""
    seg_bits = np.asarray(seg_bits, np.int64)
    seg_bits = seg_bits[seg_bits > 0]
    if seg_bits.size == 0:
        return np.zeros(0, np.uint32), 0
    wcnt = (seg_bits + 31) >> 5
    src_end = np.cumsum(wcnt)
    total_bits = int(seg_bits.sum())
    bo = np.cumsum(seg_bits) - seg_bits            # dest bit offset/seg
    j = int(src_end[-1])
    seg_of = np.repeat(np.arange(len(seg_bits)), wcnt)
    k = np.arange(j, dtype=np.int64) - np.repeat(src_end - wcnt, wcnt)
    w = np.asarray(words[:j], np.uint32)
    p = (bo[seg_of] & 31).astype(np.uint32)
    d = ((bo[seg_of] >> 5) + k).astype(np.int64)
    hi = w >> p
    lo = np.where(p > 0, w << ((32 - p) & np.uint32(31)), 0) \
        .astype(np.uint32)
    # consecutive segments own disjoint bit ranges → OR == ADD, exact in
    # float64 for sums < 2^32
    n_out = int((total_bits + 31) // 32) + 1
    out = (np.bincount(d, weights=hi.astype(np.float64), minlength=n_out)
           + np.bincount(d + 1, weights=lo.astype(np.float64),
                         minlength=n_out))
    out = out.astype(np.uint64).astype(np.uint32)
    return out[:(total_bits + 31) // 32], total_bits


def stuff_and_finalize(words: np.ndarray, total_bits: int) -> bytes:
    """Trim, pad the final byte with 1-bits, 0xFF byte stuffing."""
    nbytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words).astype(">u4").tobytes()[:nbytes]
    arr = np.frombuffer(raw, dtype=np.uint8).copy()
    rem = int(total_bits) & 7
    if rem:
        arr[-1] |= (1 << (8 - rem)) - 1
    ff = arr == 0xFF
    if ff.any():
        out = np.zeros(len(arr) + int(ff.sum()), dtype=np.uint8)
        pos = np.arange(len(arr)) + np.cumsum(ff) - ff
        out[pos] = arr
        return out.tobytes()
    return arr.tobytes()


def compact_segments_finalize(seg_bits: np.ndarray,
                              words: np.ndarray) -> bytes:
    """compact_aligned_segments + stuff_and_finalize in one native pass
    (``flu_compact_segments_finalize``, GIL-free); the numpy pair when
    the native library is absent. Byte-identical either way."""
    from ...native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        sb = np.ascontiguousarray(seg_bits, dtype=np.uint32)
        w = np.ascontiguousarray(words, dtype=np.uint32)
        total_bits = int(sb.astype(np.int64).sum())
        cap = 2 * ((total_bits + 7) // 8) + 2
        out = np.empty(cap, np.uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = lib.flu_compact_segments_finalize(
            sb.ctypes.data_as(u32p), len(sb), w.ctypes.data_as(u32p),
            len(w), 1, out.ctypes.data_as(u8p), cap)
        if n >= 0:
            return out[:n].tobytes()
    stream, total = compact_aligned_segments(seg_bits, words)
    return stuff_and_finalize(stream, total)
