"""The scan stage of the port's encoders: quantized coefficient planes →
one byte-stuffed baseline scan per frame (the entropy stage of flutpu's
``JpegEncoder``, which its FVC encoder shares).

``ScanCoder`` holds what decides how a dispatch's scans are coded, sized,
brought back and finished: the quantization tables on the device, the
bitstream layout (``segmented``), the engine, and the adaptive sizes.
``JpegEncoder`` and ``FvcEncoder`` each hold one.

``ScanCoder.dispatch(program, ph, pw)`` enqueues a dispatch's work and
returns its result, one kind per engine, each answering ``finalize()``
with the frames' scans and the words that follow each frame's scan:

- the device engine (``DeviceScans``): MCU order and DC prediction, then
  the pack of the bitstream layout at the adaptive sizes, and one copy
  of each frame's combined row into pinned memory. Segments (the
  default): the segment Huffman pack kernel (K2), then word-aligned
  segment placement, which the host compacts into the exact scan; blocks
  (``segmented=False``): the per-block pack kernel (K7, or the merged
  slot tables and K8a under ``FLUTPU_NO_FUSED_PACK=1``), then the block
  concat into the bit-contiguous scan on the device. Finalize waits for
  the copy, checks the usage the kernels report (an overflow is
  redispatched once at the reported need, up to the theoretical bounds;
  nothing is ever truncated), records it for the next dispatch and
  byte-stuffs the scans;
- the host engine (``HostScans``): one copy of the int16 coefficient
  planes into pinned memory; finalize codes the frames on the host with
  the native coder (``flu_jpeg_encode_scan``, ``encode_scan``) in a
  thread pool across frames. The bytes are the device engine's.

A frame's combined row (uint32 words): segments, [0] = aligned words,
[1..S] = segment bits, [S+1..S+prefix] = word-aligned stream; blocks (S
= 0), [0] = bits, [1..prefix] = the stream; then the words a caller
appends after the scan (the FVC encoder's vectors and frame type).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..core.env import env_flag
from ..core.log import SPAN_PREFIX, trace_span
from . import jpeg_tables as T
from .convert import encoder_state_from_numpy
from .ops.entropy import (compact_segments_finalize, encode_gop_scans_layout,
                          mcu_layout, stuff_and_finalize)
from .ops.quant import CHROMA_QTABLE, LUMA_QTABLE, scale_qtable

ENGINES = ("auto", "device", "host")


def pad_to(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def resolve_segmented(explicit: Optional[bool]) -> bool:
    """The bitstream layout: the explicit argument, else
    ``FLUTPU_SEGMENTED`` (``0``/``false``/``no`` off, anything else on),
    else segments. (flutpu defaults to blocks on the CPU, where its
    grouped kernel cannot lower; the port's kernels run on every device,
    and the bytes are the same either way.)"""
    if explicit is not None:
        return bool(explicit)
    env = env_flag("FLUTPU_SEGMENTED")
    return True if env is None else env


# ----------------------------------------------------------------------------
# host: one frame's scan (copies of flutpu.codec.jpeg's scan coders)
# ----------------------------------------------------------------------------

def encode_scan_python(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                       subsample: bool) -> bytes:
    """Pure-Python scan encoder (MCU-interleaved, DC-predicted): the plain
    version the native coder is held against, and ``encode_scan``'s
    fallback where the native library is absent."""
    tabs = T.code_tables()
    dcl, acl = tabs["dc_luma"], tabs["ac_luma"]
    dcc, acc = tabs["dc_chroma"], tabs["ac_chroma"]
    out = bytearray()
    acc_bits = 0
    nbits = 0

    def put(code: int, length: int):
        nonlocal acc_bits, nbits
        acc_bits = (acc_bits << length) | (code & ((1 << length) - 1))
        nbits += length
        while nbits >= 8:
            nbits -= 8
            b = (acc_bits >> nbits) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0x00)
        acc_bits &= (1 << nbits) - 1

    def block(z: np.ndarray, pred: int, dct_tab, act_tab) -> int:
        dc = int(z[0])
        diff = dc - pred
        s = abs(diff).bit_length()
        c, l = dct_tab[s]
        put(c, l)
        if s:
            put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        for k in range(1, 64):
            v = int(z[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                c, l = act_tab[0xF0]
                put(c, l)
                run -= 16
            sz = abs(v).bit_length()
            c, l = act_tab[(run << 4) | sz]
            put(c, l)
            put(v if v >= 0 else v + (1 << sz) - 1, sz)
            run = 0
        if run:
            c, l = act_tab[0x00]
            put(c, l)
        return dc

    py = pcb = pcr = 0
    ybh, ybw = y.shape[:2]
    if subsample:
        for my in range(ybh // 2):
            for mx in range(ybw // 2):
                for sy in range(2):
                    for sx in range(2):
                        py = block(y[2 * my + sy, 2 * mx + sx], py, dcl, acl)
                pcb = block(cb[my, mx], pcb, dcc, acc)
                pcr = block(cr[my, mx], pcr, dcc, acc)
    else:
        for by in range(ybh):
            for bx in range(ybw):
                py = block(y[by, bx], py, dcl, acl)
                pcb = block(cb[by, bx], pcb, dcc, acc)
                pcr = block(cr[by, bx], pcr, dcc, acc)
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)
    return bytes(out)


@functools.lru_cache()
def _native_tables():
    """The four code tables as contiguous (codes uint32, lengths uint8)
    arrays for the native coder."""
    return {name: (np.ascontiguousarray(codes), np.ascontiguousarray(lengths))
            for name, (codes, lengths) in T.code_arrays().items()}


def _encode_scan_native(lib, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                        subsample: bool) -> Optional[bytes]:
    """``flu_jpeg_encode_scan`` of one frame's contiguous int16 planes;
    None where the coder refuses them."""
    tabs = _native_tables()
    ybh, ybw = y.shape[:2]
    cbh, cbw = cb.shape[:2]
    cap = y.nbytes + cb.nbytes + cr.nbytes + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    c = ctypes

    def i16p(a):
        return a.ctypes.data_as(c.POINTER(c.c_int16))

    def tp(name):
        codes, lengths = tabs[name]
        return (codes.ctypes.data_as(c.POINTER(c.c_uint32)),
                lengths.ctypes.data_as(c.POINTER(c.c_uint8)))

    dcl, acl = tp("dc_luma"), tp("ac_luma")
    dcc, acc = tp("dc_chroma"), tp("ac_chroma")
    n = lib.flu_jpeg_encode_scan(
        i16p(y), ybw, ybh, i16p(cb), i16p(cr), cbw, cbh,
        1 if subsample else 0, 3,
        dcl[0], dcl[1], acl[0], acl[1], dcc[0], dcc[1], acc[0], acc[1],
        out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def encode_scan(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                subsample: bool) -> bytes:
    """Entropy-code one frame's coefficient planes ((BH, BW, 64) int16
    each) on the host: the native coder, else the Python one (the same
    bytes)."""
    y, cb, cr = (np.ascontiguousarray(a, dtype=np.int16) for a in (y, cb, cr))
    lib = native.get_lib()
    if lib is not None:
        data = _encode_scan_native(lib, y, cb, cr, subsample)
        if data is not None:
            return data
    return encode_scan_python(y, cb, cr, subsample)


# ----------------------------------------------------------------------------
# dispatch results
# ----------------------------------------------------------------------------

class _HostCopy:
    """Device tensors' copies into pinned host memory, enqueued on the
    current stream and followed by one event; ``arrays()`` waits for it
    (CPU tensors pass through)."""

    def __init__(self, *ts: torch.Tensor):
        if ts[0].is_cuda:
            self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in ts]
            for buf, t in zip(self.bufs, ts):
                buf.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(ts[0].device))
        else:
            self.bufs, self.event = list(ts), None

    def arrays(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [b.numpy() for b in self.bufs]


class DeviceScans(NamedTuple):
    """A dispatch of the device engine: the frames' combined rows on their
    way into pinned memory, and the sizes they were packed at."""
    coder: "ScanCoder"
    copy: _HostCopy
    prefix: int
    prefix_bound: int         # theoretical words/frame of this geometry
    n_segs: int               # 0: the non-segment layout
    seg_words: Optional[int]  # None: the non-segment layout
    build: Optional[Callable]  # None once a redispatch was made

    def fetch(self) -> Tuple[np.ndarray, "DeviceScans"]:
        """Wait for the copy and check the usage it reports against the
        sizes it ran at; record the usage for the next dispatch. Returns
        (combined rows (F, X) uint32, the result they came from). On an
        overflow the device reported the true usage, so the same work is
        redispatched once at sizes that cover it, up to the theoretical
        bounds."""
        with trace_span(SPAN_PREFIX + "jpeg.fetch_wait"):
            arr = self.copy.arrays()[0].view(np.uint32)
        n = self.n_segs
        if n:
            used = arr[:, 0].astype(np.int64)
            segbits = arr[:, 1:1 + n].astype(np.int64)
            seg_over = (segbits > self.seg_words * 32).any()
        else:
            used = (arr[:, 0].astype(np.int64) + 31) // 32
            seg_over = False
        if (used > self.prefix).any() or seg_over:
            if self.build is None:
                raise OverflowError("redispatch at the device-reported size "
                                    "overflowed again")
            seg_need = None
            if seg_over:
                seg_need = (int(segbits.max()) + 31) // 32
            w_need = int(used.max())
            if w_need > self.prefix_bound or (
                    seg_need and seg_need > self.coder._seg_bound()):
                raise OverflowError(
                    f"entropy output beyond the theoretical bounds: {w_need} "
                    f"words/frame, {seg_need} words/segment")
            new_prefix, new_sw = self.coder._overflow_sizes(
                w_need, seg_need, self.prefix_bound)
            with trace_span(SPAN_PREFIX + "jpeg.redispatch"):
                copy, p, sw = self.build(max(new_prefix or 0, w_need),
                                         new_sw if n else None)
            return self._replace(copy=copy, prefix=p, seg_words=sw,
                                 build=None).fetch()
        self.coder._note_prefix_usage(int(used.max()), self.prefix_bound)
        if n:
            self.coder._note_seg_usage(int(segbits.max()))
        return arr, self

    def finalize(self) -> Tuple[List[bytes], np.ndarray]:
        """(one byte-stuffed scan per frame, the (F, K) uint32 words that
        follow each frame's scan in its row): the segments compacted, or
        the non-segment stream trimmed to its bit count."""
        arr, res = self.fetch()
        n, prefix = res.n_segs, res.prefix
        with trace_span(SPAN_PREFIX + "jpeg.compact"):
            if n:
                scans = [compact_segments_finalize(
                    row[1:1 + n], row[1 + n:1 + n + prefix]) for row in arr]
            else:
                scans = [stuff_and_finalize(row[1:1 + prefix], int(row[0]))
                         for row in arr]
        return scans, arr[:, 1 + n + prefix:]


class HostScans(NamedTuple):
    """A dispatch of the host engine: the (y, cb, cr) int16 coefficient
    planes, and any words to follow each frame's scan, on their way into
    pinned memory."""
    coder: "ScanCoder"
    copy: _HostCopy

    def finalize(self) -> Tuple[List[bytes], np.ndarray]:
        """(one scan per frame by the native coder, the (F, K) uint32 words
        that follow each frame's scan)."""
        y, cb, cr, *side = self.copy.arrays()
        scans = self.coder._code_on_host(y, cb, cr)
        return scans, (side[0].view(np.uint32) if side
                       else np.zeros((len(scans), 0), np.uint32))


# ----------------------------------------------------------------------------
# the scan coder
# ----------------------------------------------------------------------------

class ScanCoder:
    """The scan stage of one encoder on one device: its quantization
    tables (``qy_dev``, ``qc_dev`` on the device; ``qy``, ``qc`` as
    numpy), the bitstream layout of the device engine (``segmented``,
    ``resolve_segmented``; the bytes are the same in both), the engine
    (``"auto"`` and ``"device"`` code on the device and never leave it:
    flutpu's fallback to the host coder past its capacity ladder is not
    ported; ``"host"`` codes on the host) and the adaptive sizes of the
    device engine: the compressed-prefix window and the per-segment
    staging capacity follow the largest usage seen so far."""

    #: bits one baseline block can need at most, rounded up to whole
    #: words (the JAX encoder's CAP_LADDER[-1])
    BLOCK_BITS_BOUND = 1664
    _WORD_BUCKET = 16 * 1024
    #: blocks per segment and the per-segment staging capacity (words) a
    #: new encoder starts at
    SEG_G = 16
    SEG_WORDS0 = 64
    #: compressed-prefix words per frame before any usage is known
    PREFIX_WORDS = 32768
    _PREFIX_BUCKET = 2048

    def __init__(self, quality: int, subsample: bool, *, engine: str,
                 segmented: Optional[bool], device: torch.device):
        if engine not in ENGINES:
            raise ValueError(f"engine must be auto | device | host, got "
                             f"{engine!r}")
        self.engine = engine
        self.subsample = subsample
        self.device = device
        self.segmented = resolve_segmented(segmented)
        self._seg_words = self.SEG_WORDS0
        self._seg_used_words = 0
        self._seg_gops = 0
        self._prefix_used_words: Optional[int] = None
        self._prefix_window: Optional[int] = None
        #: the frames that usage was recorded at, by their prefix bound
        #: (one per block count)
        self._prefix_geometry: Optional[int] = None
        # adaptive state is read-modify-written by dispatch and by
        # finalize, which a caller may run on worker threads
        self._adapt_lock = threading.RLock()
        self.set_state(scale_qtable(LUMA_QTABLE, quality),
                       scale_qtable(CHROMA_QTABLE, quality))

    def set_state(self, qy, qc, seg_words: Optional[int] = None,
                  prefix_window: Optional[int] = None) -> None:
        """Code with (8, 8) quantization tables (array-likes) and, where
        given, the adaptive sizes (``encoder_state_from_numpy``'s)."""
        state = encoder_state_from_numpy(qy, qc, seg_words=seg_words,
                                         prefix_window=prefix_window,
                                         device=self.device)
        self.qy_dev, self.qc_dev = state.qy, state.qc
        self.qy = state.qy.cpu().numpy()
        self.qc = state.qc.cpu().numpy()
        if state.seg_words is not None:
            self._seg_words = state.seg_words
        if state.prefix_window is not None:
            self._prefix_window = state.prefix_window

    # -- adaptive sizing (host policy) ---------------------------------------
    def _prefix_target(self) -> Optional[int]:
        """Compressed-prefix window for the next dispatch, with
        hysteresis: keep the current window while usage stays ≥2% below
        it; when growing, jump to usage*1.15 + 512 rounded up a bucket.
        None until a usage is known."""
        used = self._prefix_used_words
        if used is None:
            return None
        w = self._prefix_window
        if w is not None and used * 1.02 + 128 <= w:
            return w
        est = int(used * 1.15) + 512
        est = ((est + self._PREFIX_BUCKET - 1)
               // self._PREFIX_BUCKET) * self._PREFIX_BUCKET
        return max(8192, est, w or 0)

    def _prefix_estimate(self) -> Optional[int]:
        """Adopt the target window now."""
        est = self._prefix_target()
        if est is not None:
            self._prefix_window = est
        return est

    def _note_prefix_usage(self, used_words: int, geometry: int) -> None:
        """Record actual usage as a running max over frames of one
        geometry (``geometry``: their prefix bound). Frames of another
        geometry start the record anew and drop the window learned at the
        last one."""
        with self._adapt_lock:
            if geometry != self._prefix_geometry:
                if self._prefix_geometry is not None:
                    self._prefix_window = None
                self._prefix_geometry = geometry
                self._prefix_used_words = None
            prev = self._prefix_used_words or 0
            self._prefix_used_words = max(prev, int(used_words))

    def _note_seg_usage(self, max_seg_bits: int) -> None:
        """Record the densest segment's usage (running max) and adopt the
        grown capacity for the next dispatch."""
        used_words = (int(max_seg_bits) + 31) // 32
        with self._adapt_lock:
            self._seg_used_words = max(self._seg_used_words, used_words)
            self._seg_gops += 1
            self._seg_words = self._seg_target()

    def _seg_target(self) -> int:
        """Staging capacity for the next dispatch — grow-only, doubling
        while the densest recorded segment exceeds 75% of capacity; during
        the first GOPs it covers 2x the observed usage. Capped at the
        theoretical bound of SEG_G blocks."""
        used = self._seg_used_words
        cap = self._seg_bound()
        target = self._seg_words
        while used * 4 > target * 3 and target < cap:
            target = min(pad_to(target * 2, 8), cap)
        if self._seg_gops <= 2 and used:
            target = min(cap, max(target, pad_to(2 * used, 8)))
        return target

    def _seg_bound(self) -> int:
        return pad_to(self.SEG_G * self.BLOCK_BITS_BOUND // 32, 8)

    def _prefix_cap(self, layout) -> int:
        """Geometry-scaled prefix window for a dispatch at a geometry whose
        usage is not known yet: ~1 word per block, and never above the
        theoretical bound."""
        geo = pad_to(max(self.PREFIX_WORDS, layout.n_blocks),
                     self._WORD_BUCKET)
        return min(geo, self._prefix_bound(layout))

    def _prefix_bound(self, layout) -> int:
        """Theoretical worst case of a frame's aligned stream: every
        block at BLOCK_BITS_BOUND bits. A baseline block needs at most 1660
        bits (22 DC + 63 x 26 AC), and the < 32 bits of alignment per
        segment of 16 blocks stay inside the 4 bits per block left over."""
        return pad_to(layout.n_blocks * self.BLOCK_BITS_BOUND // 32, 8)

    def _sizes(self, cap: int, bound: int):
        """The prefix window and segment capacity a dispatch starts at.
        The window is the one learned from the usage at this geometry
        (prefix bound ``bound``); at another geometry, or before any
        usage is known, it is at most ``cap``."""
        with self._adapt_lock:
            tgt = self._prefix_target()
            if tgt is not None:
                self._prefix_window = tgt
            self._seg_words = self._seg_target()
            win = self._prefix_window
            if self._prefix_geometry != bound:
                win = min(win or cap, cap)
            return win, self._seg_words

    def _overflow_sizes(self, used_words: int,
                        seg_need_words: Optional[int], geometry: int):
        """Grown sizes covering a device-reported need."""
        with self._adapt_lock:
            self._note_prefix_usage(int(used_words), geometry)
            if seg_need_words:
                self._seg_used_words = max(self._seg_used_words,
                                           int(seg_need_words))
            new_prefix = self._prefix_estimate()
            self._seg_words = max(self._seg_words, self._seg_target())
            return new_prefix, self._seg_words

    # -- dispatch ------------------------------------------------------------
    @property
    def mult(self) -> int:
        """The coded size's multiple: a 4:2:0 MCU is 16 pixels, 4:4:4's 8."""
        return 16 if self.subsample else 8

    def layout(self, ph: int, pw: int):
        """The MCU layout of a coded (ph, pw) frame."""
        if self.subsample:
            return mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
        return mcu_layout(pw // 8, ph // 8, pw // 8, ph // 8, False)

    def dispatch(self, program, ph: int, pw: int):
        """Enqueue ``program(pack)``: a dispatch's work on the device, which
        ends by returning ``pack(y, cb, cr, *side)`` of its frames'
        zigzagged quantized (F, BH, BW, 64) int16 coefficient planes,
        coded at (ph, pw), and of any (F, K) int32 words to follow each
        frame's scan. Returns the engine's result (``DeviceScans``: the
        pack at the adaptive sizes, whose overflow reruns ``program``;
        ``HostScans``: the planes' copy), for its ``finalize()``."""
        if self.engine == "host":
            def copy(y, cb, cr, *side):   # the planes and words as they are
                return _HostCopy(y, cb, cr,
                                 *([torch.cat(side, dim=1)] if side else []))
            return HostScans(self, program(copy))
        layout = self.layout(ph, pw)
        cap = self._prefix_cap(layout)
        bound = self._prefix_bound(layout)

        def build(prefix_w, sw):
            p = min(bound, prefix_w or cap)

            def pack(y, cb, cr, *side):
                combined = encode_gop_scans_layout(y, cb, cr, layout, p,
                                                   self.SEG_G, sw)
                return torch.cat([combined, *side], dim=1) if side \
                    else combined

            combined = program(pack)
            with trace_span(SPAN_PREFIX + "jpeg.copy"):
                return _HostCopy(combined), p, sw

        win, sw = self._sizes(cap, bound)
        n_segs = 0
        if self.segmented:
            n_segs = (layout.n_blocks + self.SEG_G - 1) // self.SEG_G
        else:
            sw = None
        copy, prefix, sw = build(win, sw)
        return DeviceScans(self, copy, prefix, bound, n_segs, sw, build)

    def _code_on_host(self, y: np.ndarray, cb: np.ndarray,
                      cr: np.ndarray) -> List[bytes]:
        """flutpu's host engine: (F, BH, BW, 64) int16 coefficient planes →
        one scan per frame by ``encode_scan``, threaded across ``min(F,
        8)`` workers where the native coder is there (it releases the
        GIL)."""
        f = y.shape[0]
        if f > 1 and native.get_lib() is not None:
            with ThreadPoolExecutor(max_workers=min(f, 8)) as pool:
                return list(pool.map(
                    lambda i: encode_scan(y[i], cb[i], cr[i],
                                          self.subsample), range(f)))
        return [encode_scan(y[i], cb[i], cr[i], self.subsample)
                for i in range(f)]
