"""Baseline JPEG / MJPEG encoder on the GPU (port of flutpu/codec/jpeg.py).

A 4:2:0 GOP of frames runs on the device as: edge pad to a multiple of
16 → the front-end kernel (optional burn-in of a BGRA subtitle overlay →
RGB→YCbCr → 4:2:0 → DCT → quantize → zigzag) → MCU order and DC
prediction → the entropy stage in one of two bitstream layouts, which
give the same bytes. A 4:4:4 GOP (``subsample=False``) pads to a
multiple of 8 and runs the plain PyTorch front end ``front_end_444`` in
the kernel's place (flutpu runs that arm as XLA, not as a Pallas
kernel), then the same entropy stage over one-block MCUs. The layouts:

- segments (the default): the segment Huffman pack kernel (K2), then
  word-aligned segment placement; the host compacts the segments into
  the exact scan;
- blocks (``segmented=False``): the per-block pack kernel (K7, or the
  merged slot tables and K8a under ``FLUTPU_NO_FUSED_PACK=1``), then the
  block concat into the bit-contiguous scan on the device.

One device→host copy per GOP brings back the per-frame bit counts and
the streams; the host byte-stuffs them and wraps the JFIF headers.

Dispatch and finalize are split so that a caller keeps GOPs in flight:
``encode_gop_dispatch`` (or ``_src``) enqueues the whole GOP on the
current CUDA stream and copies the result into a pinned host buffer,
recorded with a CUDA event; ``encode_gop_finalize`` waits on that event.

Sizes adapt to the content: the compressed-prefix window and the
per-segment staging capacity follow the largest usage seen so far. The
kernels report the true bit counts past their buffers, so an overflow is
redispatched once at the reported need, up to the theoretical bounds;
nothing is ever truncated.

``engine="host"`` (flutpu's host entropy engine) keeps the front end on
the device and copies the three int16 coefficient planes back once
instead of the packed bits; the native scan coder
(``flu_jpeg_encode_scan``, ``encode_scan``) then codes the frames on the
host, in a thread pool across frames. The bytes are the device engine's.
``"auto"`` and ``"device"`` code on the device; ``"auto"`` never leaves
it (flutpu's fallback to the host coder past its capacity ladder is not
ported: the port redispatches at the reported size).

``encode_gop_to_coefs`` and ``encode_gop_planes_to_coefs`` are the front
end alone (K1 on CUDA tensors), as flutpu's coefficient-level API.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..core.env import env_flag
from ..core.log import SPAN_PREFIX, trace_span
from . import jpeg_tables as T
from .convert import encoder_state_from_numpy
from .ops.entropy import (compact_segments_finalize, encode_gop_scans_layout,
                          mcu_layout, stuff_and_finalize)
from .ops.frontend import front_end, front_end_444
from .ops.quant import CHROMA_QTABLE, LUMA_QTABLE, scale_qtable, zigzag_order


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ----------------------------------------------------------------------------
# device program
# ----------------------------------------------------------------------------

def _edge_pad(p: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(..., H, W) → (..., ph, pw), repeating the last row and column
    (``jnp.pad(mode="edge")``)."""
    h, w = p.shape[-2:]
    if (h, w) == (ph, pw):
        return p.contiguous()
    rows = torch.arange(ph, device=p.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=p.device).clamp(max=w - 1)
    return p.index_select(-2, rows).index_select(-1, cols).contiguous()


def _planes_front_end(r, g, b, qy, qc, pad_h: int, pad_w: int,
                      overlay=None, subsample: bool = True):
    """(r, g, b) uint8 planes (F, H, W) → (y, cb, cr) int16 zigzagged
    quantized coefficients of the frames edge-padded to (pad_h, pad_w).
    4:2:0 (``subsample``): both multiples of 16, the front-end kernel
    (K1; a CUDA tensor launches it or raises). 4:4:4: multiples of 8, the
    plain PyTorch ``front_end_444`` on the planes' device, as flutpu runs
    its XLA arm there. ``overlay``: an (oh, ow, 4) uint8 BGRA window no
    larger than the padded frames, burned into every frame. The frames
    are padded first and blended second, on every device (the order of
    flutpu's kernel path; its CPU path blends an overlay of exactly the
    frames' size first and pads second)."""
    mult = 16 if subsample else 8
    if pad_h % mult or pad_w % mult:
        raise ValueError(f"padded size {(pad_h, pad_w)} is not a multiple "
                         f"of {mult}")
    r, g, b = (_edge_pad(p, pad_h, pad_w) for p in (r, g, b))
    if not subsample:
        return front_end_444(r, g, b, qy, qc, overlay)
    return front_end(r, g, b, qy, qc, overlay)


def encode_gop_planes_to_coefs(r, g, b, qy, qc, pad_h: int, pad_w: int,
                               subsample: bool = True):
    """(r, g, b) uint8 planes, each (F, H, W), edge-padded to (pad_h,
    pad_w) → (y, cb, cr) int16 zigzagged quantized coefficients (F, BH,
    BW, 64) (flutpu's ``encode_gop_planes_to_coefs``): 4:2:0 through the
    front-end kernel K1 (CUDA tensors launch it, CPU tensors take its
    plain version), 4:4:4 (``subsample=False``) through the plain
    ``front_end_444`` on the planes' device. Equal to flutpu's but for ±1
    at a rounding tie. ``qy``, ``qc``: (8, 8) tables (tensors or arrays)
    with entries 1..255. flutpu also takes float planes; the kernel reads
    u8, so other types raise ValueError."""
    planes = [torch.as_tensor(p) for p in (r, g, b)]
    for p in planes:
        if p.dtype != torch.uint8:
            raise ValueError(f"encode_gop_planes_to_coefs takes uint8 "
                             f"planes, got {p.dtype}")
    dev = planes[0].device
    return _planes_front_end(*planes, torch.as_tensor(qy, device=dev),
                             torch.as_tensor(qc, device=dev), pad_h, pad_w,
                             subsample=subsample)


def encode_gop_to_coefs(frames, qy, qc, pad_h: int, pad_w: int,
                        subsample: bool = True):
    """(F, H, W, 3) uint8 RGB → (y, cb, cr) int16 zigzagged quantized
    coefficients (F, BH, BW, 64) of the frames edge-padded to (pad_h,
    pad_w): ``encode_gop_planes_to_coefs`` of the three channels
    (flutpu's ``encode_gop_to_coefs``)."""
    t = torch.as_tensor(frames)
    return encode_gop_planes_to_coefs(t[..., 0], t[..., 1], t[..., 2], qy,
                                      qc, pad_h, pad_w, subsample)


# ----------------------------------------------------------------------------
# host: headers (copies of flutpu.codec.jpeg's writers)
# ----------------------------------------------------------------------------

def _marker(tag: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, tag, len(payload) + 2) + payload


def _dqt(qy: np.ndarray, qc: np.ndarray) -> bytes:
    zz = zigzag_order(8)
    payload = b""
    for tid, tab in ((0, qy), (1, qc)):
        payload += bytes([tid]) + bytes(int(v) for v in tab.flatten()[zz])
    return _marker(0xDB, payload)


def _sof0(h: int, w: int, subsample: bool) -> bytes:
    y_sampling = 0x22 if subsample else 0x11
    comps = [(1, y_sampling, 0), (2, 0x11, 1), (3, 0x11, 1)]
    payload = struct.pack(">BHHB", 8, h, w, len(comps))
    for cid, samp, tq in comps:
        payload += struct.pack(">BBB", cid, samp, tq)
    return _marker(0xC0, payload)


def _dht() -> bytes:
    payload = b""
    for tc_th, bits, vals in (
            (0x00, T.DC_LUMA_BITS, T.DC_LUMA_VALS),
            (0x10, T.AC_LUMA_BITS, T.AC_LUMA_VALS),
            (0x01, T.DC_CHROMA_BITS, T.DC_CHROMA_VALS),
            (0x11, T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)):
        payload += bytes([tc_th]) + bytes(bits) + bytes(vals)
    return _marker(0xC4, payload)


def _sos() -> bytes:
    payload = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return _marker(0xDA, payload)


_APP0 = _marker(0xE0, b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1) + b"\x00\x00")


def jpeg_headers(h: int, w: int, qy: np.ndarray, qc: np.ndarray,
                 subsample: bool) -> bytes:
    return (b"\xff\xd8" + _APP0 + _dqt(qy, qc) + _sof0(h, w, subsample)
            + _dht() + _sos())


# ----------------------------------------------------------------------------
# host: entropy coding (copies of flutpu.codec.jpeg's scan coders)
# ----------------------------------------------------------------------------

def _encode_scan_python(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
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
    return _encode_scan_python(y, cb, cr, subsample)


# ----------------------------------------------------------------------------
# public encoder
# ----------------------------------------------------------------------------

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


def segmented_property(value) -> Optional[bool]:
    """Map an element ``segmented`` property (auto/true/false, any case,
    or a bool) to the encoder argument (None = ``resolve_segmented``'s
    default). A copy of flutpu.codec.jpeg.segmented_property."""
    s = str(value).strip().lower()
    if s in ("auto", "", "none"):
        return None
    return s not in ("0", "false", "no")


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

    def numpy(self) -> np.ndarray:
        """The first tensor's words as uint32."""
        return self.arrays()[0].view(np.uint32)


class _Handle(NamedTuple):
    combined: _HostCopy
    prefix: int
    prefix_bound: int         # theoretical words/frame of this geometry
    n_segs: int               # 0: the non-segment layout
    seg_words: Optional[int]  # None: the non-segment layout
    build: Optional[object]   # None once a redispatch was made
    h: int
    w: int


class _HostHandle(NamedTuple):
    """A dispatch of the host engine: the (y, cb, cr) int16 coefficient
    planes on their way into pinned memory, and the frame size."""
    coefs: _HostCopy
    h: int
    w: int


ENGINES = ("auto", "device", "host")


class JpegEncoder:
    """GOP JPEG encoder on one device, 4:2:0 or (``subsample=False``)
    4:4:4.

    ``device`` is where the encode runs: a CUDA device launches the
    front-end kernel (4:2:0; 4:4:4 runs the plain ``front_end_444``
    there) and the pack kernels; ``"cpu"`` runs their plain PyTorch
    versions (tests, hosts without a card). ``segmented`` picks the
    bitstream layout of the device stage (``resolve_segmented``); the
    JFIF bytes are the same in both. ``engine``: ``"auto"`` or
    ``"device"`` code the scans on the device; ``"host"`` runs the front
    end there and the native scan coder on the host (``_scans_host``),
    with the same bytes."""

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

    def __init__(self, quality: int = 85, subsample: bool = True, *,
                 engine: str = "auto", segmented: Optional[bool] = None,
                 device="cuda"):
        if engine not in ENGINES:
            raise ValueError(f"engine must be auto | device | host, got "
                             f"{engine!r}")
        self.engine = engine
        self.device = torch.device(device)
        self.quality = quality
        self.subsample = bool(subsample)
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
        self._set_state(encoder_state_from_numpy(
            scale_qtable(LUMA_QTABLE, quality),
            scale_qtable(CHROMA_QTABLE, quality), device=self.device))

    @classmethod
    def from_numpy_state(cls, qy, qc, *, seg_words: Optional[int] = None,
                         prefix_window: Optional[int] = None,
                         segmented: Optional[bool] = None,
                         subsample: bool = True, engine: str = "auto",
                         device="cuda") -> "JpegEncoder":
        """An encoder running with given quantization tables and adaptive
        sizes (e.g. the JAX encoder's ``qy``, ``qc``, ``_seg_words``,
        ``_prefix_window``)."""
        enc = cls(subsample=subsample, engine=engine, segmented=segmented,
                  device=device)
        enc.quality = None
        enc._set_state(encoder_state_from_numpy(
            qy, qc, seg_words=seg_words, prefix_window=prefix_window,
            device=enc.device))
        return enc

    def _set_state(self, state) -> None:
        self._qy_dev, self._qc_dev = state.qy, state.qc
        self.qy = state.qy.cpu().numpy()
        self.qc = state.qc.cpu().numpy()
        if state.seg_words is not None:
            self._seg_words = state.seg_words
        if state.prefix_window is not None:
            self._prefix_window = state.prefix_window

    def encode_gop(self, frames) -> List[bytes]:
        """(F, H, W, 3) uint8 RGB (numpy or tensor) → one JFIF bytestream
        per frame."""
        t = torch.as_tensor(np.ascontiguousarray(frames)
                            if isinstance(frames, np.ndarray) else frames)
        t = t.to(self.device)
        f, h, w, _ = t.shape
        return self.encode_gop_finalize(self.encode_gop_dispatch(t, h, w))

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
            target = min(_pad_to(target * 2, 8), cap)
        if self._seg_gops <= 2 and used:
            target = min(cap, max(target, _pad_to(2 * used, 8)))
        return target

    def _seg_bound(self) -> int:
        return _pad_to(self.SEG_G * self.BLOCK_BITS_BOUND // 32, 8)

    def _prefix_cap(self, layout) -> int:
        """Geometry-scaled prefix window for a dispatch at a geometry whose
        usage is not known yet: ~1 word per block, and never above the
        theoretical bound."""
        geo = _pad_to(max(self.PREFIX_WORDS, layout.n_blocks),
                      self._WORD_BUCKET)
        return min(geo, self._prefix_bound(layout))

    def _prefix_bound(self, layout) -> int:
        """Theoretical worst case of a frame's aligned stream: every
        block at BLOCK_BITS_BOUND bits. A baseline block needs at most 1660
        bits (22 DC + 63 x 26 AC), and the < 32 bits of alignment per
        segment of 16 blocks stay inside the 4 bits per block left over."""
        return _pad_to(layout.n_blocks * self.BLOCK_BITS_BOUND // 32, 8)

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

    # -- dispatch / finalize ------------------------------------------------
    @property
    def mult(self) -> int:
        """The coded size's multiple: a 4:2:0 MCU is 16 pixels, 4:4:4's 8."""
        return 16 if self.subsample else 8

    def layout(self, ph: int, pw: int):
        """The MCU layout of a coded (ph, pw) frame."""
        if self.subsample:
            return mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
        return mcu_layout(pw // 8, ph // 8, pw // 8, ph // 8, False)

    def _run_sized(self, program, ph: int, pw: int):
        """Enqueue ``program(layout, prefix_words, seg_words)`` — a GOP's
        device work, returning its combined array (see
        encode_gop_scans_layout; ``seg_words`` None selects the
        non-segment layout) — at the adaptive sizes (``_sizes``), copied
        into pinned memory. Returns the handle fields (combined, prefix,
        prefix_bound, n_segs, seg_words, build); ``build(prefix_words,
        seg_words)`` reruns the same work at other sizes."""
        layout = self.layout(ph, pw)
        cap = self._prefix_cap(layout)
        bound = self._prefix_bound(layout)

        def build(prefix_w, sw):
            p = min(bound, prefix_w or cap)
            combined = program(layout, p, sw)
            with trace_span(SPAN_PREFIX + "jpeg.copy"):
                return _HostCopy(combined), p, sw

        win, sw = self._sizes(cap, bound)
        n_segs = 0
        if self.segmented:
            n_segs = (layout.n_blocks + self.SEG_G - 1) // self.SEG_G
        else:
            sw = None
        combined, prefix, sw = build(win, sw)
        return combined, prefix, bound, n_segs, sw, build

    def _fetch(self, handle):
        """Wait for a handle's copy and check the usage it reports against
        the sizes it ran at; record the usage for the next dispatch.
        Returns (combined words (F, X) uint32, the handle they came
        from). Column 0 is a frame's aligned words in the segment layout
        and its bits in the non-segment layout. On an overflow the device
        reported the true usage, so the same work is redispatched once at
        sizes that cover it, up to the theoretical bounds; nothing is ever
        truncated."""
        with trace_span(SPAN_PREFIX + "jpeg.fetch_wait"):
            arr = handle.combined.numpy()
        n = handle.n_segs
        if n:
            used = arr[:, 0].astype(np.int64)
            segbits = arr[:, 1:1 + n].astype(np.int64)
            seg_over = (segbits > handle.seg_words * 32).any()
        else:
            used = (arr[:, 0].astype(np.int64) + 31) // 32
            seg_over = False
        if (used > handle.prefix).any() or seg_over:
            if handle.build is None:
                raise OverflowError("redispatch at the device-reported size "
                                    "overflowed again")
            seg_need = None
            if seg_over:
                seg_need = (int(segbits.max()) + 31) // 32
            w_need = int(used.max())
            if w_need > handle.prefix_bound or (
                    seg_need and seg_need > self._seg_bound()):
                raise OverflowError(
                    f"entropy output beyond the theoretical bounds: {w_need} "
                    f"words/frame, {seg_need} words/segment")
            new_prefix, new_sw = self._overflow_sizes(
                w_need, seg_need, handle.prefix_bound)
            with trace_span(SPAN_PREFIX + "jpeg.redispatch"):
                combined, p, sw = handle.build(max(new_prefix or 0, w_need),
                                               new_sw if n else None)
            return self._fetch(handle._replace(
                combined=combined, prefix=p, seg_words=sw, build=None))
        self._note_prefix_usage(int(used.max()), handle.prefix_bound)
        if n:
            self._note_seg_usage(int(segbits.max()))
        return arr, handle

    @staticmethod
    def _scan_bytes(row: np.ndarray, n_segs: int, prefix: int) -> bytes:
        """One frame's byte-stuffed scan from its combined row (uint32):
        the segments compacted, or the non-segment stream trimmed to its
        bit count."""
        if n_segs:
            return compact_segments_finalize(row[1:1 + n_segs],
                                             row[1 + n_segs:1 + n_segs
                                                 + prefix])
        return stuff_and_finalize(row[1:1 + prefix], int(row[0]))

    def _dispatch(self, planes_fn, h: int, w: int, ph: int, pw: int,
                  overlay=None):
        ph, pw = _pad_to(ph, self.mult), _pad_to(pw, self.mult)
        if overlay is not None:
            overlay = torch.as_tensor(overlay).to(self.device)
        if self.engine == "host":
            coefs = _planes_front_end(*planes_fn(), self._qy_dev,
                                      self._qc_dev, ph, pw, overlay,
                                      self.subsample)
            return _HostHandle(_HostCopy(*coefs), h, w)

        # the overlay rides in the closure, so an overflow redispatch
        # blends it again
        def program(layout, prefix_words, seg_words):
            r, g, b = planes_fn()
            yq, cbq, crq = _planes_front_end(r, g, b, self._qy_dev,
                                             self._qc_dev, ph, pw, overlay,
                                             self.subsample)
            return encode_gop_scans_layout(yq, cbq, crq, layout,
                                           prefix_words, self.SEG_G,
                                           seg_words)

        return _Handle(*self._run_sized(program, ph, pw), h, w)

    def encode_gop_dispatch(self, frames_dev: torch.Tensor, h: int, w: int,
                            overlay=None):
        """Enqueue the device encode of a GOP resident on the encoder's
        device ((F, PH, PW, 3) uint8; edge-padded here to multiples of 16,
        of 8 for 4:4:4, if it is not already). Non-blocking; returns a
        handle for ``encode_gop_finalize``. ``h``, ``w`` are the frame size written
        in the headers. ``overlay``: an (oh, ow, 4) uint8 BGRA window
        (tensor or numpy, no larger than the padded frames) burned into
        every frame by the front-end kernel — subtitle burn-in and encode
        are one pass over the frames. With ``engine="host"`` the dispatch
        is the front end and the coefficient planes' copy into pinned
        memory; finalize codes the scans on the host."""
        ph, pw = frames_dev.shape[1], frames_dev.shape[2]
        return self._dispatch(
            lambda: (frames_dev[..., 0], frames_dev[..., 1],
                     frames_dev[..., 2]), h, w, ph, pw, overlay)

    def encode_gop_dispatch_src(self, src_fn, start, h: int, w: int,
                                ph: int, pw: int, overlay=None):
        """encode_gop_dispatch with an on-device frame source:
        ``src_fn(ph, pw, start)`` returns channel planes ``(r, g, b)``,
        each (F, ph, pw) uint8, or interleaved (F, ph, pw, 3) frames."""
        def planes():
            out = src_fn(ph, pw, start)
            if isinstance(out, (tuple, list)):
                return out
            return out[..., 0], out[..., 1], out[..., 2]

        return self._dispatch(planes, h, w, ph, pw, overlay)

    def encode_gop_finalize(self, handle) -> List[bytes]:
        """Blocking half: wait for the copy, then the scans
        (``scan_planes_finalize``), wrapped in the JFIF headers."""
        hdr = jpeg_headers(handle.h, handle.w, self.qy, self.qc,
                           self.subsample)
        return [hdr + scan + b"\xff\xd9"
                for scan in self.scan_planes_finalize(handle)]

    def _scans_host(self, coefs) -> List[bytes]:
        """flutpu's host engine: (y, cb, cr) (F, BH, BW, 64) int16
        coefficient planes (host arrays or tensors) → one scan per frame
        by ``encode_scan``, threaded across ``min(F, 8)`` workers where the
        native coder is there (it releases the GIL)."""
        yq, cbq, crq = (c.cpu().numpy() if isinstance(c, torch.Tensor)
                        else np.asarray(c) for c in coefs)
        f = yq.shape[0]
        if f > 1 and native.get_lib() is not None:
            with ThreadPoolExecutor(max_workers=min(f, 8)) as pool:
                return list(pool.map(
                    lambda i: encode_scan(yq[i], cbq[i], crq[i],
                                          self.subsample), range(f)))
        return [encode_scan(yq[i], cbq[i], crq[i], self.subsample)
                for i in range(f)]

    def scan_planes_dispatch(self, coefs):
        """Enqueue the entropy stage alone on already-quantized (F, BH,
        BW, 64) int16 zigzagged coefficient planes (y, cb, cr), on their
        device: MCU order, the pack kernel of the encoder's layout (K2, or
        K7 / K8a), one copy back, at the adaptive sizes with the overflow
        redispatch; with ``engine="host"`` the planes' copy into pinned
        memory. Returns a handle for ``scan_planes_finalize``."""
        yq, cbq, crq = coefs
        bh, bw = yq.shape[1], yq.shape[2]
        if self.engine == "host":
            return _HostHandle(_HostCopy(*(
                c if isinstance(c, torch.Tensor)
                else torch.from_numpy(np.array(c, np.int16))
                for c in coefs)), bh * 8, bw * 8)

        def program(layout, prefix_words, seg_words):
            return encode_gop_scans_layout(yq, cbq, crq, layout,
                                           prefix_words, self.SEG_G,
                                           seg_words)

        return _Handle(*self._run_sized(program, bh * 8, bw * 8), bh * 8,
                       bw * 8)

    def scan_planes_finalize(self, handle) -> List[bytes]:
        """Blocking half of ``scan_planes_dispatch`` (and of the GOP
        dispatches): one byte-stuffed baseline scan per frame, no JFIF
        wrapper. The device engine's combined layout per frame: segments
        [0] = aligned words, [1..S] = segment bits, [S+1..] = word-aligned
        stream; blocks [0] = bits, [1..] = the stream. The host engine's
        handle: the coefficient planes, coded by ``_scans_host``."""
        if isinstance(handle, _HostHandle):
            return self._scans_host(handle.coefs.arrays())
        arr, handle = self._fetch(handle)
        return [self._scan_bytes(row, handle.n_segs, handle.prefix)
                for row in arr]

    def scan_planes(self, coefs) -> List[bytes]:
        """Entropy-code already-quantized (F, BH, BW, 64) int16 zigzag
        coefficient planes to baseline scans, no JFIF wrapper (flutpu's
        ``JpegEncoder.scan_planes``), on the encoder's engine."""
        return self.scan_planes_finalize(self.scan_planes_dispatch(coefs))

    def encode_frame(self, frame: np.ndarray) -> bytes:
        return self.encode_gop(frame[None])[0]


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode with an independent decoder (Pillow), for the checks (a
    copy of flutpu.codec.jpeg.decode_jpeg)."""
    import io
    from PIL import Image
    img = Image.open(io.BytesIO(data))
    return np.asarray(img.convert("RGB"))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of two uint8 images (a copy of flutpu.codec.jpeg.psnr)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)
