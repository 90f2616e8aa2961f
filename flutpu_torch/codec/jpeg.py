"""Baseline JPEG / MJPEG encoder on the GPU (port of flutpu/codec/jpeg.py).

A GOP of frames runs on the device as: edge pad to a multiple of 16 →
the front-end kernel (RGB→YCbCr → 4:2:0 → DCT → quantize → zigzag) → MCU
order and DC prediction → the entropy stage in one of two bitstream
layouts, which give the same bytes:

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
"""

from __future__ import annotations

import struct
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.env import env_flag
from . import jpeg_tables as T
from .convert import encoder_state_from_numpy
from .ops.entropy import (compact_segments_finalize, encode_gop_scans_layout,
                          mcu_layout, stuff_and_finalize)
from .ops.frontend import front_end
from .ops.quant import CHROMA_QTABLE, LUMA_QTABLE, scale_qtable, zigzag_order


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ----------------------------------------------------------------------------
# device program
# ----------------------------------------------------------------------------

def _edge_pad(p: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(F, H, W) → (F, ph, pw), repeating the last row and column
    (``jnp.pad(mode="edge")``)."""
    f, h, w = p.shape
    if (h, w) == (ph, pw):
        return p.contiguous()
    rows = torch.arange(ph, device=p.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=p.device).clamp(max=w - 1)
    return p[:, rows][:, :, cols].contiguous()


def _planes_front_end(r, g, b, qy, qc, pad_h: int, pad_w: int):
    """(r, g, b) uint8 planes (F, H, W) → (y, cb, cr) int16 zigzagged
    quantized coefficients of the frames edge-padded to (pad_h, pad_w),
    both multiples of 16."""
    if pad_h % 16 or pad_w % 16:
        raise ValueError(f"padded size {(pad_h, pad_w)} is not a multiple "
                         "of 16")
    r, g, b = (_edge_pad(p, pad_h, pad_w) for p in (r, g, b))
    return front_end(r, g, b, qy, qc)


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
    """A device tensor's copy into pinned host memory, enqueued on the
    current stream; ``numpy()`` waits for it (CPU tensors pass through)."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.buf.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.buf, self.event = t, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy().view(np.uint32)


class _Handle(NamedTuple):
    combined: _HostCopy
    prefix: int
    prefix_bound: int         # theoretical words/frame of this geometry
    n_segs: int               # 0: the non-segment layout
    seg_words: Optional[int]  # None: the non-segment layout
    build: Optional[object]   # None once a redispatch was made
    h: int
    w: int


class JpegEncoder:
    """GOP JPEG encoder on one device (4:2:0).

    ``device`` is where the encode runs: a CUDA device launches the
    front-end and pack kernels; ``"cpu"`` runs their plain PyTorch
    versions (tests, hosts without a card). ``segmented`` picks the
    bitstream layout of the device stage (``resolve_segmented``); the
    JFIF bytes are the same in both."""

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
                 segmented: Optional[bool] = None, device="cuda"):
        if not subsample:
            raise NotImplementedError(
                "the port encodes 4:2:0 only; 4:4:4 is not ported yet")
        self.device = torch.device(device)
        self.quality = quality
        self.subsample = True
        self.segmented = resolve_segmented(segmented)
        self._seg_words = self.SEG_WORDS0
        self._seg_used_words = 0
        self._seg_gops = 0
        self._prefix_used_words: Optional[int] = None
        self._prefix_window: Optional[int] = None
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
                         device="cuda") -> "JpegEncoder":
        """An encoder running with given quantization tables and adaptive
        sizes (e.g. the JAX encoder's ``qy``, ``qc``, ``_seg_words``,
        ``_prefix_window``)."""
        enc = cls(segmented=segmented, device=device)
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

    def _note_prefix_usage(self, used_words: int) -> None:
        """Record actual usage as a running max."""
        with self._adapt_lock:
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
        """Geometry-scaled prefix window for ordinary dispatches: ~1 word
        per block, and never above the theoretical bound."""
        geo = _pad_to(max(self.PREFIX_WORDS, layout.n_blocks),
                      self._WORD_BUCKET)
        return min(geo, self._prefix_bound(layout))

    def _prefix_bound(self, layout) -> int:
        """Theoretical worst case of a frame's aligned stream: every
        block at BLOCK_BITS_BOUND bits. A baseline block needs at most 1660
        bits (22 DC + 63 x 26 AC), and the < 32 bits of alignment per
        segment of 16 blocks stay inside the 4 bits per block left over."""
        return _pad_to(layout.n_blocks * self.BLOCK_BITS_BOUND // 32, 8)

    def _sizes(self):
        with self._adapt_lock:
            tgt = self._prefix_target()
            if tgt is not None:
                self._prefix_window = tgt
            self._seg_words = self._seg_target()
            return self._prefix_window, self._seg_words

    def _overflow_sizes(self, used_words: int,
                        seg_need_words: Optional[int]):
        """Grown sizes covering a device-reported need."""
        with self._adapt_lock:
            self._note_prefix_usage(int(used_words))
            if seg_need_words:
                self._seg_used_words = max(self._seg_used_words,
                                           int(seg_need_words))
            new_prefix = self._prefix_estimate()
            self._seg_words = max(self._seg_words, self._seg_target())
            return new_prefix, self._seg_words

    # -- dispatch / finalize ------------------------------------------------
    def _run_sized(self, program, ph: int, pw: int):
        """Enqueue ``program(layout, prefix_words, seg_words)`` — a GOP's
        device work, returning its combined array (see
        encode_gop_scans_layout; ``seg_words`` None selects the
        non-segment layout) — at the adaptive sizes, copied into pinned
        memory. Returns the handle fields (combined, prefix, prefix_bound,
        n_segs, seg_words, build); ``build(prefix_words, seg_words)``
        reruns the same work at other sizes."""
        layout = mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
        cap = self._prefix_cap(layout)
        bound = self._prefix_bound(layout)

        def build(prefix_w, sw):
            p = min(bound, prefix_w or cap)
            return _HostCopy(program(layout, p, sw)), p, sw

        win, sw = self._sizes()
        n_segs = 0
        if self.segmented:
            n_segs = (layout.n_blocks + self.SEG_G - 1) // self.SEG_G
        else:
            sw = None
        combined, prefix, sw = build(min(win, cap) if win else cap, sw)
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
            new_prefix, new_sw = self._overflow_sizes(w_need, seg_need)
            combined, p, sw = handle.build(max(new_prefix or 0, w_need),
                                           new_sw if n else None)
            return self._fetch(handle._replace(
                combined=combined, prefix=p, seg_words=sw, build=None))
        self._note_prefix_usage(int(used.max()))
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

    def _dispatch(self, planes_fn, h: int, w: int, ph: int, pw: int):
        ph, pw = _pad_to(ph, 16), _pad_to(pw, 16)

        def program(layout, prefix_words, seg_words):
            r, g, b = planes_fn()
            yq, cbq, crq = _planes_front_end(r, g, b, self._qy_dev,
                                             self._qc_dev, ph, pw)
            return encode_gop_scans_layout(yq, cbq, crq, layout,
                                           prefix_words, self.SEG_G,
                                           seg_words)

        return _Handle(*self._run_sized(program, ph, pw), h, w)

    def encode_gop_dispatch(self, frames_dev: torch.Tensor, h: int, w: int):
        """Enqueue the device encode of a GOP resident on the encoder's
        device ((F, PH, PW, 3) uint8; edge-padded here to multiples of 16
        if it is not already). Non-blocking; returns a handle for
        ``encode_gop_finalize``. ``h``, ``w`` are the frame size written
        in the headers."""
        ph, pw = frames_dev.shape[1], frames_dev.shape[2]
        return self._dispatch(
            lambda: (frames_dev[..., 0], frames_dev[..., 1],
                     frames_dev[..., 2]), h, w, ph, pw)

    def encode_gop_dispatch_src(self, src_fn, start, h: int, w: int,
                                ph: int, pw: int):
        """encode_gop_dispatch with an on-device frame source:
        ``src_fn(ph, pw, start)`` returns channel planes ``(r, g, b)``,
        each (F, ph, pw) uint8, or interleaved (F, ph, pw, 3) frames."""
        def planes():
            out = src_fn(ph, pw, start)
            if isinstance(out, (tuple, list)):
                return out
            return out[..., 0], out[..., 1], out[..., 2]

        return self._dispatch(planes, h, w, ph, pw)

    def encode_gop_finalize(self, handle: _Handle) -> List[bytes]:
        """Blocking half: wait for the copy, check the sizes, compact,
        stuff, wrap headers. Combined layout per frame: segments [0] =
        aligned words, [1..S] = segment bits, [S+1..] = word-aligned
        stream; blocks [0] = bits, [1..] = the stream."""
        arr, handle = self._fetch(handle)
        hdr = jpeg_headers(handle.h, handle.w, self.qy, self.qc, True)
        return [hdr + self._scan_bytes(row, handle.n_segs, handle.prefix)
                + b"\xff\xd9" for row in arr]

    def encode_frame(self, frame: np.ndarray) -> bytes:
        return self.encode_gop(frame[None])[0]
