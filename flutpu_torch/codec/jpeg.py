"""Baseline JPEG / MJPEG encoder on the GPU (port of flutpu/codec/jpeg.py).

A 4:2:0 GOP of frames runs on the device as: edge pad to a multiple of
16 → the front-end kernel (optional burn-in of a BGRA subtitle overlay →
RGB→YCbCr → 4:2:0 → DCT → quantize → zigzag) → the scan stage. A 4:4:4
GOP (``subsample=False``) pads to a multiple of 8 and runs the plain
PyTorch front end ``front_end_444`` in the kernel's place (flutpu runs
that arm as XLA, not as a Pallas kernel), then the same scan stage over
one-block MCUs. The scan stage is the encoder's ``ScanCoder``
(``scans.py``): the pack kernel of either bitstream layout at adaptive
sizes, one copy back and the compaction on the host, or flutpu's host
entropy engine (``engine="host"``), with the same bytes. The host wraps
the scans in the JFIF headers.

Dispatch and finalize are split so that a caller keeps GOPs in flight:
``encode_gop_dispatch`` (or ``_src``) enqueues the whole GOP on the
current CUDA stream and copies the result into a pinned host buffer,
recorded with a CUDA event; ``encode_gop_finalize`` waits on that event.

``encode_gop_to_coefs`` and ``encode_gop_planes_to_coefs`` are the front
end alone (K1 on CUDA tensors), as flutpu's coefficient-level API.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import jpeg_tables as T
# flutpu.codec.jpeg's names for the rounding helper and the plain scan
# coder, which the port's modules, the benchmark and the tests import
# from here
from .scans import ScanCoder, encode_scan  # noqa: F401
from .scans import encode_scan_python as _encode_scan_python  # noqa: F401
from .scans import pad_to as _pad_to
from .ops.frontend import front_end, front_end_444
from .ops.quant import zigzag_order


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
# public encoder
# ----------------------------------------------------------------------------

def segmented_property(value) -> Optional[bool]:
    """Map an element ``segmented`` property (auto/true/false, any case,
    or a bool) to the encoder argument (None = ``resolve_segmented``'s
    default). A copy of flutpu.codec.jpeg.segmented_property."""
    s = str(value).strip().lower()
    if s in ("auto", "", "none"):
        return None
    return s not in ("0", "false", "no")


class _Handle(NamedTuple):
    """A dispatch: the scan coder's result (``ScanCoder.dispatch``) and
    the frame size written in the headers."""
    scans: object
    h: int
    w: int


class JpegEncoder:
    """GOP JPEG encoder on one device, 4:2:0 or (``subsample=False``)
    4:4:4: the front end, the JFIF headers and a ``ScanCoder``
    (``scans``), the scan stage.

    ``device`` is where the encode runs: a CUDA device launches the
    front-end kernel (4:2:0; 4:4:4 runs the plain ``front_end_444``
    there) and the pack kernels; ``"cpu"`` runs their plain PyTorch
    versions (tests, hosts without a card). ``segmented`` picks the
    bitstream layout of the device stage (``resolve_segmented``); the
    JFIF bytes are the same in both. ``engine``: ``"auto"`` or
    ``"device"`` code the scans on the device; ``"host"`` runs the front
    end there and the native scan coder on the host, with the same
    bytes."""

    #: the scan stage's bounds and starting sizes (``ScanCoder``'s)
    BLOCK_BITS_BOUND = ScanCoder.BLOCK_BITS_BOUND
    SEG_G = ScanCoder.SEG_G
    SEG_WORDS0 = ScanCoder.SEG_WORDS0
    PREFIX_WORDS = ScanCoder.PREFIX_WORDS

    def __init__(self, quality: int = 85, subsample: bool = True, *,
                 engine: str = "auto", segmented: Optional[bool] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.quality = quality
        self.subsample = bool(subsample)
        self.scans = ScanCoder(quality, self.subsample, engine=engine,
                               segmented=segmented, device=self.device)

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
        enc.scans.set_state(qy, qc, seg_words, prefix_window)
        return enc

    @property
    def engine(self) -> str:
        return self.scans.engine

    @property
    def segmented(self) -> bool:
        return self.scans.segmented

    @property
    def qy(self) -> np.ndarray:
        return self.scans.qy

    @property
    def qc(self) -> np.ndarray:
        return self.scans.qc

    @property
    def mult(self) -> int:
        """The coded size's multiple: a 4:2:0 MCU is 16 pixels, 4:4:4's 8."""
        return self.scans.mult

    def layout(self, ph: int, pw: int):
        """The MCU layout of a coded (ph, pw) frame."""
        return self.scans.layout(ph, pw)

    def encode_gop(self, frames) -> List[bytes]:
        """(F, H, W, 3) uint8 RGB (numpy or tensor) → one JFIF bytestream
        per frame."""
        t = torch.as_tensor(np.ascontiguousarray(frames)
                            if isinstance(frames, np.ndarray) else frames)
        t = t.to(self.device)
        f, h, w, _ = t.shape
        return self.encode_gop_finalize(self.encode_gop_dispatch(t, h, w))

    # -- dispatch / finalize ------------------------------------------------
    def _dispatch(self, planes_fn, h: int, w: int, ph: int, pw: int,
                  overlay=None) -> _Handle:
        ph, pw = _pad_to(ph, self.mult), _pad_to(pw, self.mult)
        if overlay is not None:
            overlay = torch.as_tensor(overlay).to(self.device)
        sc = self.scans

        # the overlay rides in the closure, so an overflow redispatch
        # blends it again
        def program(pack):
            return pack(*_planes_front_end(*planes_fn(), sc.qy_dev,
                                           sc.qc_dev, ph, pw, overlay,
                                           self.subsample))

        return _Handle(sc.dispatch(program, ph, pw), h, w)

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

    def scan_planes_dispatch(self, coefs):
        """Enqueue the entropy stage alone on already-quantized (F, BH,
        BW, 64) int16 zigzagged coefficient planes (y, cb, cr; tensors on
        their device, or host arrays): MCU order, the pack kernel of the
        encoder's layout (K2, or K7 / K8a), one copy back, at the adaptive
        sizes with the overflow redispatch; with ``engine="host"`` the
        planes' copy into pinned memory. Returns a handle for
        ``scan_planes_finalize``."""
        yq, cbq, crq = (c if isinstance(c, torch.Tensor)
                        else torch.from_numpy(np.array(c, np.int16))
                        for c in coefs)
        ph, pw = yq.shape[1] * 8, yq.shape[2] * 8
        return _Handle(self.scans.dispatch(lambda pack: pack(yq, cbq, crq),
                                           ph, pw), ph, pw)

    def scan_planes_finalize(self, handle) -> List[bytes]:
        """Blocking half of ``scan_planes_dispatch`` (and of the GOP
        dispatches): one byte-stuffed baseline scan per frame, no JFIF
        wrapper (``ScanCoder``'s finalize of either engine)."""
        return handle.scans.finalize()[0]

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
