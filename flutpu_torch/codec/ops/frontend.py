"""Fused encode front end: u8 RGB planes → zigzagged quantized DCT
coefficients (port of flutpu/codec/ops/frontend_pallas.py).

``front_end`` is the wrapper of the CUDA kernel ``csrc/frontend.cu``
(optional blend of a BGRA subtitle overlay → RGB→YCbCr → 4:2:0 pair
mean → 8x8 DCT → quantize → zigzag, one pass over device memory: a
block walks strips of 8 macroblocks, and the 8x8 DCT runs as two
register-resident passes). It replaces the Pallas TPU kernel ``front_end_pallas``, its overlay branch
included: the blended planes never exist in device memory. The TPU
kernel's block-diagonal and subsample-folded matrices and its four
zero-padded overlay planes were Mosaic workarounds and are not carried
over: the kernel reads the (oh, ow, 4) overlay as it is.
``front_end_plain`` is the same function in plain PyTorch: the wrapper
takes it for CPU tensors, and the card's results are held against it.
The two differ only where a summation order moves a coefficient across
a rounding tie (±1 on a small share). The blend
itself has no ties (its value before the u8 round lies at least 1/510
from an integer), so the kernel with an overlay equals the kernel
without one on planes blended beforehand, bit for bit.

``front_end_444`` is the 4:4:4 front end (no subsampling), plain
PyTorch on every device: flutpu runs it as an XLA program, not a Pallas
kernel.

Output layout is the one the entropy stage reads (the JAX package's
``encode_gop_planes_to_coefs``): y (F, H/8, W/8, 64), cb/cr
(F, H/16, W/16, 64), int16, zigzag order.
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

from ... import _build
from .colorspace import _RGB2YCBCR, planes_to_i420, ycbcr_from_channels
from .dct import dct_matrix, plane_dct
from .quant import quantize, zigzag_flatten, zigzag_order

_ready_devices = set()
_init_lock = threading.Lock()
#: id(table) -> (weak reference, version) of the tables whose values were
#: read back and found in 1..255
_checked_tables = {}


def _check_args(r, g, b, qy, qc) -> None:
    for p in (r, g, b):
        if p.dtype != torch.uint8 or p.dim() != 3 or p.shape != r.shape:
            raise ValueError("r, g, b must be uint8 planes of one (F, H, W) "
                             f"shape, got {p.dtype} {tuple(p.shape)}")
        if p.device != r.device:
            raise ValueError("r, g, b must lie on one device")
    f, h, w = r.shape
    if h % 16 or w % 16:
        raise ValueError(f"plane size {(h, w)} is not a multiple of 16")
    for q in (qy, qc):
        if q.shape != (8, 8) or q.device != r.device:
            raise ValueError("qy, qc must be (8, 8) tables on the planes' "
                             "device")


def _check_overlay(overlay, r) -> torch.Tensor:
    """The (oh, ow, 4) uint8 BGRA overlay, contiguous, on the planes'
    device and no larger than them."""
    if (not isinstance(overlay, torch.Tensor) or overlay.dtype != torch.uint8
            or overlay.dim() != 3 or overlay.shape[2] != 4):
        raise ValueError("overlay must be an (oh, ow, 4) uint8 BGRA tensor")
    if overlay.device != r.device:
        raise ValueError("overlay must lie on the planes' device")
    if overlay.shape[0] > r.shape[1] or overlay.shape[1] > r.shape[2]:
        raise ValueError(f"overlay {tuple(overlay.shape[:2])} is larger than "
                         f"the coded frame {tuple(r.shape[1:])}")
    return overlay.contiguous()


def front_end_plain(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    qy: torch.Tensor, qc: torch.Tensor, overlay=None):
    """Plain PyTorch version of the kernel: the JAX package's CPU arm
    (planes_to_i420, level shift, 8x8 DCT, quantize, zigzag), after the
    blend of ``overlay`` (``overlay_on_planes``; rows and columns past
    the overlay's size keep their value, as under alpha 0)."""
    _check_args(r, g, b, qy, qc)
    y, cb, cr = planes_to_i420(*_blend(r, g, b, overlay))
    return _coefs(y, qy), _coefs(cb, qc), _coefs(cr, qc)


def _blend(r, g, b, overlay):
    """The planes with ``overlay`` burned in (``overlay_on_planes``; rows
    and columns past the overlay's size keep their value, as under alpha
    0), or as they are without one."""
    if overlay is None:
        return r, g, b
    from ...ttml.render.composite import overlay_on_planes
    overlay = _check_overlay(overlay, r)
    oh, ow = overlay.shape[:2]
    full = overlay.new_zeros((r.shape[1], r.shape[2], 4))
    full[:oh, :ow] = overlay
    return overlay_on_planes(r, g, b, full)


def _coefs(plane, q):
    """Level shift, 8x8 DCT, quantize, zigzag: int16 (F, H/8, W/8, 64)."""
    return zigzag_flatten(quantize(plane_dct(plane - 128.0), q)) \
        .to(torch.int16)


def front_end_444(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  qy: torch.Tensor, qc: torch.Tensor, overlay=None):
    """The 4:4:4 front end in plain PyTorch on the planes' device (flutpu's
    XLA arm, ``encode_gop_planes_to_coefs(subsample=False)``: the TPU
    kernel runs 4:2:0 only, so this program ports no Pallas kernel):
    optional overlay blend, RGB→YCbCr without subsampling, level shift,
    8x8 DCT, quantize, zigzag. (r, g, b) uint8 planes (F, H, W), H and W
    multiples of 8 → (y, cb, cr) int16 (F, H/8, W/8, 64) each."""
    for p in (r, g, b):
        if p.dtype != torch.uint8 or p.dim() != 3 or p.shape != r.shape \
                or p.device != r.device:
            raise ValueError("r, g, b must be uint8 planes of one (F, H, W) "
                             f"shape and device, got {p.dtype} "
                             f"{tuple(p.shape)}")
    if r.shape[1] % 8 or r.shape[2] % 8:
        raise ValueError(f"plane size {tuple(r.shape[1:])} is not a "
                         "multiple of 8")
    y, cb, cr = ycbcr_from_channels(*_blend(r, g, b, overlay))
    return _coefs(y, qy), _coefs(cb, qc), _coefs(cr, qc)


def _init_device(lib, device: torch.device) -> None:
    """Upload the kernel's constants to ``device`` once. Several threads
    may launch first at the same moment: one uploads, the others wait for
    it, and none launches before the constants are there."""
    if device in _ready_devices:
        return
    with _init_lock:
        if device in _ready_devices:
            return
        dct = np.ascontiguousarray(dct_matrix(8), np.float32)
        rgb = np.ascontiguousarray(_RGB2YCBCR, np.float32)
        zz = np.ascontiguousarray(zigzag_order(8), np.int32)
        _build.check(lib.flu_front_end_init(
            dct.ctypes.data_as(ctypes.c_void_p),
            rgb.ctypes.data_as(ctypes.c_void_p),
            zz.ctypes.data_as(ctypes.c_void_p)), "front_end constants")
        _ready_devices.add(device)


def _check_table_values(q: torch.Tensor) -> None:
    """Raise unless every entry of the quantization table lies in 1..255
    (what ``scale_qtable`` gives): the kernel's division is proven for
    those divisors. Reading the values back waits for the device, so a
    table is read once and remembered while it lives unmodified; an
    encoder hands over the same two tensors for every GOP."""
    key = id(q)
    hit = _checked_tables.get(key)
    if hit is not None and hit[0]() is q and hit[1] == q._version:
        return
    lo, hi = (int(v) for v in torch.aminmax(q))
    if lo < 1 or hi > 255:
        raise ValueError(f"quantization table entries must lie in 1..255, "
                         f"got {lo}..{hi}")
    _checked_tables[key] = (
        weakref.ref(q, lambda _, key=key: _checked_tables.pop(key, None)),
        q._version)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) at a 16-byte aligned address: the kernel loads
    8 and 16 bytes at a time, and a slice of a larger tensor may start
    anywhere."""
    return t.clone() if t.data_ptr() % 16 else t


def front_end(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              qy: torch.Tensor, qc: torch.Tensor, overlay=None):
    """(r, g, b) uint8 planes (F, H, W), H and W multiples of 16, and
    (8, 8) quant tables → (y, cb, cr) int16 zigzagged quantized
    coefficients. ``overlay``: one (oh, ow, 4) uint8 BGRA window, oh <= H
    and ow <= W, blended into every frame inside the kernel before the
    colour conversion (premultiplied source-over with the u8 round of
    ``overlay_on_planes``). CUDA tensors launch the kernel on the current
    stream; CPU tensors take ``front_end_plain``."""
    if r.device.type == "cpu":
        return front_end_plain(r, g, b, qy, qc, overlay)
    if r.device.type != "cuda":
        raise ValueError(f"front_end: unsupported device {r.device}")
    _check_args(r, g, b, qy, qc)
    _check_table_values(qy)
    _check_table_values(qc)
    ov_ptr, oh, ow = None, 0, 0
    if overlay is not None:
        overlay = _check_overlay(overlay, r)
        oh, ow = overlay.shape[:2]
        overlay = _aligned(overlay)
        ov_ptr = overlay.data_ptr() if oh and ow else None
    r, g, b = (_aligned(p.contiguous()) for p in (r, g, b))
    qy = qy.to(torch.int32).contiguous()
    qc = qc.to(torch.int32).contiguous()
    f, h, w = r.shape
    y = torch.empty((f, h // 8, w // 8, 64), dtype=torch.int16, device=r.device)
    cb = torch.empty((f, h // 16, w // 16, 64), dtype=torch.int16,
                     device=r.device)
    cr = torch.empty_like(cb)
    if f == 0:
        return y, cb, cr
    lib = _build.load()
    with torch.cuda.device(r.device):
        _init_device(lib, r.device)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        _build.check(lib.flu_front_end(
            r.data_ptr(), g.data_ptr(), b.data_ptr(), qy.data_ptr(),
            qc.data_ptr(), y.data_ptr(), cb.data_ptr(), cr.data_ptr(),
            f, h, w, ov_ptr, oh, ow, stream), "front_end launch")
    _build.count_launch(front_end)
    if ov_ptr is not None:
        _build.count_launch(front_end, "overlay_launches")
    return y, cb, cr


def quotient_check(device) -> tuple:
    """Run the kernel library's check of its quantizer's division on
    ``device`` (a CUDA device): the product with the table entry's
    reciprocal, corrected once, against IEEE division for every divisor
    1..255 and every float of magnitude 2^-3 .. 2^12. Returns (pairs
    compared, pairs that differ in any bit): the second must be 0."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"quotient_check needs a CUDA device, got {device}")
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(lib.flu_front_end_quotient_check(counts.data_ptr(),
                                                      stream),
                     "quotient check launch")
    n, bad = counts.tolist()
    return n, bad


#: kernel launches since the count was last set to 0, and those of them
#: that ran the overlay branch
front_end.launches = 0
front_end.overlay_launches = 0
