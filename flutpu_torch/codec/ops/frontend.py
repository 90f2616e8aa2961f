"""Fused encode front end: u8 RGB planes → zigzagged quantized DCT
coefficients (port of flutpu/codec/ops/frontend_pallas.py).

``front_end`` is the wrapper of the CUDA kernel ``csrc/frontend.cu``
(optional blend of a BGRA subtitle overlay → RGB→YCbCr → 4:2:0 pair
mean → 8x8 DCT → quantize → zigzag, one pass over device memory). It
replaces the Pallas TPU kernel ``front_end_pallas``, its overlay branch
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

Output layout is the one the entropy stage reads (the JAX package's
``encode_gop_planes_to_coefs``): y (F, H/8, W/8, 64), cb/cr
(F, H/16, W/16, 64), int16, zigzag order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build
from .colorspace import _RGB2YCBCR, planes_to_i420
from .dct import dct_matrix, plane_dct
from .quant import quantize, zigzag_flatten, zigzag_order

_ready_devices = set()


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
    if overlay is not None:
        from ...ttml.render.composite import overlay_on_planes
        overlay = _check_overlay(overlay, r)
        oh, ow = overlay.shape[:2]
        full = overlay.new_zeros((r.shape[1], r.shape[2], 4))
        full[:oh, :ow] = overlay
        r, g, b = overlay_on_planes(r, g, b, full)
    y, cb, cr = planes_to_i420(r, g, b)

    def coefs(plane, q):
        return zigzag_flatten(quantize(plane_dct(plane - 128.0), q)) \
            .to(torch.int16)

    return coefs(y, qy), coefs(cb, qc), coefs(cr, qc)


def _init_device(lib, device: torch.device) -> None:
    if device in _ready_devices:
        return
    dct = np.ascontiguousarray(dct_matrix(8), np.float32)
    rgb = np.ascontiguousarray(_RGB2YCBCR, np.float32)
    zz = np.ascontiguousarray(zigzag_order(8), np.int32)
    _build.check(lib.flu_front_end_init(
        dct.ctypes.data_as(ctypes.c_void_p), rgb.ctypes.data_as(ctypes.c_void_p),
        zz.ctypes.data_as(ctypes.c_void_p)), "front_end constants")
    _ready_devices.add(device)


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
    ov_ptr, oh, ow = None, 0, 0
    if overlay is not None:
        overlay = _check_overlay(overlay, r)
        oh, ow = overlay.shape[:2]
        if overlay.data_ptr() % 4:    # the kernel loads 4 bytes per pixel
            overlay = overlay.clone()
        ov_ptr = overlay.data_ptr() if oh and ow else None
    r, g, b = (p.contiguous() for p in (r, g, b))
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
    front_end.launches += 1
    if ov_ptr is not None:
        front_end.overlay_launches += 1
    return y, cb, cr


#: kernel launches since the count was last set to 0, and those of them
#: that ran the overlay branch
front_end.launches = 0
front_end.overlay_launches = 0
