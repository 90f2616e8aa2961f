"""Decode helpers: JFIF → coefficients (native C++) → pixels (torch).

Port of flutpu/codec/decode.py plus ``parse_jfif`` from
flutpu/codec/decoders.py (copies; that package imports jax). The encoder
and its checks use them to read a stream back without an external
decoder: the native scan decoder (``flu_jpeg_decode_scan``) recovers the
zigzagged quantized coefficients, and ``coefs_to_rgb`` de-zigzags,
dequantizes, inverse-transforms, upsamples (4:2:0) and converts to RGB
in plain PyTorch on the coefficients' device (flutpu's XLA program;
there is no Pallas kernel on this path). The decoder elements
(``decoders.py``) and ``FvcDecoder`` run it.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from . import jpeg_tables as T
from .ops.colorspace import i420_to_rgb, ycbcr_to_rgb
from .ops.dct import plane_idct
from .ops.quant import dequantize, inverse_zigzag_order, zigzag_unflatten


def parse_jfif(data: bytes):
    """Minimal JFIF parse: dimensions, qtables, subsampling, scan bytes."""
    if data[:2] != b"\xff\xd8":
        return None
    pos = 2
    qtables = {}
    h = w = None
    subsample = True
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        payload = data[pos + 4:pos + 2 + length]
        if marker == 0xDB:  # DQT (possibly several tables)
            p = 0
            zz = inverse_zigzag_order(8)
            while p < len(payload):
                tid = payload[p] & 0x0F
                tab = np.frombuffer(payload[p + 1:p + 65], np.uint8)
                qtables[tid] = tab.astype(np.int32)[zz].reshape(8, 8)
                p += 65
        elif marker == 0xC0:  # SOF0
            _, h, w, ncomp = struct.unpack(">BHHB", payload[:6])
            samp = payload[7]
            subsample = samp == 0x22
        elif marker == 0xDA:  # SOS: scan follows
            scan_start = pos + 2 + length
            return {"h": h, "w": w, "qtables": qtables,
                    "subsample": subsample, "scan": data[scan_start:-2]}
        pos += 2 + length
    return None


def decode_scan_to_coefs(scan: bytes, ybw: int, ybh: int, cbw: int, cbh: int,
                         subsample: bool, destuff: bool = True
                         ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Entropy scan → (y, cb, cr) zigzagged int16 blocks (absolute DC).
    Returns None when the native library is unavailable or the stream is
    corrupt."""
    lib = native.get_lib()
    if lib is None:
        return None
    c = ctypes
    y = np.zeros((ybh, ybw, 64), np.int16)
    cb = np.zeros((cbh, cbw, 64), np.int16)
    cr = np.zeros((cbh, cbw, 64), np.int16)
    buf = np.frombuffer(scan, dtype=np.uint8)

    def u8p(a):
        return a.ctypes.data_as(c.POINTER(c.c_uint8))

    def i16p(a):
        return a.ctypes.data_as(c.POINTER(c.c_int16))

    def tab(bits, vals):
        return np.asarray(bits, np.uint8), np.asarray(vals, np.uint8)

    dclb, dclv = tab(T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    aclb, aclv = tab(T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    dccb, dccv = tab(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
    accb, accv = tab(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
    rc = lib.flu_jpeg_decode_scan(
        u8p(buf), len(scan), 1 if destuff else 0,
        i16p(y), ybw, ybh, i16p(cb), i16p(cr), cbw, cbh,
        1 if subsample else 0, 3,
        u8p(dclb), u8p(dclv), len(dclv), u8p(aclb), u8p(aclv), len(aclv),
        u8p(dccb), u8p(dccv), len(dccv), u8p(accb), u8p(accv), len(accv))
    if rc != 0:
        return None
    return y, cb, cr


def coefs_to_rgb(yq: torch.Tensor, cbq: torch.Tensor, crq: torch.Tensor,
                 qy: torch.Tensor, qc: torch.Tensor, h: int, w: int,
                 subsample: bool = True) -> torch.Tensor:
    """Quantized zigzag coefficient planes ((..., BH, BW, 64); chroma at
    half the blocks with ``subsample``, 4:2:0, at the luma's without,
    4:4:4) → (..., h, w, 3) uint8 RGB on the coefficients' device. Every
    device runs the per-block IDCT: a decoded frame feeds no later frame,
    so flutpu's planar formulation on accelerators is no format matter
    here."""
    def plane(q, qtab):
        blocks = zigzag_unflatten(q.to(torch.float32))
        return plane_idct(dequantize(blocks, qtab)) + 128.0

    y, cb, cr = plane(yq, qy), plane(cbq, qc), plane(crq, qc)
    if subsample:
        rgb = i420_to_rgb(y, cb, cr)
    else:
        rgb = ycbcr_to_rgb(torch.stack([y, cb, cr], dim=-1))
    return (rgb + 0.5).clamp(0, 255).to(torch.uint8)[..., :h, :w, :]
