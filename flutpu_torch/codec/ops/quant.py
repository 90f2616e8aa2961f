"""Quantization tables, quality scaling, zigzag (port of
flutpu/codec/ops/quant.py).

The tables, ``scale_qtable`` and the zigzag orders are numpy, copied from
the original (that package imports jax); the tensor functions take and
return torch tensors on whatever device their inputs lie on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ITU-T T.81 Annex K.1 example quantization tables (public constants)
LUMA_QTABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.int32)

CHROMA_QTABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], dtype=np.int32)


@functools.lru_cache()
def zigzag_order(n: int = 8) -> np.ndarray:
    """Indices that map a row-major flattened n*n block into zigzag order."""
    order = sorted(
        ((i, j) for i in range(n) for j in range(n)),
        key=lambda ij: (ij[0] + ij[1],
                        ij[1] if (ij[0] + ij[1]) % 2 == 0 else ij[0]))
    return np.array([i * n + j for i, j in order], dtype=np.int32)


@functools.lru_cache()
def inverse_zigzag_order(n: int = 8) -> np.ndarray:
    zz = zigzag_order(n)
    inv = np.empty_like(zz)
    inv[zz] = np.arange(n * n, dtype=np.int32)
    return inv


def scale_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling: 1..100 → scaled table clamped to [1, 255]."""
    quality = max(1, min(100, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = (base * scale + 50) // 100
    return np.clip(q, 1, 255).astype(np.int32)


def quantize(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even quantization of [..., 8, 8] DCT coefficients
    (``torch.round`` rounds ties to even, as ``jnp.round`` does)."""
    return torch.round(coefs / qtable.to(torch.float32)).to(torch.int32)


def dequantize(qcoefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    return qcoefs.to(torch.float32) * qtable.to(torch.float32)


def _index(order: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(order, dtype=torch.long, device=like.device)


def zigzag_flatten(blocks: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] → [..., 64] in zigzag order."""
    n = blocks.shape[-1]
    flat = blocks.reshape(*blocks.shape[:-2], n * n)
    return flat[..., _index(zigzag_order(n), flat)]


def zigzag_unflatten(flat: torch.Tensor, n: int = 8) -> torch.Tensor:
    """[..., 64] zigzag → [..., 8, 8] row-major blocks."""
    inv = _index(inverse_zigzag_order(n), flat)
    return flat[..., inv].reshape(*flat.shape[:-1], n, n)


def quant_map(qtable: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(8, 8) quant table tiled to a plane-layout (h, w) divisor map."""
    return qtable.to(torch.float32).tile(h // 8, w // 8)


def quantize_planar(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even quantization of plane-layout [..., H, W] DCT
    coefficients (see dct.plane_dct_planar)."""
    h, w = coefs.shape[-2:]
    return torch.round(coefs / quant_map(qtable, h, w)).to(torch.int32)


def dequantize_planar(qcoefs: torch.Tensor,
                      qtable: torch.Tensor) -> torch.Tensor:
    h, w = qcoefs.shape[-2:]
    return qcoefs.to(torch.float32) * quant_map(qtable, h, w)
