"""8x8 block DCT ops (port of flutpu/codec/ops/dct.py).

The 2-D DCT-II of an 8x8 block X is C @ X @ C^T with the orthonormal DCT
matrix C, batched over all blocks of all frames. ``dct2`` and ``idct2``
are the plain versions; ``plane_dct`` and ``plane_idct`` run the
transform kernel (K9, ops/transform_kernels.py) on the card, and the
JPEG product path runs the DCT inside the front-end kernel
(ops/frontend.py). The planar formulation (``plane_dct_planar``,
``plane_idct_planar``; FVC header flags bit 3) keeps the coefficients in
plane layout through flutpu's two products with block-diagonal DCT
matrices, which it computes outside any Pallas kernel; here over their
nonzero terms in a fixed order, so that every device and every plane
height gives the same bits. Neither formulation runs a matrix product
on the card, so neither depends on the TF32 setting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import on_device


@functools.lru_cache()
def dct_matrix(n: int = 8) -> np.ndarray:
    """Orthonormal DCT-II matrix: C[k, x] = s(k) cos((2x+1) k pi / 2n).
    Copy of flutpu.codec.ops.dct.dct_matrix."""
    k = np.arange(n)[:, None].astype(np.float64)
    x = np.arange(n)[None, :].astype(np.float64)
    c = np.cos((2 * x + 1) * k * np.pi / (2 * n))
    c *= np.sqrt(2.0 / n)
    c[0] *= np.sqrt(0.5)
    return c.astype(np.float32)


def _dct_on(device: torch.device, n: int = 8) -> torch.Tensor:
    """The n x n DCT matrix on ``device``, uploaded once."""
    return on_device(("dct", n), dct_matrix(n), device)


def blockize(plane: torch.Tensor, block: int = 8) -> torch.Tensor:
    """[..., H, W] → [..., H/block, W/block, block, block]."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // block, block, w // block, block)
    return x.transpose(-3, -2)


def unblockize(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of blockize: [..., BH, BW, b, b] → [..., BH*b, BW*b]."""
    *lead, bh, bw, b, b2 = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, bh * b, bw * b2)


def dct2(blocks: torch.Tensor) -> torch.Tensor:
    """2-D DCT-II over the trailing (8, 8) axes, any leading batch shape."""
    c = _dct_on(blocks.device, blocks.shape[-1])
    return c @ blocks.to(torch.float32) @ c.T


def idct2(coefs: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT over trailing (8, 8) axes."""
    c = _dct_on(coefs.device, coefs.shape[-1])
    return c.T @ coefs.to(torch.float32) @ c


def plane_dct(plane: torch.Tensor, block: int = 8) -> torch.Tensor:
    """Whole-plane blockized DCT: [..., H, W] → [..., H/8, W/8, 8, 8].
    On the card the transform kernel (K9, ``transform_kernels.block_dct``),
    on the CPU its plain version ``dct2(blockize(plane))``: the same bits
    at every batch shape. Only 8x8 blocks."""
    if block != 8:
        raise ValueError(f"plane_dct takes 8x8 blocks, got {block}")
    from .transform_kernels import block_dct
    return block_dct(plane)


def plane_idct(coefs: torch.Tensor) -> torch.Tensor:
    """[..., BH, BW, 8, 8] coefficients → [..., H, W] plane (K9's
    ``block_idct``; on the CPU ``unblockize(idct2(coefs))``)."""
    from .transform_kernels import block_idct
    return block_idct(coefs)


# ----------------------------------------------------------------------------
# the planar formulation (FVC header flags bit 3)
# ----------------------------------------------------------------------------

def _planar_products(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """``bh @ x @ bw.T`` (``bh.T @ x @ bw`` for the inverse) over the
    trailing (H, W) of ``x``, ``bh`` and ``bw`` being flutpu's
    block-diagonal DCT matrices (``_bd_dct_matrix``), over their nonzero
    terms alone: the product with ``bh``, then with ``bw.T``, each
    coefficient's eight terms multiplied and then added in ascending
    order, every multiply and add its own fp32 operation. A matrix
    product's summation order depends on its shapes (the card's, at 32
    rows against 96, differs), so this fixes it: a sample depends on its
    own eight inputs alone, equal on every device, at every plane height
    and in every batch, and the decoder rebuilds the planes of an
    encoder that ran on row stripes, or on another device, bit for
    bit."""
    m = _dct_on(x.device)
    if inverse:
        m = m.T
    h, w = x.shape[-2:]
    rows = x.to(torch.float32).reshape(*x.shape[:-2], h // 8, 8, w)
    left = m[:, 0, None] * rows[..., 0:1, :]
    for k in range(1, 8):
        left = left + m[:, k, None] * rows[..., k:k + 1, :]
    cols = left.reshape(*x.shape[:-2], h, w // 8, 8)
    out = cols[..., 0:1] * m[:, 0]
    for k in range(1, 8):
        out = out + cols[..., k:k + 1] * m[:, k]
    return out.reshape(x.shape)


def plane_dct_planar(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] plane → [..., H, W] plane-layout DCT coefficients:
    block (by, bx)'s coefficient (u, v) sits at (8*by + u, 8*bx + v).
    Equals unblockize(plane_dct(plane)) but for the order of each
    coefficient's eight terms. The products with the block-diagonal DCT
    matrices (``_planar_products``), in full fp32 whatever the TF32
    setting."""
    return _planar_products(plane, inverse=False)


def plane_idct_planar(coefs: torch.Tensor) -> torch.Tensor:
    """Inverse of plane_dct_planar: plane-layout coefficients → plane."""
    return _planar_products(coefs, inverse=True)
