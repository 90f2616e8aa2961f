"""The FVC in-loop transform kernels (K9): the 8x8 DCT of every block of
a plane and its inverse, CUDA kernels of ``csrc/transform.cu``.

They replace no Pallas kernel: flutpu's ``plane_dct`` and ``plane_idct``
are XLA matrix products, and the port's were ``c @ x @ c.T`` on cuBLAS,
whose summation order follows the batch shape. The FVC reference frame
is rebuilt from this transform, so a chunk coded in a batch of chunks,
on a shard or on a row stripe came out with other bytes than the same
chunk coded alone. The kernels compute every coefficient and sample as
the CPU's matrix product does (a chain of fused multiply-adds over k =
0..7 in ascending order, from +0; see csrc/transform.cu), so on the card
a block's result depends on that block alone and equals the CPU's bit
for bit, whatever the batch, shard or stripe.

``block_dct_plain`` and ``block_idct_plain`` are the plain PyTorch
versions (``dct2(blockize(plane))``, ``unblockize(idct2(coefs))``). The
wrappers take them for CPU tensors only; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches (``launches``): one
per call, whatever the leading axes, which are flattened into one
launch.
"""

from __future__ import annotations

import torch

from ... import _build
from .dct import _dct_on, blockize, dct2, idct2, unblockize
from .motion_kernels import _on_cuda


def _check_plane(plane: torch.Tensor) -> None:
    if plane.dim() < 2 or plane.shape[-2] % 8 or plane.shape[-1] % 8:
        raise ValueError("block_dct takes [..., H, W] planes with H and W "
                         f"multiples of 8, got {tuple(plane.shape)}")


def _check_coefs(coefs: torch.Tensor) -> None:
    if coefs.dim() < 4 or tuple(coefs.shape[-2:]) != (8, 8):
        raise ValueError("block_idct takes [..., BH, BW, 8, 8] blocks, got "
                         f"{tuple(coefs.shape)}")


def block_dct_plain(plane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the DCT kernel: ``dct2(blockize(plane))``."""
    _check_plane(plane)
    return dct2(blockize(plane))


def block_idct_plain(coefs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the IDCT kernel:
    ``unblockize(idct2(coefs))``."""
    _check_coefs(coefs)
    return unblockize(idct2(coefs))


def _launch(wrapper, entry: str, src: torch.Tensor, out: torch.Tensor,
            n: int, h: int, w: int) -> None:
    """One launch of ``entry`` over n (h, w) planes on the current stream,
    counted on ``wrapper``."""
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        _build.check(getattr(lib, entry)(
            src.data_ptr(), _dct_on(src.device).data_ptr(), out.data_ptr(),
            n, h, w, stream), f"{entry} launch")
    if n and h and w:
        _build.count_launch(wrapper)


def block_dct(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] plane (H and W multiples of 8) → [..., H/8, W/8, 8, 8]
    float32: the 2-D DCT-II of every 8x8 block, ``C @ X @ C.T``. CUDA
    tensors launch the kernel on the current stream (any leading axes in
    one launch); CPU tensors take ``block_dct_plain``."""
    if not _on_cuda(plane, "block_dct"):
        return block_dct_plain(plane)
    _check_plane(plane)
    *lead, h, w = plane.shape
    x = plane.to(torch.float32).contiguous().reshape(-1, h, w)
    out = torch.empty((x.shape[0], h // 8, w // 8, 8, 8),
                      dtype=torch.float32, device=x.device)
    _launch(block_dct, "flu_block_dct", x, out, x.shape[0], h, w)
    return out.reshape(*lead, h // 8, w // 8, 8, 8)


def block_idct(coefs: torch.Tensor) -> torch.Tensor:
    """[..., BH, BW, 8, 8] coefficients → [..., 8 BH, 8 BW] float32 plane:
    ``C.T @ D @ C`` of every block. CUDA tensors launch the kernel on the
    current stream; CPU tensors take ``block_idct_plain``."""
    if not _on_cuda(coefs, "block_idct"):
        return block_idct_plain(coefs)
    _check_coefs(coefs)
    *lead, bh, bw, _, _ = coefs.shape
    d = coefs.to(torch.float32).contiguous()
    if d.data_ptr() % 16:   # the kernel reads 16 bytes at a time
        d = d.clone()
    d = d.reshape(-1, bh, bw, 8, 8)
    out = torch.empty((d.shape[0], 8 * bh, 8 * bw), dtype=torch.float32,
                      device=d.device)
    _launch(block_idct, "flu_block_idct", d, out, d.shape[0], 8 * bh, 8 * bw)
    return out.reshape(*lead, 8 * bh, 8 * bw)


block_dct.launches = 0
block_idct.launches = 0
