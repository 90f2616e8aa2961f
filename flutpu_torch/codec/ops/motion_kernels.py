"""Motion search + luma prediction and chroma compensation kernels (port
of flutpu/codec/ops/motion_pallas.py).

``motion_search_mc`` is the wrapper of the CUDA kernel ``csrc/motion.cu``
that replaces the Pallas TPU kernel ``motion_search_mc_dxmajor_pallas``:
±r full search per 16x16 macroblock with wrap-around edges, plus the
luma prediction from the winning vectors. ``chroma_mc`` wraps the kernel
that replaces ``chroma_mc_pallas``: 4:2:0 compensation of both chroma
planes from the floor-halved luma vectors.

``motion_search_mc_plain`` and ``chroma_mc_plain`` are the same
functions in plain PyTorch (the reference's XLA arm: ops/motion.py). The
wrappers take them for CPU tensors only; a CUDA tensor launches the
kernel or raises. The search kernel sums each SAD in the plain version's
order (ops/motion.py:_mb_sums), so vectors and predictions are
bit-identical to it; chroma compensation is pure selection and
bit-identical by construction.
"""

from __future__ import annotations

import torch

from ... import _build
from .motion import MB, motion_compensate, motion_search

#: largest search range the search kernel stages in shared memory
MAX_SEARCH_RANGE = 32


def _check_search_args(cur, prev, search_range) -> None:
    for p in (cur, prev):
        if p.dtype != torch.float32 or p.dim() != 2 or p.shape != cur.shape:
            raise ValueError("cur, prev must be float32 planes of one (H, W) "
                             f"shape, got {p.dtype} {tuple(p.shape)}")
    if prev.device != cur.device:
        raise ValueError("cur and prev must lie on one device")
    h, w = cur.shape
    if h % MB or w % MB:
        raise ValueError(f"plane size {(h, w)} is not a multiple of {MB}")
    if not 0 <= search_range <= MAX_SEARCH_RANGE:
        raise ValueError(f"search_range must be in 0..{MAX_SEARCH_RANGE}, "
                         f"got {search_range}")


def _check_chroma_args(prev_cb, prev_cr, mv) -> None:
    for p in (prev_cb, prev_cr):
        if p.dtype != torch.float32 or p.dim() != 2 \
                or p.shape != prev_cb.shape:
            raise ValueError("prev_cb, prev_cr must be float32 planes of one "
                             f"(H/2, W/2) shape, got {p.dtype} "
                             f"{tuple(p.shape)}")
    hc, wc = prev_cb.shape
    if hc % 8 or wc % 8:
        raise ValueError(f"chroma plane size {(hc, wc)} is not a multiple "
                         "of 8")
    if tuple(mv.shape) != (hc // 8, wc // 8, 2):
        raise ValueError(f"mv must be ({hc // 8}, {wc // 8}, 2), got "
                         f"{tuple(mv.shape)}")
    if mv.dtype.is_floating_point or mv.dtype == torch.bool:
        raise ValueError(f"mv must be integer, got {mv.dtype}")
    if prev_cr.device != prev_cb.device or mv.device != prev_cb.device:
        raise ValueError("prev_cb, prev_cr and mv must lie on one device")


def motion_search_mc_plain(cur: torch.Tensor, prev: torch.Tensor,
                           search_range: int = 7):
    """Plain PyTorch version of the search kernel: ``motion_search`` then
    ``motion_compensate`` (ops/motion.py). Same contract as
    ``motion_search_mc``."""
    _check_search_args(cur, prev, search_range)
    mv = motion_search(cur, prev, search_range)
    return mv, motion_compensate(prev, mv, search_range)


def chroma_mc_plain(prev_cb: torch.Tensor, prev_cr: torch.Tensor,
                    mv: torch.Tensor, search_range: int = 7):
    """Plain PyTorch version of the chroma kernel:
    ``motion_compensate(plane, mv, mb=8)`` for each plane."""
    _check_chroma_args(prev_cb, prev_cr, mv)
    return (motion_compensate(prev_cb, mv, search_range, mb=8),
            motion_compensate(prev_cr, mv, search_range, mb=8))


def motion_search_mc(cur: torch.Tensor, prev: torch.Tensor,
                     search_range: int = 7):
    """(H, W) float32 current and reference luma, H and W multiples of 16
    → (mv (H/16, W/16, 2) int32, pred (H, W) float32): per macroblock the
    (dy, dx) in ±search_range of least ``SAD * 64 + |dy| + |dx|``, ties
    to the first in dy-major order, and the prediction ``pred[i, j] =
    prev[(i - dy) mod H, (j - dx) mod W]``. CUDA tensors launch the kernel
    on the current stream; CPU tensors take ``motion_search_mc_plain``."""
    if cur.device.type == "cpu":
        return motion_search_mc_plain(cur, prev, search_range)
    if cur.device.type != "cuda":
        raise ValueError(f"motion_search_mc: unsupported device {cur.device}")
    _check_search_args(cur, prev, search_range)
    cur, prev = cur.contiguous(), prev.contiguous()
    h, w = cur.shape
    mv = torch.empty((h // MB, w // MB, 2), dtype=torch.int32,
                     device=cur.device)
    pred = torch.empty_like(cur)
    lib = _build.load()
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        _build.check(lib.flu_motion_search_mc(
            cur.data_ptr(), prev.data_ptr(), mv.data_ptr(), pred.data_ptr(),
            h, w, search_range, stream), "motion_search_mc launch")
    motion_search_mc.launches += 1
    return mv, pred


def chroma_mc(prev_cb: torch.Tensor, prev_cr: torch.Tensor, mv: torch.Tensor,
              search_range: int = 7):
    """(H/2, W/2) float32 chroma planes and (H/16, W/16, 2) integer luma
    vectors → (pred_cb, pred_cr): each 8x8 block of a plane comes from the
    plane displaced by its macroblock's vector floor-halved, wrap-around
    (``motion_compensate(plane, mv, mb=8)``, bit for bit). One launch
    covers both planes. CUDA tensors launch the kernel on the current
    stream; CPU tensors take ``chroma_mc_plain``. ``search_range`` is
    accepted for the reference's signature."""
    if prev_cb.device.type == "cpu":
        return chroma_mc_plain(prev_cb, prev_cr, mv, search_range)
    if prev_cb.device.type != "cuda":
        raise ValueError(f"chroma_mc: unsupported device {prev_cb.device}")
    _check_chroma_args(prev_cb, prev_cr, mv)
    prev_cb, prev_cr = prev_cb.contiguous(), prev_cr.contiguous()
    mv = mv.to(torch.int32).contiguous()
    hc, wc = prev_cb.shape
    pcb = torch.empty_like(prev_cb)
    pcr = torch.empty_like(prev_cr)
    lib = _build.load()
    with torch.cuda.device(prev_cb.device):
        stream = torch.cuda.current_stream(prev_cb.device).cuda_stream
        _build.check(lib.flu_chroma_mc(
            prev_cb.data_ptr(), prev_cr.data_ptr(), mv.data_ptr(),
            pcb.data_ptr(), pcr.data_ptr(), hc, wc, stream),
            "chroma_mc launch")
    chroma_mc.launches += 1
    return pcb, pcr


#: kernel launches since the count was last set to 0
motion_search_mc.launches = 0
chroma_mc.launches = 0
