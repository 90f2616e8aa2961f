"""Motion search + luma prediction and chroma compensation kernels (port
of flutpu/codec/ops/motion_pallas.py).

Each wrapper replaces one Pallas TPU kernel with a CUDA kernel of
``csrc/motion.cu``:

- ``motion_search_mc`` (K3, ``motion_search_mc_dxmajor_pallas``): ±r
  full search per 16x16 macroblock with wrap-around edges, plus the luma
  prediction from the winning vectors (a thread block takes a row of
  macroblocks under one shared window; a thread sums 4 adjacent dx by 8
  columns from registers; above r = 32 a thread sums two adjacent
  candidate rows by 4 dx over all the block's columns, the window is
  staged in bands of candidate-row pairs, the next band loading during
  the search, and the prediction read from device memory);
- ``motion_search_mc_blocks`` (K6a, ``motion_search_mc_pallas``): the
  same contract at any block size ``mb`` (8 or 16); the prediction shifts
  each mb×mb block by its full vector (the TPU kernel's, not
  ``motion_compensate``'s halving at mb != 16);
- ``motion_search_mc_dygrid`` (K6b, ``motion_search_mc_dygrid_pallas``):
  K3's contract; the TPU's dy-grid schedule has no Hopper counterpart,
  so it launches the 16x16 search kernel;
- ``motion_search_mc_hier`` (K5, ``motion_search_mc_hier_pallas``): the
  coarse-to-fine search in one launch — a thread block stages one
  full-resolution window of ``prev``, pools it and its current rows in
  shared memory, runs K6a's 8x8 search at ±max(1, r // 2) there (K3's
  device routine), clips the base and refines ±1 from the same window,
  then writes the prediction (above r = 32 a block of 8 macroblocks
  pools straight from device memory, runs the banded search of K3's
  wide arm on the pooled window and stages an 18-row refine window per
  macroblock as aligned 16-byte words);
- ``chroma_mc`` (K4, ``chroma_mc_pallas``): 4:2:0 compensation of both
  chroma planes from the floor-halved luma vectors, a thread per 8-wide
  row of a block in both planes.

Each wrapper also takes a leading chunk axis: (C, H, W) planes (and
(C, H/16, W/16, 2) vectors), one per GOP chunk, served by ONE launch,
each chunk searched and compensated inside its own plane as a launch of
it alone would (``cudahype`` runs one frame step of all its chunks so;
on the TPU, ``vmap`` gives the Pallas kernel a batch grid axis). A call
counts one launch whatever C is.

Row stripes (``motion_search_mc_striped``, ``chroma_mc_striped``) run
K3 (or K6b) and K4 unchanged on each stripe with a halo rounded up to
whole macroblocks (``halo_rows``): ``hr = 16 * ceil(r / 16)`` luma rows
and hr / 2 chroma rows from the ring neighbours. The kernel searches
the (Hs + 2 hr)-row plane with its usual wrap; a macroblock of the
stripe's own rows never reaches the wrap (|dy| <= r <= hr), so its
vector, cost, tie order and prediction are those of flutpu's
``motion_search_striped`` with an r-row halo, and the stripe keeps its
middle Hs / 16 macroblock rows. The halo's macroblocks are the extra
work: 2 hr / Hs of a stripe's search.

``*_plain`` are the same functions in plain PyTorch (the reference's
XLA arm: ops/motion.py). The wrappers take them for CPU tensors only; a
CUDA tensor launches the kernel or raises. Each search wrapper counts its
launches (``launches``) and, of them, those above ``WHOLE_RANGE``
(``wide_launches``). The kernels sum each SAD in the plain versions'
order (ops/motion.py:_mb_sums), so vectors and
predictions are bit-identical to them; chroma compensation is pure
selection and bit-identical by construction.
"""

from __future__ import annotations

import torch

from ... import _build
from .motion import (MB, compensate_blocks, exchange_row_halos,
                     motion_compensate, motion_search, motion_search_hier)

#: largest search range the search kernels take: the FVC encoder's limit
#: (vectors are int8 in the bitstream). Above 32 K3 and K6a stage their
#: window in bands of candidate rows, and K5 pools its window straight
#: from device memory (csrc/motion.cu).
MAX_SEARCH_RANGE = 126
#: the widest range whose whole window a search kernel stages at once
WHOLE_RANGE = 32


def _check_search_args(cur, prev, search_range, mb: int = MB) -> None:
    if mb not in (8, 16):
        raise ValueError(f"mb must be 8 or 16, got {mb}")
    for p in (cur, prev):
        if p.dtype != torch.float32 or p.dim() not in (2, 3) \
                or p.shape != cur.shape:
            raise ValueError("cur, prev must be float32 planes of one "
                             "([C,] H, W) shape, got "
                             f"{p.dtype} {tuple(p.shape)}")
    if prev.device != cur.device:
        raise ValueError("cur and prev must lie on one device")
    h, w = cur.shape[-2:]
    if h % mb or w % mb:
        raise ValueError(f"plane size {(h, w)} is not a multiple of {mb}")
    if not 0 <= search_range <= MAX_SEARCH_RANGE:
        raise ValueError(f"search_range must be in 0..{MAX_SEARCH_RANGE}, "
                         f"got {search_range}")


def _check_chroma_args(prev_cb, prev_cr, mv) -> None:
    for p in (prev_cb, prev_cr):
        if p.dtype != torch.float32 or p.dim() not in (2, 3) \
                or p.shape != prev_cb.shape:
            raise ValueError("prev_cb, prev_cr must be float32 planes of one "
                             f"([C,] H/2, W/2) shape, got {p.dtype} "
                             f"{tuple(p.shape)}")
    *lead, hc, wc = prev_cb.shape
    if hc % 8 or wc % 8:
        raise ValueError(f"chroma plane size {(hc, wc)} is not a multiple "
                         "of 8")
    if tuple(mv.shape) != (*lead, hc // 8, wc // 8, 2):
        raise ValueError(f"mv must be {(*lead, hc // 8, wc // 8, 2)}, got "
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


def motion_search_mc_blocks_plain(cur: torch.Tensor, prev: torch.Tensor,
                                  search_range: int = 7, mb: int = MB):
    """Plain PyTorch version of K6a: ``motion_search(..., mb)``, then each
    mb×mb block shifted by its full vector (``compensate_blocks``)."""
    _check_search_args(cur, prev, search_range, mb)
    mv = motion_search(cur, prev, search_range, mb)
    return mv, compensate_blocks(prev, mv, mb)


def motion_search_mc_dygrid_plain(cur: torch.Tensor, prev: torch.Tensor,
                                  search_range: int = 7):
    """Plain PyTorch version of K6b: K3's contract
    (``motion_search`` + ``motion_compensate``)."""
    return motion_search_mc_plain(cur, prev, search_range)


def _check_hier_args(cur, prev, search_range) -> None:
    _check_search_args(cur, prev, search_range)
    if search_range < 1:
        raise ValueError(f"hier search needs search_range >= 1, got "
                         f"{search_range}")


def motion_search_mc_hier_plain(cur: torch.Tensor, prev: torch.Tensor,
                                search_range: int = 7):
    """Plain PyTorch version of K5: ``motion_search_hier`` then
    ``motion_compensate``."""
    _check_hier_args(cur, prev, search_range)
    mv = motion_search_hier(cur, prev, search_range)
    return mv, motion_compensate(prev, mv, search_range)


def chroma_mc_plain(prev_cb: torch.Tensor, prev_cr: torch.Tensor,
                    mv: torch.Tensor, search_range: int = 7):
    """Plain PyTorch version of the chroma kernel:
    ``motion_compensate(plane, mv, mb=8)`` for each plane."""
    _check_chroma_args(prev_cb, prev_cr, mv)
    return (motion_compensate(prev_cb, mv, search_range, mb=8),
            motion_compensate(prev_cr, mv, search_range, mb=8))


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _launch_search(wrapper, entry: str, cur, prev, search_range, mb,
                   *extra):
    """One launch of a search kernel entry on the current stream, counted
    on ``wrapper`` → (mv ([C,] H/mb, W/mb, 2) int32, pred ([C,] H, W)
    float32): C chunks' planes, each (H, W) plane a multiple of 16 bytes,
    so every chunk's base stays 16-byte aligned."""
    # the kernels move 16 bytes at a time; a view may start anywhere
    cur, prev = (t.clone() if t.data_ptr() % 16 else t
                 for t in (cur.contiguous(), prev.contiguous()))
    *lead, h, w = cur.shape
    nc = cur.shape[0] if lead else 1
    mv = torch.empty((*lead, h // mb, w // mb, 2), dtype=torch.int32,
                     device=cur.device)
    pred = torch.empty_like(cur)
    lib = _build.load()
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        _build.check(getattr(lib, entry)(
            cur.data_ptr(), prev.data_ptr(), mv.data_ptr(), pred.data_ptr(),
            nc, h, w, search_range, *extra, stream), f"{entry} launch")
    if nc and h and w:
        _build.count_launch(wrapper)
        if search_range > WHOLE_RANGE:   # the banded / pooled arm ran
            _build.count_launch(wrapper, "wide_launches")
    return mv, pred


def motion_search_mc(cur: torch.Tensor, prev: torch.Tensor,
                     search_range: int = 7):
    """([C,] H, W) float32 current and reference luma, H and W multiples
    of 16 → (mv ([C,] H/16, W/16, 2) int32, pred ([C,] H, W) float32):
    per macroblock the (dy, dx) in ±search_range of least ``SAD * 64 +
    |dy| + |dx|``, ties to the first in dy-major order, and the prediction
    ``pred[i, j] = prev[(i - dy) mod H, (j - dx) mod W]``. CUDA tensors
    launch the kernel on the current stream; CPU tensors take
    ``motion_search_mc_plain``."""
    if not _on_cuda(cur, "motion_search_mc"):
        return motion_search_mc_plain(cur, prev, search_range)
    _check_search_args(cur, prev, search_range)
    return _launch_search(motion_search_mc, "flu_motion_search_mc", cur,
                          prev, search_range, MB)


def motion_search_mc_blocks(cur: torch.Tensor, prev: torch.Tensor,
                            search_range: int = 7, mb: int = MB):
    """K3's contract at block size ``mb`` (8 or 16; H and W multiples of
    it): mv (H/mb, W/mb, 2) int32 of least ``SAD * 64 + |dy| + |dx|``,
    first-scanned ties, and each mb×mb block of the prediction shifted by
    its full vector. CUDA tensors launch the search kernel's ``mb``
    instance; CPU tensors take ``motion_search_mc_blocks_plain``."""
    if not _on_cuda(cur, "motion_search_mc_blocks"):
        return motion_search_mc_blocks_plain(cur, prev, search_range, mb)
    _check_search_args(cur, prev, search_range, mb)
    return _launch_search(motion_search_mc_blocks,
                          "flu_motion_search_mc_blocks", cur, prev,
                          search_range, mb, mb)


def motion_search_mc_dygrid(cur: torch.Tensor, prev: torch.Tensor,
                            search_range: int = 7):
    """K6b's counterpart: K3's contract bit for bit (``motion_search_mc``).
    The TPU kernel's dy-grid schedule (one lane roll per candidate, the dy
    shift resolved outside) has no Hopper counterpart; CUDA tensors
    launch the 16x16 search kernel, CPU tensors take
    ``motion_search_mc_dygrid_plain``."""
    if not _on_cuda(cur, "motion_search_mc_dygrid"):
        return motion_search_mc_dygrid_plain(cur, prev, search_range)
    _check_search_args(cur, prev, search_range)
    return _launch_search(motion_search_mc_dygrid, "flu_motion_search_mc",
                          cur, prev, search_range, MB)


def motion_search_mc_hier(cur: torch.Tensor, prev: torch.Tensor,
                          search_range: int = 7):
    """([C,] H, W) float32 luma, H and W multiples of 16 → (mv ([C,] H/16,
    W/16, 2) int32, pred ([C,] H, W) float32), coarse to fine: K6a's search at mb=8 and
    ±max(1, r // 2) on the 2x2-mean-pooled planes, base = clip(2 *
    coarse, ±(r - 1)), then per macroblock the least plain SAD of base +
    (oy, ox) for oy, ox in -1..1 (first in row-major order wins ties) and
    its prediction. CUDA tensors launch the one K5 kernel on the current
    stream; CPU tensors take ``motion_search_mc_hier_plain``."""
    if not _on_cuda(cur, "motion_search_mc_hier"):
        return motion_search_mc_hier_plain(cur, prev, search_range)
    _check_hier_args(cur, prev, search_range)
    return _launch_search(motion_search_mc_hier, "flu_motion_search_hier",
                          cur, prev, search_range, MB)


def chroma_mc(prev_cb: torch.Tensor, prev_cr: torch.Tensor, mv: torch.Tensor,
              search_range: int = 7):
    """([C,] H/2, W/2) float32 chroma planes and ([C,] H/16, W/16, 2)
    integer luma vectors → (pred_cb, pred_cr): each 8x8 block of a plane comes from the
    plane displaced by its macroblock's vector floor-halved, wrap-around
    (``motion_compensate(plane, mv, mb=8)``, bit for bit). One launch
    covers both planes. CUDA tensors launch the kernel on the current
    stream; CPU tensors take ``chroma_mc_plain``. ``search_range`` is
    accepted for the reference's signature."""
    if not _on_cuda(prev_cb, "chroma_mc"):
        return chroma_mc_plain(prev_cb, prev_cr, mv, search_range)
    _check_chroma_args(prev_cb, prev_cr, mv)
    return _launch_chroma(chroma_mc, "flu_chroma_mc", prev_cb, prev_cr, mv)


def _launch_chroma(wrapper, entry: str, prev_cb, prev_cr, mv):
    """One launch of a chroma entry on the current stream, counted on
    ``wrapper`` → (pred_cb, pred_cr), for one plane pair or C chunks'."""
    # the kernel moves 16 bytes (the vectors 8) at a time; a view may
    # start anywhere
    prev_cb, prev_cr = (t.clone() if t.data_ptr() % 16 else t
                        for t in (prev_cb.contiguous(), prev_cr.contiguous()))
    mv = mv.to(torch.int32).contiguous()
    if mv.data_ptr() % 8:
        mv = mv.clone()
    *lead, hc, wc = prev_cb.shape
    nc = prev_cb.shape[0] if lead else 1
    pcb = torch.empty_like(prev_cb)
    pcr = torch.empty_like(prev_cr)
    lib = _build.load()
    with torch.cuda.device(prev_cb.device):
        stream = torch.cuda.current_stream(prev_cb.device).cuda_stream
        _build.check(getattr(lib, entry)(
            prev_cb.data_ptr(), prev_cr.data_ptr(), mv.data_ptr(),
            pcb.data_ptr(), pcr.data_ptr(), nc, hc, wc, stream),
            f"{entry} launch")
    if nc and hc and wc:
        _build.count_launch(wrapper)
    return pcb, pcr


def halo_rows(search_range: int, stripe_h: int) -> int:
    """The luma halo of the striped route: ``search_range`` rounded up to
    whole macroblocks. ValueError where it exceeds the stripe height."""
    hr = MB * -(-search_range // MB)
    if hr > stripe_h:
        raise ValueError(
            f"a stripe of {stripe_h} rows is thinner than its {hr}-row halo "
            f"(search range {search_range}): use fewer stripes")
    return hr


def motion_search_mc_striped(cur, prev, search_range: int = 7,
                             search=motion_search_mc):
    """One frame's row stripes: ``cur`` and ``prev`` lists of ([C,] Hs, W)
    float32 planes in ring order, each pair on its shard's device →
    (mv list ([C,] Hs/16, W/16, 2) int32, pred list ([C,] Hs, W)): the
    unstriped search's vectors and prediction of each stripe's rows.
    ``search`` (K3 ``motion_search_mc``, K6b, or a plain version) runs on
    each stripe padded by the rounded halo (``halo_rows``): ``prev``'s
    rows from the ring neighbours, ``cur`` zero rows whose macroblocks
    are dropped."""
    hs = cur[0].shape[-2]
    hr = halo_rows(search_range, hs)
    k = hr // MB
    mvs, preds = [], []
    for c, p in zip(cur, exchange_row_halos(prev, hr)):
        mv, pred = search(torch.nn.functional.pad(c, (0, 0, hr, hr)), p,
                          search_range)
        mvs.append(mv[..., k:k + hs // MB, :, :])
        preds.append(pred[..., hr:hr + hs, :])
    return mvs, preds


def chroma_mc_striped(prev_cb, prev_cr, mv, search_range: int = 7,
                      chroma=chroma_mc):
    """Chroma compensation of one frame's row stripes: ``prev_cb``,
    ``prev_cr`` lists of ([C,] Hs/2, W/2) planes in ring order, ``mv`` the
    stripes' luma-grid vectors → (pred_cb list, pred_cr list). ``chroma``
    (K4 ``chroma_mc`` by default, or its plain version) runs on each
    stripe with hr / 2 halo rows (hr: ``halo_rows``), the halo's vectors
    zero; the floor-halved vectors of the stripe's rows stay inside it
    and its halo."""
    hcs = prev_cb[0].shape[-2]
    hc = halo_rows(search_range, 2 * hcs) // 2
    k = hc // 8
    out_cb, out_cr = [], []
    for cb, cr, m in zip(exchange_row_halos(prev_cb, hc),
                         exchange_row_halos(prev_cr, hc), mv):
        m = torch.nn.functional.pad(m, (0, 0, 0, 0, k, k))
        pcb, pcr = chroma(cb, cr, m, search_range)
        out_cb.append(pcb[..., hc:hc + hcs, :])
        out_cr.append(pcr[..., hc:hc + hcs, :])
    return out_cb, out_cr


#: kernel launches since the count was last set to 0, and of them those
#: at ranges above WHOLE_RANGE
motion_search_mc.launches = 0
motion_search_mc_blocks.launches = 0
motion_search_mc_dygrid.launches = 0
motion_search_mc_hier.launches = 0
chroma_mc.launches = 0
motion_search_mc.wide_launches = 0
motion_search_mc_blocks.wide_launches = 0
motion_search_mc_dygrid.wide_launches = 0
motion_search_mc_hier.wide_launches = 0
