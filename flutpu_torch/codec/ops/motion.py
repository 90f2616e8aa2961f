"""Motion estimation/compensation, plain PyTorch (port of
flutpu/codec/ops/motion.py, its XLA arm).

Full search over every candidate displacement as a whole-plane tensor op
(roll → absolute difference → per-macroblock sum), wrap-around edges
(``torch.roll``), 16x16 luma macroblocks; 4:2:0 chroma is compensated
with the luma vector floor-halved on an 8x8 grid. These are the plain
versions: the encoder's path runs the search and both compensations in
CUDA kernels (ops/motion_kernels.py), which are held against them.

The per-macroblock SAD is summed in one fixed order — each of the 16
columns down its 16 rows, then the 16 column sums left to right — by
elementwise adds, so it rounds the same on the CPU and on the card, and
the search kernels sum in exactly this order. ``motion_search_hier`` is
the coarse-to-fine search (``search=hier``): a full search with 8x8
blocks on 2x2-pooled planes, then a ±1 refine per macroblock.

Every function also takes a leading chunk axis: (C, H, W) planes and
(C, H/16, W/16, 2) vectors, one plane per GOP chunk, each chunk searched
and compensated inside its own plane exactly as it would be alone (the
counterpart of flutpu's ``vmap`` over its per-chunk codec).
"""

from __future__ import annotations

import torch

from .colorspace import subsample_420

MB = 16  # luma macroblock


def _mb_sums(diff: torch.Tensor, mb: int) -> torch.Tensor:
    """([C,] H, W) → per-macroblock sums ([C,] H/mb, W/mb): each column
    summed down its mb rows in order, then the mb column sums in order."""
    *lead, h, w = diff.shape
    rows = diff.reshape(*lead, h // mb, mb, w)
    col = rows[..., 0, :]
    for i in range(1, mb):
        col = col + rows[..., i, :]
    cols = col.reshape(*lead, h // mb, w // mb, mb)
    s = cols[..., 0]
    for j in range(1, mb):
        s = s + cols[..., j]
    return s


def motion_search(cur_y: torch.Tensor, prev_y: torch.Tensor,
                  search_range: int = 7, mb: int = MB) -> torch.Tensor:
    """Full-search motion estimation.

    cur_y/prev_y: ([C,] H, W) float32 luma (H, W multiples of mb).
    Returns mv ([C,] H/mb, W/mb, 2) int32: per macroblock the (dy, dx) of
    least cost
    ``sad * 64 + |dy| + |dx|`` over the ±search_range window, candidates
    scanned dy-major and the first scanned winning ties. The integer
    center bias is exact in fp32 (SAD ≤ 65280: SAD*64 + 14 < 2^24)."""
    *lead, h, w = cur_y.shape
    n = 2 * search_range + 1
    cur = cur_y.to(torch.float32)
    prev = prev_y.to(torch.float32)
    best_cost = torch.full((*lead, h // mb, w // mb), float("inf"),
                           dtype=torch.float32, device=cur.device)
    best_mv = torch.zeros((*lead, h // mb, w // mb, 2), dtype=torch.int32,
                          device=cur.device)
    for c in range(n * n):
        dy = c // n - search_range
        dx = c % n - search_range
        shifted = torch.roll(prev, (dy, dx), dims=(-2, -1))
        sad = _mb_sums((cur - shifted).abs(), mb)
        cost = sad * 64 + (abs(dy) + abs(dx))
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        cand = torch.tensor([dy, dx], dtype=torch.int32, device=cur.device)
        best_mv = torch.where(better[..., None], cand, best_mv)
    return best_mv


def compensate_blocks(prev: torch.Tensor, mv: torch.Tensor,
                      mb: int) -> torch.Tensor:
    """Each mb×mb block of the output comes from ``prev`` displaced by
    that block's FULL vector (``mv``: ([C,] H/mb, W/mb, 2)), wrap-around
    inside each chunk's plane: ``out[i, j] = prev[(i - dy) mod H, (j - dx)
    mod W]`` (``torch.roll``'s sign). The flat-gather formulation."""
    *lead, h, w = prev.shape
    mv = mv.to(torch.int64)
    dy_full = mv[..., 0].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    dx_full = mv[..., 1].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    yy = torch.arange(h, device=prev.device)[:, None]
    xx = torch.arange(w, device=prev.device)[None, :]
    sy = torch.remainder(yy - dy_full, h)
    sx = torch.remainder(xx - dx_full, w)
    flat = prev.reshape(-1, h * w)
    idx = (sy * w + sx).reshape(flat.shape[0], h * w)
    return torch.gather(flat, 1, idx).reshape(*lead, h, w)


def motion_compensate(prev: torch.Tensor, mv: torch.Tensor,
                      search_range: int = 7, mb: int = MB) -> torch.Tensor:
    """The prediction: each mb×mb block of the output comes from ``prev``
    displaced by its vector, wrap-around. ``mv`` is on the LUMA grid
    (H/16, W/16, 2); for chroma pass mb=8 and the same vectors,
    floor-halved here (``-7 // 2 == -4``). ``search_range`` is accepted
    for the reference's signature."""
    if mb != MB:
        mv = torch.div(mv.to(torch.int64), 2, rounding_mode="floor")
    return compensate_blocks(prev, mv, mb)


def motion_search_hier(cur_y: torch.Tensor, prev_y: torch.Tensor,
                       search_range: int = 7) -> torch.Tensor:
    """Two-level coarse-to-fine motion estimation (flutpu's
    ``motion_search_hier``): a full search of ±max(1, r // 2) with 8x8
    blocks on the 2x2-mean-pooled planes, the coarse vectors doubled and
    clipped to ±(r - 1) as each macroblock's base, then a ±1 refine at
    full resolution. The refine cost is the plain SAD (no centre bias),
    summed in ``_mb_sums``' order; the first of the nine candidates in
    (oy, ox) row-major order wins ties. Vectors stay within ±r."""
    r = search_range
    coarse = motion_search(subsample_420(cur_y), subsample_420(prev_y),
                           max(1, r // 2), mb=8)
    base = (coarse * 2).clamp(-(r - 1), r - 1)
    cur = cur_y.to(torch.float32)
    prev = prev_y.to(torch.float32)
    best_cost = torch.full(base.shape[:-1], float("inf"),
                           dtype=torch.float32, device=cur.device)
    best_mv = torch.zeros_like(base)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            cand = base + torch.tensor([oy, ox], dtype=base.dtype,
                                       device=base.device)
            cost = _mb_sums((cur - compensate_blocks(prev, cand, MB)).abs(),
                            MB)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_mv = torch.where(better[..., None], cand, best_mv)
    return best_mv
