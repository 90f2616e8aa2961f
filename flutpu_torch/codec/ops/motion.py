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

Row stripes (flutpu's sequence-parallel formulations): a frame cut into
row stripes, each on its shard's device, searches and compensates its
own rows from a reference carrying its ring neighbours' edge rows
(``exchange_row_halos``); the ring's wrap reproduces ``torch.roll``'s
whole-frame wrap, so ``motion_search_striped`` and
``motion_compensate_striped`` give the unstriped vectors and
predictions of the stripe's rows.
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


#: elements of one batch of shifted planes in the plain full search
_CANDIDATE_ELEMS = 1 << 26


def motion_search(cur_y: torch.Tensor, prev_y: torch.Tensor,
                  search_range: int = 7, mb: int = MB) -> torch.Tensor:
    """Full-search motion estimation.

    cur_y/prev_y: ([C,] H, W) float32 luma (H, W multiples of mb).
    Returns mv ([C,] H/mb, W/mb, 2) int32: per macroblock the (dy, dx) of
    least cost
    ``sad * 64 + |dy| + |dx|`` over the ±search_range window, candidates
    scanned dy-major and the first scanned winning ties. The integer
    center bias is exact in fp32 (SAD ≤ 65280: SAD*64 + 252 < 2^24 at
    r = 126).

    The candidates of one dy are taken a batch of adjacent dx at a time
    (the batch bounded to ``_CANDIDATE_ELEMS`` values): each candidate's
    SAD is the same elementwise sum as one at a time, and within a batch
    the first least cost wins (a NaN cost counts as +inf, which never
    wins), so the vectors are those of the one-at-a-time scan, in a few
    launches per batch instead of per candidate."""
    *lead, h, w = cur_y.shape
    r = search_range
    n = 2 * r + 1
    cur = cur_y.to(torch.float32)
    prev = prev_y.to(torch.float32)
    dev = cur.device
    best_cost = torch.full((*lead, h // mb, w // mb), float("inf"),
                           dtype=torch.float32, device=dev)
    best_mv = torch.zeros((*lead, h // mb, w // mb, 2), dtype=torch.int32,
                          device=dev)
    g = max(1, min(n, _CANDIDATE_ELEMS // max(1, cur.numel())))
    xx = torch.arange(w, device=dev)
    for dy in range(-r, r + 1):
        rows = torch.roll(prev, dy, dims=-2)
        for dx0 in range(-r, r + 1, g):
            dxs = torch.arange(dx0, min(dx0 + g, r + 1), device=dev)
            # shifted[..., k, i, j] = rows[..., i, (j - dxs[k]) mod W]
            idx = torch.remainder(xx[None, :] - dxs[:, None], w)
            shifted = rows[..., idx].movedim(-2, -3)
            sad = _mb_sums((cur[..., None, :, :] - shifted).abs(), mb)
            bias = (abs(dy) + dxs.abs()).to(torch.float32)[:, None, None]
            cost = sad * 64 + bias
            cost = torch.where(cost.isnan(), float("inf"), cost)
            k = cost.argmin(dim=-3, keepdim=True)
            low = cost.gather(-3, k).squeeze(-3)
            better = low < best_cost
            best_cost = torch.where(better, low, best_cost)
            cand = torch.stack([torch.full_like(k, dy), dxs[k]], dim=-1) \
                .squeeze(-4).to(torch.int32)
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


def exchange_row_halos(stripes, r: int):
    """A frame's row stripes ([C,] Hs, W), in ring order, each on its
    shard's device → each stripe with ``r`` halo rows on either side
    ([C,] Hs + 2r, W): stripe s's last r rows above stripe s + 1 and its
    first r rows below stripe s - 1, ring-wrapped (flutpu's two ring
    ppermutes). Only the halo rows cross devices."""
    n = len(stripes)
    out = []
    for s, p in enumerate(stripes):
        above, below = stripes[(s - 1) % n], stripes[(s + 1) % n]
        if r > above.shape[-2] or r > below.shape[-2]:
            raise ValueError(f"a halo of {r} rows exceeds a stripe of "
                             f"{min(above.shape[-2], below.shape[-2])} rows")
        hs = above.shape[-2]
        out.append(torch.cat([above[..., hs - r:, :].to(p.device), p,
                              below[..., :r, :].to(p.device)], dim=-2))
    return out


def motion_search_striped(cur_s: torch.Tensor, prev_haloed: torch.Tensor,
                          search_range: int = 7, mb: int = MB
                          ) -> torch.Tensor:
    """``motion_search`` on a row stripe ([C,] Hs, W): ``prev_haloed``
    carries ±search_range halo rows (``exchange_row_halos``). Same
    candidate order, cost and tie rule as ``motion_search`` (the SAD in
    ``_mb_sums``' order), so the vectors of the stripe's macroblocks are
    the unstriped ones (flutpu's ``motion_search_striped``)."""
    *lead, hs, w = cur_s.shape
    r = search_range
    cur = cur_s.to(torch.float32)
    prev = prev_haloed.to(torch.float32)
    dev = cur.device
    best_cost = torch.full((*lead, hs // mb, w // mb), float("inf"),
                           dtype=torch.float32, device=dev)
    best_mv = torch.zeros((*lead, hs // mb, w // mb, 2), dtype=torch.int32,
                          device=dev)
    for dy in range(-r, r + 1):
        rows = prev[..., r - dy:r - dy + hs, :]
        for dx in range(-r, r + 1):
            shifted = torch.roll(rows, dx, dims=-1)   # x wrap: stripe-local
            cost = _mb_sums((cur - shifted).abs(), mb) * 64 + (abs(dy)
                                                               + abs(dx))
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            cand = torch.tensor([dy, dx], dtype=torch.int32, device=dev)
            best_mv = torch.where(better[..., None], cand, best_mv)
    return best_mv


def motion_compensate_striped(prev_haloed: torch.Tensor, mv: torch.Tensor,
                              halo: int, search_range: int = 7,
                              mb: int = MB) -> torch.Tensor:
    """``motion_compensate`` on a row stripe: ``prev_haloed`` ([C,] Hs +
    2 halo, W) carries ±``halo`` rows; ``mv`` are the stripe's LUMA-grid
    vectors (for chroma pass mb=8, the chroma-haloed plane with halo =
    (search_range + 1) // 2; the vectors are floor-halved here). The
    prediction of the stripe's rows, as the unstriped one (flutpu's
    ``motion_compensate_striped``)."""
    *lead, hh, w = prev_haloed.shape
    hs = hh - 2 * halo
    mv = mv.to(torch.int64)
    if mb != MB:
        mv = torch.div(mv, 2, rounding_mode="floor")
    dy = mv[..., 0].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    dx = mv[..., 1].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    yy = torch.arange(hs, device=prev_haloed.device)[:, None]
    xx = torch.arange(w, device=prev_haloed.device)[None, :]
    # out[i, j] = haloed[halo + i - dy, (j - dx) mod W]
    idx = (halo + yy - dy) * w + torch.remainder(xx - dx, w)
    flat = prev_haloed.reshape(-1, hh * w)
    return torch.gather(flat, 1, idx.reshape(flat.shape[0], hs * w)) \
        .reshape(*lead, hs, w)


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


def _gather_shifted(prev: torch.Tensor, dy_full: torch.Tensor,
                    dx_full: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = prev[..., (i - dy) mod H, (j - dx) mod W]`` for
    per-pixel shifts ``dy_full``/``dx_full`` of ``prev``'s shape (a leading
    chunk axis included): one flat gather inside each chunk's plane."""
    *lead, h, w = prev.shape
    yy = torch.arange(h, device=prev.device)[:, None]
    xx = torch.arange(w, device=prev.device)[None, :]
    idx = torch.remainder(yy - dy_full, h) * w + torch.remainder(
        xx - dx_full, w)
    flat = prev.reshape(-1, h * w)
    return torch.gather(flat, 1, idx.reshape(flat.shape[0], h * w)) \
        .reshape(*lead, h, w)


def motion_compensate_subpel(prev: torch.Tensor, mv_hp: torch.Tensor,
                             mb: int = MB) -> torch.Tensor:
    """Half-pel motion compensation (flutpu's
    ``motion_compensate_subpel``): ``mv_hp`` ([C,] H/16, W/16, 2) is in
    HALF-PIXEL units on the luma grid (chroma: pass mb=8, the vectors are
    floor-halved onto the chroma grid, still in half-pel units). Each
    output pixel is the bilinear mix of the four integer-shift samples
    around its half-pel displacement, wrap-around, weighted and summed in
    the original's expression order. The weights are 0, 1/2 or 1 per
    axis, so every product is exact and the result depends on that order
    alone."""
    d = mv_hp.to(torch.int64)
    if mb != MB:
        d = torch.div(d, 2, rounding_mode="floor")
    dyf = d[..., 0].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    dxf = d[..., 1].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    iy = torch.div(dyf, 2, rounding_mode="floor")
    ix = torch.div(dxf, 2, rounding_mode="floor")
    fy = (dyf - 2 * iy).to(prev.dtype) * 0.5     # 0 or .5
    fx = (dxf - 2 * ix).to(prev.dtype) * 0.5
    p00 = _gather_shifted(prev, iy, ix)
    p10 = _gather_shifted(prev, iy + 1, ix)
    p01 = _gather_shifted(prev, iy, ix + 1)
    p11 = _gather_shifted(prev, iy + 1, ix + 1)
    return ((1 - fy) * (1 - fx) * p00 + fy * (1 - fx) * p10
            + (1 - fy) * fx * p01 + fy * fx * p11)


def _block_sums(diff: torch.Tensor) -> torch.Tensor:
    """(..., MB, MB) → (...): each column summed down its rows in order,
    then the column sums in order (``_mb_sums``' order, on blocks)."""
    col = diff[..., 0, :]
    for i in range(1, diff.shape[-2]):
        col = col + diff[..., i, :]
    s = col[..., 0]
    for j in range(1, col.shape[-1]):
        s = s + col[..., j]
    return s


def subpel_refine(cur_y: torch.Tensor, prev_y: torch.Tensor,
                  int_mv: torch.Tensor) -> torch.Tensor:
    """±half-pel refinement around integer vectors (flutpu's
    ``subpel_refine``) over ([C,] H, W) luma planes and ([C,] H/16, W/16,
    2) integer vectors. One (MB+2)x(MB+2) window per macroblock is
    gathered at the integer vector; the nine half-pel candidates are
    averages of its shifted slices; per macroblock the least SAD wins,
    the first in (oy, ox) row-major order on a tie. The SAD is summed in
    ``_mb_sums``' fixed order, so the CPU and the card agree. Returns
    vectors in HALF-PIXEL units: 2 * int_mv + offset, offset in
    {-1, 0, 1}^2."""
    *lead, h, w = cur_y.shape
    mbh, mbw = h // MB, w // MB
    dev = cur_y.device
    base = int_mv.to(torch.int64)
    by = (torch.arange(mbh, device=dev) * MB)[:, None, None, None]
    bx = (torch.arange(mbw, device=dev) * MB)[None, :, None, None]
    wy = (torch.arange(MB + 2, device=dev) - 1)[None, None, :, None]
    wx = (torch.arange(MB + 2, device=dev) - 1)[None, None, None, :]
    sy = torch.remainder(by + wy - base[..., 0][..., None, None], h)
    sx = torch.remainder(bx + wx - base[..., 1][..., None, None], w)
    flat = prev_y.reshape(-1, h * w)
    idx = (sy * w + sx).reshape(flat.shape[0], -1)
    win = torch.gather(flat, 1, idx).reshape(*lead, mbh, mbw, MB + 2, MB + 2)
    cur_b = cur_y.reshape(*lead, mbh, MB, mbw, MB).transpose(-3, -2)

    def rows(a):
        # source row j = i + 1 - a/2 for half-offset a in {-1, 0, 1}
        if a == 0:
            return win[..., 1:1 + MB, :]
        if a == 1:
            return 0.5 * (win[..., 0:MB, :] + win[..., 1:1 + MB, :])
        return 0.5 * (win[..., 1:1 + MB, :] + win[..., 2:2 + MB, :])

    def cols(x, a):
        if a == 0:
            return x[..., 1:1 + MB]
        if a == 1:
            return 0.5 * (x[..., 0:MB] + x[..., 1:1 + MB])
        return 0.5 * (x[..., 1:1 + MB] + x[..., 2:2 + MB])

    best_cost = torch.full(base.shape[:-1], float("inf"),
                           dtype=cur_y.dtype, device=dev)
    best_mv = torch.zeros_like(base)
    for ay in (-1, 0, 1):
        r = rows(ay)
        for ax in (-1, 0, 1):
            cost = _block_sums((cur_b - cols(r, ax)).abs())
            off = torch.tensor([ay, ax], dtype=torch.int64, device=dev)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_mv = torch.where(better[..., None], 2 * base + off, best_mv)
    return best_mv.to(torch.int32)
