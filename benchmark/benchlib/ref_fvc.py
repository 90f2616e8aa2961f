"""The plain reference of the FVC motion encoder (version 2, P frames):
the codec the configuration states, in plain PyTorch on any device,
one chunk at a time, and the container around ``ref_scan``'s scans.

What it computes, in order, per chunk of F RGB frames (frame 0 intra):
the frames edge-padded to whole macroblocks; BT.601 full-range YCbCr,
each product rounded before the sum, left to right; 4:2:0 chroma by the
2x2 mean, summed in row-major order; per P frame the motion search
against the previous reconstruction (a full search of every displacement
within +-r, or the two-level hierarchical search), wrapping at the plane's
edges, each 16x16 SAD summed down each column and then across the
columns, least ``sad * 64 + |dy| + |dx|`` (the hierarchical refine: least
SAD), the first scanned winning ties; the frame coded intra when flat 128
leaves less luma residual (float64 sums); chroma predicted with the
floor-halved vectors; the residual's 8x8 DCT-II, every output a chain of
fused multiply-adds over k = 0..7 from +0; quantization with rounding
half to even at the IJG-scaled Annex K tables, clamped to +-1023; the
in-loop reconstruction through the inverse DCT, clamped to 0..255.

That is the codec's stated arithmetic; the search, compensation and
colour steps are frozen copies of the port's plain versions (their
order of additions is the bitstream's contract), the transform and the
scan are written from their definitions. ``dtype=torch.bfloat16`` runs
the same arithmetic in bfloat16 (the control). It imports nothing of the
program under test.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from . import ref_scan

MB = 16
CLAMP = 1023
#: elements of one batch of shifted planes in the full search
CANDIDATE_ELEMS = 1 << 26

RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168735892, -0.331264108, 0.5],
     [0.5, -0.418687589, -0.081312411]], dtype=np.float32)

LUMA_QTABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.int64)

CHROMA_QTABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99]] + [[99] * 8] * 4, dtype=np.int64)


def scale_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling, clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def zigzag_order() -> np.ndarray:
    """Row-major index of each zigzag position of an 8x8 block."""
    order = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda ij: (ij[0] + ij[1],
                                   ij[1] if (ij[0] + ij[1]) % 2 == 0
                                   else ij[0]))
    return np.array([i * 8 + j for i, j in order])


def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix, rounded to float32."""
    k = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    c = np.cos((2 * x + 1) * k * np.pi / 16) * np.sqrt(2.0 / 8)
    c[0] *= np.sqrt(0.5)
    return c.astype(np.float32)


# ----------------------------------------------------------------------------
# colour
# ----------------------------------------------------------------------------

def edge_pad(p: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(..., H, W) → (..., ph, pw), the last row and column repeated."""
    h, w = p.shape[-2:]
    rows = torch.arange(ph, device=p.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=p.device).clamp(max=w - 1)
    return p.index_select(-2, rows).index_select(-1, cols)


def i420(frames: torch.Tensor, ph: int, pw: int, dtype):
    """(F, H, W, 3) uint8 → Y (F, ph, pw), Cb, Cr (F, ph/2, pw/2)."""
    r, g, b = (edge_pad(frames[..., k], ph, pw).to(dtype) for k in range(3))
    m = [[float(v) for v in row] for row in RGB2YCBCR]
    y = m[0][0] * r + m[0][1] * g + m[0][2] * b
    cb = m[1][0] * r + m[1][1] * g + m[1][2] * b + 128.0
    cr = m[2][0] * r + m[2][1] * g + m[2][2] * b + 128.0
    return y, pool2(cb), pool2(cr)


def pool2(plane: torch.Tensor) -> torch.Tensor:
    """2x2 mean, the four samples added in row-major order."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 2, 2, w // 2, 2)
    s = x[..., 0, :, 0] + x[..., 0, :, 1] + x[..., 1, :, 0] + x[..., 1, :, 1]
    return s / 4.0


# ----------------------------------------------------------------------------
# motion
# ----------------------------------------------------------------------------

def mb_sums(diff: torch.Tensor, mb: int) -> torch.Tensor:
    """([C,] H, W) → per-block sums: each column down its mb rows in
    order, then the mb column sums in order."""
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


def full_search(cur: torch.Tensor, prev: torch.Tensor, r: int,
                mb: int = MB) -> torch.Tensor:
    """([C,] H, W) planes → ([C,] H/mb, W/mb, 2) int32 (dy, dx): least
    ``sad * 64 + |dy| + |dx|`` over +-r, dy-major, the first scanned
    winning ties; candidates a batch of adjacent dx at a time."""
    *lead, h, w = cur.shape
    dev, n = cur.device, 2 * r + 1
    best_cost = torch.full((*lead, h // mb, w // mb), float("inf"),
                           dtype=cur.dtype, device=dev)
    best_mv = torch.zeros((*lead, h // mb, w // mb, 2), dtype=torch.int32,
                          device=dev)
    g = max(1, min(n, CANDIDATE_ELEMS // max(1, cur.numel())))
    xx = torch.arange(w, device=dev)
    for dy in range(-r, r + 1):
        rows = torch.roll(prev, dy, dims=-2)
        for dx0 in range(-r, r + 1, g):
            dxs = torch.arange(dx0, min(dx0 + g, r + 1), device=dev)
            idx = torch.remainder(xx[None, :] - dxs[:, None], w)
            shifted = rows[..., idx].movedim(-2, -3)
            sad = mb_sums((cur[..., None, :, :] - shifted).abs(), mb)
            bias = (abs(dy) + dxs.abs()).to(cur.dtype)[:, None, None]
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


def compensate(prev: torch.Tensor, mv: torch.Tensor, mb: int) -> torch.Tensor:
    """Each mb x mb block from ``prev`` displaced by its vector,
    wrapping: ``out[i, j] = prev[(i - dy) mod H, (j - dx) mod W]``."""
    *lead, h, w = prev.shape
    mv = mv.to(torch.int64)
    dy = mv[..., 0].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    dx = mv[..., 1].repeat_interleave(mb, -2).repeat_interleave(mb, -1)
    yy = torch.arange(h, device=prev.device)[:, None]
    xx = torch.arange(w, device=prev.device)[None, :]
    idx = torch.remainder(yy - dy, h) * w + torch.remainder(xx - dx, w)
    flat = prev.reshape(-1, h * w)
    return torch.gather(flat, 1, idx.reshape(flat.shape[0], h * w)) \
        .reshape(*lead, h, w)


def hier_search(cur: torch.Tensor, prev: torch.Tensor, r: int):
    """+-max(1, r // 2) full search with 8x8 blocks on the 2x2-pooled
    planes, doubled and clipped to +-(r - 1), then the least plain SAD
    of the nine +-1 neighbours (row-major, the first winning ties)."""
    coarse = full_search(pool2(cur), pool2(prev), max(1, r // 2), mb=8)
    base = (coarse * 2).clamp(-(r - 1), r - 1)
    best_cost = torch.full(base.shape[:-1], float("inf"), dtype=cur.dtype,
                           device=cur.device)
    best_mv = torch.zeros_like(base)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            cand = base + torch.tensor([oy, ox], dtype=base.dtype,
                                       device=base.device)
            cost = mb_sums((cur - compensate(prev, cand, MB)).abs(), MB)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_mv = torch.where(better[..., None], cand, best_mv)
    return best_mv


# ----------------------------------------------------------------------------
# transform
# ----------------------------------------------------------------------------

def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c), rounded once: the product is exact in
    float64, the float64 sum's error is recovered (TwoSum), and a sum on
    a float32 midpoint is rounded toward that error."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.float()
    toward = torch.nextafter(r, torch.where(s > r.double(), float("inf"),
                                            float("-inf")).to(r.dtype))
    mid = (s != r.double()) & (s == (r.double() + toward.double()) / 2) \
        & (err != 0)
    up = (err > 0) == (toward > r)
    return torch.where(mid & up, toward, r)


def chain(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """[..., m, 8] @ [..., 8, n]: each output ``acc = a_k * b_k + acc``
    over k = 0..7 from +0, fused and rounded once in float32; in another
    dtype a multiply and an add of that dtype."""
    acc = torch.zeros(torch.broadcast_shapes(a[..., :, :1].shape,
                                             b[..., :1, :].shape),
                      dtype=dtype, device=a.device)
    for k in range(a.shape[-1]):
        ak, bk = a[..., :, k:k + 1], b[..., k:k + 1, :]
        acc = fmaf(ak, bk, acc) if dtype == torch.float32 \
            else acc + ak * bk
    return acc


def blockize(plane: torch.Tensor) -> torch.Tensor:
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)


def unblockize(blocks: torch.Tensor) -> torch.Tensor:
    *lead, bh, bw, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, bh * 8, bw * 8)


def code_plane(resid: torch.Tensor, q: torch.Tensor, c: torch.Tensor,
               zz: torch.Tensor, dtype):
    """Pixel residual plane → (zigzagged int16 coefficients (..., BH, BW,
    64), the reconstructed residual plane): C X C^T, quantized and
    clamped, dequantized, C^T D C."""
    x = blockize(resid)
    coefs = chain(chain(c, x, dtype), c.T, dtype)
    qc = torch.round(coefs / q).to(torch.int32).clamp(-CLAMP, CLAMP)
    deq = qc.to(dtype) * q
    rec = unblockize(chain(chain(c.T, deq, dtype), c, dtype))
    flat = qc.reshape(*qc.shape[:-2], 64)[..., zz].to(torch.int16)
    return flat, rec


# ----------------------------------------------------------------------------
# the chunk
# ----------------------------------------------------------------------------

def pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def encode_chunk(frames: torch.Tensor, quality: int, search_range: int,
                 hier: bool, dtype=torch.float32) -> bytes:
    """(F, H, W, 3) uint8 RGB frames (any device) → one FVC chunk."""
    f, h, w, _ = frames.shape
    ph, pw = pad16(h), pad16(w)
    dev = frames.device
    y, cb, cr = i420(frames, ph, pw, dtype)
    qy = torch.as_tensor(scale_qtable(LUMA_QTABLE, quality), device=dev) \
        .to(dtype)
    qc = torch.as_tensor(scale_qtable(CHROMA_QTABLE, quality), device=dev) \
        .to(dtype)
    c = torch.as_tensor(dct_matrix(), device=dev).to(dtype)
    zz = torch.as_tensor(zigzag_order(), device=dev)
    search = hier_search if hier else full_search
    r = search_range
    records = []
    rec_y = rec_cb = rec_cr = None
    for i in range(f):
        # a chunk axis of one, as the program's planes carry
        cy, ccb, ccr = y[i:i + 1], cb[i:i + 1], cr[i:i + 1]
        if i == 0:
            intra = True
            mv = torch.zeros((1, ph // MB, pw // MB, 2), dtype=torch.int32,
                             device=dev)
            pred_y = pred_cb = pred_cr = 128.0
        else:
            mv = search(cy, rec_y, r)
            pred_p = compensate(rec_y, mv, MB)
            sad_p = (cy - pred_p).abs().sum(dim=(1, 2), dtype=torch.float64)
            sad_i = (cy - 128.0).abs().sum(dim=(1, 2), dtype=torch.float64)
            intra = bool((sad_i < sad_p)[0])
            if intra:
                mv = torch.zeros_like(mv)
            half = torch.div(mv, 2, rounding_mode="floor")
            pred_y = 128.0 if intra else pred_p
            pred_cb = 128.0 if intra else compensate(rec_cb, half, 8)
            pred_cr = 128.0 if intra else compensate(rec_cr, half, 8)
        oy, ry = code_plane(cy - pred_y, qy, c, zz, dtype)
        ocb, rcb = code_plane(ccb - pred_cb, qc, c, zz, dtype)
        ocr, rcr = code_plane(ccr - pred_cr, qc, c, zz, dtype)
        rec_y = (pred_y + ry).clamp(0.0, 255.0)
        rec_cb = (pred_cb + rcb).clamp(0.0, 255.0)
        rec_cr = (pred_cr + rcr).clamp(0.0, 255.0)
        payload = ref_scan.encode_scan(oy[0].cpu().numpy(),
                                       ocb[0].cpu().numpy(),
                                       ocr[0].cpu().numpy())
        mv_bytes = b"" if intra else zlib.compress(
            mv[0].to(torch.int8).cpu().numpy().tobytes(), 6)
        records.append((0 if intra else 1, mv_bytes, payload))
    return container(records, w, h, quality, search_range)


def container(records, w: int, h: int, quality: int,
              search_range: int) -> bytes:
    """The FVC chunk: ``FVC1``, version 2, flags 0x03 (4:2:0, zlib'd
    vectors), width, height, quality, frame count, search range; per
    frame its type (0 I, 1 P), the vectors' and the scan's lengths, the
    vectors, the scan."""
    out = [b"FVC1", struct.pack(">BBHHBB", 2, 3, w, h, quality,
                                len(records)),
           struct.pack(">B", search_range)]
    for ftype, mv_bytes, payload in records:
        out.append(struct.pack(">BHI", ftype, len(mv_bytes), len(payload)))
        out.append(mv_bytes)
        out.append(payload)
    return b"".join(out)
