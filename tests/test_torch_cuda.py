"""flutpu_torch's CUDA kernels against their plain PyTorch versions, and
the encoders on the card against the same encoders on the CPU.

Every test here needs an NVIDIA GPU and nvcc: it is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false. The file imports no
jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.jpeg import JpegEncoder
from flutpu_torch.codec.ops import entropy_kernels as K
from flutpu_torch.codec.ops.entropy import _slot_tables, _slot_tables_merged
from flutpu_torch.codec.ops import frontend as F
from flutpu_torch.codec.ops import motion_kernels as M
from flutpu_torch.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                          scale_qtable)
from flutpu_torch.core.elements import make_test_frame
from torch_helpers import (chunk_pairs, cuda_device,  # noqa: F401
                           dispatch_entries, pack_edge_blocks, planar_drift,
                           rand_planes, slot_tables, tie_contract)

torch.set_num_threads(1)

QY = scale_qtable(LUMA_QTABLE, 85)
QC = scale_qtable(CHROMA_QTABLE, 85)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1088, 1920), (1, 48, 80)])
def test_front_end_kernel_matches_plain(cuda_device, shape):
    planes = [torch.from_numpy(p).to(cuda_device)
              for p in rand_planes(*shape, seed=6)]
    qy = torch.from_numpy(QY).to(cuda_device)
    qc = torch.from_numpy(QC).to(cuda_device)
    before = F.front_end.launches
    got = F.front_end(*planes, qy, qc)
    assert F.front_end.launches == before + 1
    want = F.front_end_plain(*planes, qy, qc)
    for a, c in zip(got, want):
        assert a.shape == c.shape and a.dtype == c.dtype == torch.int16
        tie_contract(a.cpu().numpy(), c.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 16, 16), (3, 48, 160), (2, 32, 1936),
                                   (1, 32, 3840), (2, 2160, 3840)])
def test_front_end_strip_kernel_shapes(cuda_device, shape):
    """Widths that are no multiple of the kernel's 128-column strip, one
    macroblock, and 4K; planes that are views at odd addresses."""
    f, h, w = shape
    planes = [torch.from_numpy(p).to(cuda_device)
              for p in rand_planes(*shape, seed=11)]
    qy = torch.from_numpy(QY).to(cuda_device)
    qc = torch.from_numpy(QC).to(cuda_device)
    got = F.front_end(*planes, qy, qc)
    for a, c in zip(got, F.front_end_plain(*planes, qy, qc)):
        tie_contract(a.cpu().numpy(), c.cpu().numpy(), 1e-4)
    # the same planes as slices that start 1 byte into a larger buffer
    views = []
    for p in planes:
        buf = torch.empty(p.numel() + 1, dtype=torch.uint8,
                          device=cuda_device)
        buf[1:] = p.reshape(-1)
        views.append(buf[1:].view(f, h, w))
    for a, c in zip(F.front_end(*views, qy, qc), got):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n", [(96, 160, 4), (1088, 1920, 3),
                                   (2160, 3840, 2)])
def test_gradient_ball_planes_on_card_match_cpu(cuda_device, h, w, n):
    """The on-device source gives the CPU's values on the card: its ramps
    divide by a tensor, where a Python divisor would become a product
    with the reciprocal on the card and round some levels down."""
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    for start in (0, 37):
        card = gradient_ball_planes(h, w, n, start, device=cuda_device)
        cpu = gradient_ball_planes(h, w, n, start, device="cpu")
        for a, b in zip(card, cpu):
            assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_front_end_quotient_equals_ieee_division(cuda_device):
    """The quantizer divides through the table entry's reciprocal; the
    library compares that with IEEE division for every divisor 1..255 and
    every float of magnitude 2^-3..2^12, both signs."""
    pairs, bad = F.quotient_check(cuda_device)
    assert pairs == 255 * 15 * 2 ** 23 * 2 and bad == 0


@pytest.mark.cuda
def test_front_end_raises_on_table_entries_outside_1_255(cuda_device):
    planes = [torch.from_numpy(p).to(cuda_device)
              for p in rand_planes(1, 16, 16, seed=3)]
    good = torch.from_numpy(QY).to(cuda_device)
    for bad_value in (0, 256):
        bad = good.clone()
        bad[3, 4] = bad_value
        before = F.front_end.launches
        with pytest.raises(ValueError):
            F.front_end(*planes, bad, good)
        with pytest.raises(ValueError):
            F.front_end(*planes, good, bad)
        assert F.front_end.launches == before
    table = good.clone()
    F.front_end(*planes, table, good)
    table[0, 0] = 0          # a table changed in place is read again
    with pytest.raises(ValueError):
        F.front_end(*planes, table, good)


def _blocks(n, seed, dense):
    rng = np.random.default_rng(seed)
    z = rng.integers(-60, 60, (n, 64)).astype(np.int32)
    z = np.where(rng.random((n, 64)) < (0.5 if dense else 0.1), z, 0)
    z[:, 0] = rng.integers(-2047, 2047, n)
    z[0, 1:] = 0
    z[0, 63] = -3                 # three ZRLs, no EOB
    comp = np.tile(np.array([0, 0, 0, 0, 1, 1], np.int32), n // 6 + 1)[:n]
    z[-100:], comp[-100:] = 0, -1  # padding blocks
    return z.astype(np.int32), comp


@pytest.mark.cuda
@pytest.mark.parametrize("seg_words", [64, 4])
def test_pack_kernel_matches_plain(cuda_device, seg_words):
    z, comp = _blocks(4096, seed=7, dense=seg_words == 4)
    zt, ct = torch.from_numpy(z), torch.from_numpy(comp)
    want_buf, want_bits = K.pack_segments_plain(zt, ct, 16, seg_words)
    before = K.pack_segments.launches
    buf, bits = K.pack_segments(zt.to(cuda_device), ct.to(cuda_device), 16,
                                seg_words)
    assert K.pack_segments.launches == before + 1
    if seg_words == 4:
        assert (want_bits > 4 * 32).any()
    assert torch.equal(bits.cpu(), want_bits)
    assert torch.equal(buf.cpu(), want_buf)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_block_pack_kernels_match_plain(cuda_device, dense):
    """K7, K8a (on the merged slot tables) and K8b (on the 32-bit slot
    tables) bit-identical to their plain versions and to each other, on
    sparse and on dense blocks."""
    z, comp = _blocks(3000, seed=8, dense=dense)
    comp = np.maximum(comp, 0)           # the non-segment layout: 0 / 1
    zt, ct = torch.from_numpy(z), torch.from_numpy(comp)
    cases = [(K.pack_block_bits_fused, K.pack_block_bits_fused_plain,
              (zt, ct)),
             (K.pack_block_bits64, K.pack_block_bits64_plain,
              _slot_tables_merged(zt, ct)),
             (K.pack_block_bits, K.pack_block_bits_plain,
              _slot_tables(zt, ct))]
    first = None
    for kernel, plain, args in cases:
        want = plain(*args)
        before = kernel.launches
        got = kernel(*(a.to(cuda_device) for a in args))
        assert kernel.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        first = first or want
        for a, b in zip(want, first):
            assert torch.equal(a, b)


#: (seg_g, seg_words): 1, 2, 16 and 17 blocks per segment; one word,
#: segments over capacity, the encoder's largest buffer (832), buffers past
#: all a segment can fill (1000: the staging row is shorter than the
#: buffer), rows that take more than 48 KB of shared memory per CTA (3400)
PACK_SHAPES = [(1, 64), (2, 64), (16, 64), (17, 64), (16, 1), (16, 4),
               (16, 832), (16, 1000), (17, 1000), (64, 3400)]


@pytest.mark.cuda
@pytest.mark.parametrize("seg_g,seg_words", PACK_SHAPES)
def test_pack_kernel_edge_cases(cuda_device, seg_g, seg_words):
    """K2 (a lane per block) bit for bit against its plain version on
    ``pack_edge_blocks`` (every size cap, ZRL count, EOB rule, dense
    blocks, padding blocks and a whole padding segment), at 13 segments
    (no whole number of a warp's segments, nor of a CTA's warps) and at
    about 120,000 blocks (more than the card's resident warps take at
    once: a warp walks several units)."""
    for n_segs in (13, max(13, 120_000 // seg_g)):
        z, comp = pack_edge_blocks(n_segs, seg_g, seed=n_segs + seg_words)
        zt, ct = torch.from_numpy(z), torch.from_numpy(comp)
        want = K.pack_segments_plain(zt, ct, seg_g, seg_words)
        zc, cc = zt.to(cuda_device), ct.to(cuda_device)
        before = K.pack_segments.launches
        got = K.pack_segments(zc, cc, seg_g, seg_words)
        torch.cuda.synchronize()
        assert K.pack_segments.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [13, 120_001])
def test_block_pack_kernel_edge_cases(cuda_device, n_blocks):
    """K7 (a lane per block) on ``pack_edge_blocks`` at one block per
    segment: bit for bit its plain version, and K8a and K8b on the slot
    tables of the same blocks."""
    z, comp = pack_edge_blocks(n_blocks, 1, seed=n_blocks, padding=False)
    zt, ct = torch.from_numpy(z), torch.from_numpy(comp)
    want = K.pack_block_bits_fused_plain(zt, ct)
    zc, cc = zt.to(cuda_device), ct.to(cuda_device)
    before = K.pack_block_bits_fused.launches
    outs = [K.pack_block_bits_fused(zc, cc),
            K.pack_block_bits64(*_slot_tables_merged(zc, cc)),
            K.pack_block_bits(*_slot_tables(zc, cc))]
    torch.cuda.synchronize()
    assert K.pack_block_bits_fused.launches == before + 1
    for got in outs:
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("n_blocks,n_slots", [
    (13, 1), (13, 7), (13, 65), (13, 191), (120_001, 65), (120_001, 191),
    (70, 33), (45, 700), (5, 1024)])
def test_slot_pack_kernels_on_hand_made_tables(cuda_device, wide, n_blocks,
                                               n_slots):
    """K8a (``wide``) and K8b on ``slot_tables`` (not made from blocks)
    with random bits above every length: bit for bit the plain version.
    13 blocks fill no warp; 120,001 take more
    than the card's resident warps at once (a warp walks several units);
    33 slots take two lanes per block, 700 and 1,024 (``MAX_SLOTS``) one
    block per warp at 22 and 32 slots a lane; spans start anywhere in a
    16-byte word."""
    tables = [torch.from_numpy(a).to(cuda_device) for a in slot_tables(
        n_blocks, n_slots, wide, seed=n_blocks + n_slots, garbage=True)]
    kernel = K.pack_block_bits64 if wide else K.pack_block_bits
    plain = K.pack_block_bits64_plain if wide else K.pack_block_bits_plain
    before = kernel.launches
    got = kernel(*tables)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a, b in zip(got, plain(*tables)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [True, False])
def test_slot_pack_kernels_refuse_past_max_slots(cuda_device, wide):
    """Past ``MAX_SLOTS`` slots per block the wrappers raise and launch
    nothing; a view that starts off a 16-byte boundary still packs."""
    tables = [torch.from_numpy(a).to(cuda_device) for a in slot_tables(
        4, K.MAX_SLOTS + 1, wide, seed=1)]
    kernel = K.pack_block_bits64 if wide else K.pack_block_bits
    plain = K.pack_block_bits64_plain if wide else K.pack_block_bits_plain
    before = kernel.launches
    with pytest.raises(ValueError):
        kernel(*tables)
    assert kernel.launches == before
    n = 4 * K.MAX_SLOTS                     # contiguous, 4 bytes off
    view = [t.reshape(-1)[1:n + 1].view(4, K.MAX_SLOTS) for t in tables]
    for a, b in zip(kernel(*view), plain(*view)):
        assert torch.equal(a, b)
    assert kernel.launches == before + 1


@pytest.mark.cuda
def test_pack_kernel_refuses_a_staging_row_past_shared_memory(cuda_device):
    """At seg_g 1066 one warp's staging row and tile no longer fit a CTA's
    227 KB: the wrapper raises and launches nothing. At 1065 (230 KB, one
    warp per CTA) they fit and the kernel equals its plain version."""
    z = torch.zeros((1066, 64), dtype=torch.int32, device=cuda_device)
    comp = torch.zeros((1066,), dtype=torch.int32, device=cuda_device)
    z[:, 0] = torch.arange(1066, device=cuda_device) % 7 - 3
    before = K.pack_segments.launches
    with pytest.raises(ValueError):
        K.pack_segments(z, comp, 1066, 60_000)
    assert K.pack_segments.launches == before
    got = K.pack_segments(z[:1065], comp[:1065], 1065, 60_000)
    assert K.pack_segments.launches == before + 1
    want = K.pack_segments_plain(z[:1065].cpu(), comp[:1065].cpu(), 1065,
                                 60_000)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["pack_segments", "pack_block_bits_fused",
                                     "pack_block_bits64", "pack_block_bits"])
def test_pack_wrappers_count_no_launch_for_no_blocks(cuda_device, wrapper):
    """An empty batch launches nothing, so the count stays as it was."""
    z = torch.zeros((0, 64), dtype=torch.int32, device=cuda_device)
    comp = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    slots = torch.zeros((0, 65), dtype=torch.int32, device=cuda_device)
    args = {"pack_segments": (z, comp), "pack_block_bits_fused": (z, comp),
            "pack_block_bits64": (slots, slots, slots),
            "pack_block_bits": (slots, slots)}[wrapper]
    kernel = getattr(K, wrapper)
    before = kernel.launches
    buf, bits = kernel(*args)
    assert kernel.launches == before
    assert buf.shape[0] == bits.shape[0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("segmented,no_fused",[(True, False), (False, False),
                                                (False, True)])
def test_encoder_on_card_matches_cpu(cuda_device, segmented, no_fused,
                                     monkeypatch):
    if no_fused:
        monkeypatch.setenv("FLUTPU_NO_FUSED_PACK", "1")
    frames = np.stack([make_test_frame("gradient", 72, 40, i)
                       for i in range(3)])
    got = JpegEncoder(segmented=segmented,
                      device=cuda_device).encode_gop(frames)
    assert got == JpegEncoder(device="cpu").encode_gop(frames)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,r", [(1088, 1920, 7), (96, 160, 7),
                                   (96, 160, 4), (64, 96, 5)])
def test_motion_search_kernel_matches_plain(cuda_device, h, w, r):
    """The kernel sums each SAD in the plain version's order, so vectors
    and predictions are bit-identical, not only near-tie-equal."""
    rng = np.random.default_rng(h + r)
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    cur = (np.roll(prev, (3, -5), axis=(0, 1))
           + rng.normal(0, 2, (h, w))).astype(np.float32)
    c = torch.from_numpy(cur).to(cuda_device)
    p = torch.from_numpy(prev).to(cuda_device)
    before = M.motion_search_mc.launches
    mv, pred = M.motion_search_mc(c, p, r)
    torch.cuda.synchronize()
    assert M.motion_search_mc.launches == before + 1
    mv_p, pred_p = M.motion_search_mc_plain(c, p, r)
    assert torch.equal(mv, mv_p)
    assert torch.equal(pred, pred_p)


@pytest.mark.cuda
@pytest.mark.parametrize("mb", [8, 16])
@pytest.mark.parametrize("r", [0, 1, 3, 7, 16, 32])
@pytest.mark.parametrize("h,w", [(32, 48), (96, 160)])
def test_search_kernel_ranges_and_block_sizes(cuda_device, h, w, r, mb):
    """Every range class of the tiled search (one group of shifts, several,
    a spare shift in the last group, windows wider than the plane) at both
    block sizes, on non-integer and integer-valued planes (ties abound in
    the latter): vectors and prediction bit-identical to the plain
    version."""
    rng = np.random.default_rng(1000 * r + h + mb)
    for integer in (False, True):
        cur, prev = _rolled_pair(h, w, 7 * r + mb, (min(r, 2), -min(r, 3)))
        if integer:
            prev = rng.integers(0, 4, (h, w)).astype(np.float32)
            cur = np.roll(prev, (min(r, 1), 0), axis=(0, 1))
            cur[:mb] = rng.integers(0, 4, (mb, w))
        c, p = (torch.from_numpy(a).to(cuda_device) for a in (cur, prev))
        mv, pred = M.motion_search_mc_blocks(c, p, r, mb)
        mv_p, pred_p = M.motion_search_mc_blocks_plain(c, p, r, mb)
        assert torch.equal(mv, mv_p)
        assert torch.equal(pred, pred_p)
        if mb == 16:
            for a, b in zip(M.motion_search_mc(c, p, r),
                            M.motion_search_mc_plain(c, p, r)):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mb", [8, 16])
def test_search_kernel_plane_smaller_than_window_and_nan(cuda_device, mb):
    """A 16x16 plane at r = 32 (the wrap goes round several times), and
    planes whose costs are all NaN, or NaN for one block only: a NaN cost
    never wins and a block without a winner keeps (0, 0)."""
    cur, prev = _rolled_pair(16, 16, 3, (1, -2))
    c, p = (torch.from_numpy(a).to(cuda_device) for a in (cur, prev))
    for a, b in zip(M.motion_search_mc_blocks(c, p, 32, mb),
                    M.motion_search_mc_blocks_plain(c, p, 32, mb)):
        assert torch.equal(a, b)
    cur, prev = _rolled_pair(48, 64, 4)
    nan = np.full_like(cur, np.nan)
    part = cur.copy()
    part[:mb, :mb] = np.nan
    for a in (nan, part):
        c, p = (torch.from_numpy(x).to(cuda_device) for x in (a, prev))
        mv, pred = M.motion_search_mc_blocks(c, p, 3, mb)
        mv_p, pred_p = M.motion_search_mc_blocks_plain(c, p, 3, mb)
        assert torch.equal(mv, mv_p)
        assert not mv[0, 0].any()
        assert torch.equal(pred, pred_p)


def _rolled_pair(h, w, seed, shift=(3, -5)):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    cur = (np.roll(prev, shift, axis=(0, 1))
           + rng.normal(0, 2, (h, w))).astype(np.float32)
    return cur, prev


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,r,mb", [(1088, 1920, 7, 16), (544, 960, 3, 8),
                                      (96, 160, 7, 16), (96, 160, 3, 8),
                                      (48, 80, 7, 8)])
def test_blocks_search_kernel_matches_plain(cuda_device, h, w, r, mb):
    """K6a: the search kernel's 8x8 and 16x16 instances, bit-identical to
    the plain version (vectors and the full-vector block prediction)."""
    c, p = (torch.from_numpy(a).to(cuda_device)
            for a in _rolled_pair(h, w, h + r + mb, (2, -3)))
    before = M.motion_search_mc_blocks.launches
    mv, pred = M.motion_search_mc_blocks(c, p, r, mb)
    torch.cuda.synchronize()
    assert M.motion_search_mc_blocks.launches == before + 1
    mv_p, pred_p = M.motion_search_mc_blocks_plain(c, p, r, mb)
    assert torch.equal(mv, mv_p)
    assert torch.equal(pred, pred_p)


def _same_bits(a, b):
    """Equal values, a NaN equal to the same NaN (the predictions copy
    prev's values, they compute none)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,r", [(1088, 1920, 7), (96, 160, 7),
                                   (96, 160, 3), (64, 96, 1), (96, 160, 1),
                                   (96, 160, 2), (96, 160, 16),
                                   (96, 160, 32), (96, 176, 7),
                                   (64, 96, 32)])
def test_hier_kernels_match_plain(cuda_device, h, w, r):
    """K5: one launch of the hier kernel (K6a's wrapper counts none),
    bit-identical to the plain version, on a rolled plane with
    one divergent macroblock, a flat plane (every refine candidate ties),
    a plane of NaN (every cost NaN: (0, 0)) and a pair with NaN in one
    macroblock of cur and one pixel of prev. 96x176 leaves a thread block
    with 3 of its 8 macroblocks; at r = 32 a 64x96 plane is smaller than
    the staged window, which wraps more than once."""
    cur, prev = _rolled_pair(h, w, h + r, (4, -3))
    cur[16:32, 32:48] = np.random.default_rng(r).uniform(0, 255, (16, 16))
    flat = np.full((h, w), 100.0, np.float32)
    nan = np.full((h, w), np.nan, np.float32)
    part_c, part_p = cur.copy(), prev.copy()
    part_c[16:32, 16:32] = np.nan
    part_p[h // 2, w // 3] = np.nan
    for a, b in ((cur, prev), (flat, flat), (nan, prev), (part_c, part_p)):
        c, p = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
        before = (M.motion_search_mc_hier.launches,
                  M.motion_search_mc_blocks.launches)
        mv, pred = M.motion_search_mc_hier(c, p, r)
        torch.cuda.synchronize()
        assert (M.motion_search_mc_hier.launches,
                M.motion_search_mc_blocks.launches) == (before[0] + 1,
                                                        before[1])
        mv_p, pred_p = M.motion_search_mc_hier_plain(c, p, r)
        assert torch.equal(mv, mv_p)
        assert _same_bits(pred, pred_p)
    assert not M.motion_search_mc_hier(
        torch.from_numpy(nan).to(cuda_device),
        torch.from_numpy(prev).to(cuda_device), r)[0].any()


@pytest.mark.cuda
def test_dygrid_counterpart_matches_plain(cuda_device):
    c, p = (torch.from_numpy(a).to(cuda_device)
            for a in _rolled_pair(96, 160, 5))
    before = M.motion_search_mc_dygrid.launches
    got = M.motion_search_mc_dygrid(c, p, 7)
    assert M.motion_search_mc_dygrid.launches == before + 1
    for a, b in zip(got, M.motion_search_mc_dygrid_plain(c, p, 7)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hc,wc,r", [(544, 960, 7), (544, 960, 5),
                                     (48, 80, 4), (544, 960, 32),
                                     (24, 40, 7), (16, 8, 32)])
def test_chroma_kernel_matches_plain(cuda_device, hc, wc, r):
    """K4 bit-identical to the plain version, with odd negative vectors
    (floor-halved, not truncated) and widths of 5 and 1 blocks (a row of
    a 40-wide plane wraps inside a 16-byte word); at r = 32 a vector
    moves a 16x8 plane round more than once."""
    rng = np.random.default_rng(hc + r)
    cb, cr = (torch.from_numpy(rng.normal(128, 30, (hc, wc))
                               .astype(np.float32)).to(cuda_device)
              for _ in range(2))
    mv = rng.integers(-r, r + 1, (hc // 8, wc // 8, 2)).astype(np.int32)
    mv[0, 0] = (-r | 1, -(r // 2) | 1)           # odd and negative
    mv = torch.from_numpy(mv).to(cuda_device)
    before = M.chroma_mc.launches
    got = M.chroma_mc(cb, cr, mv, r)
    assert M.chroma_mc.launches == before + 1
    for a, b in zip(got, M.chroma_mc_plain(cb, cr, mv, r)):
        assert torch.equal(a, b)


# -- the chunk axis (cudahype) ------------------------------------------------

SEARCHES = {"K3": (lambda c, p, r: M.motion_search_mc(c, p, r),
                   lambda c, p, r: M.motion_search_mc_plain(c, p, r),
                   "motion_search_mc"),
            "K5": (lambda c, p, r: M.motion_search_mc_hier(c, p, r),
                   lambda c, p, r: M.motion_search_mc_hier_plain(c, p, r),
                   "motion_search_mc_hier"),
            "K6a-8": (lambda c, p, r: M.motion_search_mc_blocks(c, p, r, 8),
                      lambda c, p, r: M.motion_search_mc_blocks_plain(
                          c, p, r, 8), "motion_search_mc_blocks"),
            "K6b": (lambda c, p, r: M.motion_search_mc_dygrid(c, p, r),
                    lambda c, p, r: M.motion_search_mc_dygrid_plain(c, p, r),
                    "motion_search_mc_dygrid")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SEARCHES))
@pytest.mark.parametrize("c,h,w,r", [(1, 96, 160, 7), (3, 96, 160, 7),
                                     (8, 96, 176, 7), (3, 64, 96, 32),
                                     (8, 1088, 1920, 7)])
def test_batched_search_kernels(cuda_device, name, c, h, w, r):
    """K3, K5, K6a and K6b over C chunks' planes in ONE launch: each
    chunk bit-identical to its own C = 1 launch and to the plain version
    (which takes the same chunk axis), on unlike chunks (rolled, static,
    scene cut, flat, integer-valued); the wrap stays inside each chunk's
    plane (at r = 32 a 64x96 plane is smaller than the window)."""
    kernel, plain, wrapper = SEARCHES[name]
    count = getattr(M, wrapper)
    cur, prev = (torch.from_numpy(a).to(cuda_device)
                 for a in chunk_pairs(c, h, w, seed=c + h + r))
    before = count.launches
    mv, pred = kernel(cur, prev, r)
    torch.cuda.synchronize()
    assert count.launches == before + 1
    assert mv.shape[0] == pred.shape[0] == c
    mv_p, pred_p = plain(cur, prev, r)
    assert torch.equal(mv, mv_p)
    assert _same_bits(pred, pred_p)
    for k in range(c):
        one_mv, one_pred = kernel(cur[k], prev[k], r)
        assert torch.equal(mv[k], one_mv)
        assert _same_bits(pred[k], one_pred)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hc,wc,r", [(1, 544, 960, 7), (3, 48, 80, 4),
                                       (8, 544, 960, 7), (3, 16, 8, 32)])
def test_batched_chroma_kernel(cuda_device, c, hc, wc, r):
    """K4 over C chunks' plane pairs in one launch: bit-identical to the
    plain version and to each chunk's own launch (a chunk's rows wrap
    inside its own planes)."""
    rng = np.random.default_rng(c + hc + r)
    cb, cr = (torch.from_numpy(rng.normal(128, 30, (c, hc, wc))
                               .astype(np.float32)).to(cuda_device)
              for _ in range(2))
    mv = rng.integers(-r, r + 1, (c, hc // 8, wc // 8, 2)).astype(np.int32)
    mv[:, 0, 0] = (-r | 1, -(r // 2) | 1)
    mv = torch.from_numpy(mv).to(cuda_device)
    before = M.chroma_mc.launches
    got = M.chroma_mc(cb, cr, mv, r)
    assert M.chroma_mc.launches == before + 1
    for a, b in zip(got, M.chroma_mc_plain(cb, cr, mv, r)):
        assert torch.equal(a, b)
    for k in range(c):
        for a, b in zip(M.chroma_mc(cb[k], cr[k], mv[k], r),
                        (got[0][k], got[1][k])):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_state_initialises_once_under_threads(cuda_device):
    """Several encoder threads launching first at the same moment: the
    per-device constants of K1 and K2 are uploaded once, no thread
    launches before they are there, every thread's GOP equals the CPU's,
    and every launch is counted."""
    import threading
    frames = np.stack([make_test_frame("ball", 96, 64, i) for i in range(4)])
    want = JpegEncoder(85, device="cpu").encode_gop(frames)
    F._ready_devices.discard(cuda_device)
    K._ready_devices.discard(cuda_device)
    n = 6
    gate, out, errors = threading.Barrier(n), [None] * n, []
    before = (F.front_end.launches, K.pack_segments.launches)

    def run(i):
        try:
            enc = JpegEncoder(85, device=cuda_device)
            gate.wait()
            out[i] = enc.encode_gop(frames)
        except Exception as e:     # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(o == want for o in out)
    assert (F.front_end.launches, K.pack_segments.launches) == (
        before[0] + n, before[1] + n)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["jpeg", "fvc", "fvc-motion",
                                   "fvc-motion search=hier bframes=1",
                                   "fvc-motion subpel=true"])
def test_cudahype_on_card(cuda_device, codec):
    """cudahype on the card, 3 chunks per dispatch, 14 frames of unlike
    chunks (a truncated last batch): JPEG bytes equal a plain encode of
    the same frames; FVC chunks equal per-chunk encodes on the card byte
    for byte (the in-loop transform, K9, sums each block alone)."""
    from flutpu_torch.core import Buffer, Harness, MSECOND
    w, h, gop = 96, 64, 4
    frames = [make_test_frame("ball" if i < 6 else "noise", w, h, i)
              for i in range(14)]
    hh = Harness(f"cudahype codec={codec} gop-size={gop} chunks=3 "
                 f"device={cuda_device}")
    hh.set_src_caps(f"video/x-raw, format=RGB, width={w}, height={h}, "
                    "framerate=30/1")
    for i, f in enumerate(frames):
        hh.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
    hh.push_eos()
    outs = []
    while (o := hh.pull(timeout=60)) is not None:
        outs.append(o)
    hh.teardown()
    if codec == "jpeg":
        assert [o.pts for o in outs] == [i * MSECOND for i in range(14)]
        assert [bytes(o.data) for o in outs] == JpegEncoder(
            85, device=cuda_device).encode_gop(np.stack(frames))
        return
    assert [o.pts for o in outs] == [i * gop * MSECOND for i in range(4)]
    kw = dict(motion=codec.startswith("fvc-motion"),
              hier="hier" in codec, bframes=int("bframes" in codec),
              subpel="subpel" in codec)
    enc = FvcEncoder(85, device=cuda_device, **kw)
    for ci, o in enumerate(outs):
        clip = np.stack(frames[ci * gop:(ci + 1) * gop])
        assert bytes(o.data) == enc.encode_chunk(clip)


def _psnr8(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.cuda
def test_hype_bin_with_card_encoders(cuda_device):
    """``hype`` with two ``cudajpegenc`` branches sharing the card from
    their own streaming threads: every frame, in order, each equal to a
    plain encode."""
    from flutpu_torch.core import parse_launch
    from torch_helpers import pull_all
    bufs = pull_all(parse_launch, (
        "videotestsrc num-buffers=24 pattern=ball width=96 height=64 "
        f"! hype gop-size=3 encoder-0='cudajpegenc device={cuda_device}' "
        f"encoder-1='cudajpegenc device={cuda_device}' ! appsink name=out"))
    assert len(bufs) == 24
    assert [b.pts for b in bufs] == sorted(b.pts for b in bufs)
    frames = np.stack([make_test_frame("ball", 96, 64, i) for i in range(24)])
    assert [bytes(b.data) for b in bufs] == JpegEncoder(
        85, device=cuda_device).encode_gop(frames)


@pytest.mark.cuda
@pytest.mark.parametrize("motion,segmented", [(False, True), (True, True),
                                              (False, False), (True, False)])
def test_fvc_on_card_matches_cpu(cuda_device, motion, segmented):
    """The same chunk encoded on the card (either layout) and on the CPU;
    a mid-chunk cut exercises the device-side I/P decision."""
    frames = np.concatenate([
        np.stack([make_test_frame("ball", 160, 88, i) for i in range(4)]),
        np.stack([make_test_frame("noise", 160, 88, i) for i in range(4)])])
    got = FvcEncoder(motion=motion, segmented=segmented,
                     device=cuda_device).encode_chunk(frames)
    want = FvcEncoder(motion=motion, device="cpu").encode_chunk(frames)
    assert got == want
    a, info = FvcDecoder(cuda_device).decode_chunk(got)
    b, info_cpu = FvcDecoder("cpu").decode_chunk(got)
    assert info == info_cpu
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
def test_fvc_motion_bytes_alike_with_tf32(cuda_device, planar):
    """The in-loop DCT is codec state, and the loop runs no matmul (K9,
    and the planar products in full fp32): a motion chunk's bytes are the
    same with TF32 matmuls allowed and not."""
    frames = np.concatenate([
        np.stack([make_test_frame("ball", 160, 88, i) for i in range(4)]),
        np.stack([make_test_frame("noise", 160, 88, i) for i in range(4)])])
    enc = FvcEncoder(motion=True, device=cuda_device)
    enc.planar = planar
    want = enc.encode_chunk(frames)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        got = enc.encode_chunk(frames)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("hier,bframes", [(True, 1), (True, 0), (False, 1)])
def test_fvc_hier_b_on_card_matches_cpu(cuda_device, hier, bframes):
    """A 160x96 chunk with hier search and B frames, on the card and on the
    CPU."""
    frames = np.concatenate([
        np.stack([make_test_frame("ball", 160, 96, i) for i in range(5)]),
        np.stack([make_test_frame("noise", 160, 96, i) for i in range(3)])])
    kw = dict(motion=True, hier=hier, bframes=bframes)
    got = FvcEncoder(device=cuda_device, **kw).encode_chunk(frames)
    assert got == FvcEncoder(device="cpu", **kw).encode_chunk(frames)
    a, info = FvcDecoder(cuda_device).decode_chunk(got)
    b, info_cpu = FvcDecoder("cpu").decode_chunk(got)
    assert info == info_cpu and (2 in info["types"]) == bool(bframes)
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


# -- the decode side, half-pel and 4:4:4 ------------------------------------

def _clip8(w=160, h=96):
    """Four ball frames, then four noise frames (a mid-chunk cut)."""
    return np.concatenate([
        np.stack([make_test_frame("ball", w, h, i) for i in range(4)]),
        np.stack([make_test_frame("noise", w, h, i) for i in range(4)])])


def _same_or_tie(a: bytes, b: bytes, frames, dev):
    """Two encodes of one chunk: byte-identical, or (a float tie split
    them) the same frame types and each frame's PSNR within 0.05 dB."""
    if a == b:
        return True
    dec = FvcDecoder(dev)
    (x, ix), (y, iy) = dec.decode_chunk(a), dec.decode_chunk(b)
    assert ix["types"] == iy["types"]
    assert max(abs(_psnr8(u, s) - _psnr8(v, s))
               for u, v, s in zip(x, y, frames)) <= 0.05
    return False


def _with_coded_size(chunk: bytes, h: int) -> bytes:
    """The chunk's header rewritten to frame height ``h`` with the
    coded-size extension (header flags bit 4) after the search range."""
    import struct
    ver, flags, w, ph = struct.unpack(">BBHH", chunk[4:10])
    off = 13 if ver >= 2 else 12
    return (chunk[:4] + struct.pack(">BBHH", ver, flags | 16, w, h)
            + chunk[10:off] + struct.pack(">HH", w, ph) + chunk[off:])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["v1", "v1-444", "P", "hier-B", "half-pel",
                                  "coded-size"])
def test_fvc_decoders_on_card_match_cpu(cuda_device, kind):
    """``FvcDecoder`` and ``cudafvcdec`` on the card against the CPU on
    every chunk kind (encoded on the CPU): the same frame types, the same
    RGB bit for bit (the IDCT runs K9, in the CPU's summation order)."""
    from flutpu_torch.core import Buffer, Harness
    kw = {"v1": {}, "v1-444": {"subsample": False}, "P": {"motion": True},
          "hier-B": {"motion": True, "hier": True, "bframes": 1},
          "half-pel": {"motion": True, "subpel": True},
          "coded-size": {"motion": True}}[kind]
    data = FvcEncoder(device="cpu", **kw).encode_chunk(_clip8())
    if kind == "coded-size":
        data = _with_coded_size(data, 80)
    a, ia = FvcDecoder(cuda_device).decode_chunk(data)
    b, ib = FvcDecoder("cpu").decode_chunk(data)
    assert ia == ib
    np.testing.assert_array_equal(a, b)
    h = Harness(f"cudafvcdec device={cuda_device}")
    h.set_src_caps("video/x-fvc")
    h.push(Buffer(data, pts=0, duration=8))
    h.push_eos()
    got = [np.asarray(h.pull(timeout=60).data) for _ in range(8)]
    h.teardown()
    np.testing.assert_array_equal(np.stack(got), a)


@pytest.mark.cuda
@pytest.mark.parametrize("subsample", [True, False])
def test_cudajpegdec_on_card_matches_cpu(cuda_device, subsample):
    """``cudajpegdec`` on the card against ``device=cpu`` on the same JFIF
    bytes, 4:2:0 and 4:4:4: RGB within one level."""
    from flutpu_torch.core import make
    frames = _clip8(72, 40)
    payloads = JpegEncoder(85, subsample=subsample,
                           device="cpu").encode_gop(frames)
    card = make("cudajpegdec", device=str(cuda_device))
    cpu = make("cudajpegdec", device="cpu")
    for p in payloads:
        a, b = card.decode(p), cpu.decode(p)
        assert a.shape == b.shape == (40, 72, 3)
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("hier", [False, True])
def test_subpel_chunk_on_card_matches_cpu(cuda_device, hier):
    """A half-pel chunk on the card and on the CPU, at the ties contract:
    the search kernel (K3, or K5 with hier) runs, the chroma kernel K4
    does not (its contract is integer vectors)."""
    frames = _clip8()
    before = (M.motion_search_mc.launches, M.motion_search_mc_hier.launches,
              M.chroma_mc.launches)
    got = FvcEncoder(motion=True, subpel=True, hier=hier,
                     device=cuda_device).encode_chunk(frames)
    after = (M.motion_search_mc.launches, M.motion_search_mc_hier.launches,
             M.chroma_mc.launches)
    assert after[1 if hier else 0] > before[1 if hier else 0]
    assert after[2] == before[2]
    assert got[5] & 4
    want = FvcEncoder(motion=True, subpel=True, hier=hier,
                      device="cpu").encode_chunk(frames)
    _same_or_tie(got, want, frames, cuda_device)


@pytest.mark.cuda
def test_444_jpeg_gop_on_card(cuda_device):
    """A 4:4:4 GOP on the card: the pack kernel (K2) runs, the 4:2:0
    front-end kernel (K1) does not; the plain front end's coefficients on
    the card meet the CPU's under K1's tie contract; the frames decode at
    more than 30 dB."""
    from flutpu_torch.codec.ops.frontend import front_end_444
    frames = np.stack([make_test_frame("ball", 160, 96, i) for i in range(4)])
    enc = JpegEncoder(85, subsample=False, device=cuda_device)
    before = (F.front_end.launches, K.pack_segments.launches)
    payloads = enc.encode_gop(frames)
    assert F.front_end.launches == before[0]
    assert K.pack_segments.launches > before[1]
    planes = [torch.from_numpy(np.ascontiguousarray(frames[..., c]))
              for c in range(3)]
    q = [torch.from_numpy(QY), torch.from_numpy(QC)]
    got = front_end_444(*(p.to(cuda_device) for p in planes),
                        *(t.to(cuda_device) for t in q))
    for a, b in zip(got, front_end_444(*planes, *q)):
        tie_contract(a.cpu().numpy(), b.numpy(), 1e-4)
    from flutpu_torch.core import make
    dec = make("cudajpegdec", device=str(cuda_device))
    assert min(_psnr8(dec.decode(p), f)
               for p, f in zip(payloads, frames)) > 30


@pytest.mark.cuda
def test_decode_stream_on_card(cuda_device):
    """Concatenated chunks (v1, P, hier+B, half-pel, 4:4:4) through
    ``decode_stream`` on the card: equal to per-chunk ``decode_chunk`` on
    the card, in order, and within one level of the CPU's."""
    frames = _clip8()
    kws = [{}, {"motion": True}, {"motion": True, "hier": True,
                                  "bframes": 1},
           {"motion": True, "subpel": True}, {"subsample": False}]
    chunks = [FvcEncoder(device="cpu", **kw).encode_chunk(frames)
              for kw in kws]
    dec = FvcDecoder(cuda_device)
    got = dec.decode_stream(b"".join(chunks))
    want = np.concatenate([dec.decode_chunk(c)[0] for c in chunks])
    np.testing.assert_array_equal(got, want)
    cpu = FvcDecoder("cpu").decode_stream(b"".join(chunks), parallel=False)
    assert np.abs(got.astype(np.int32) - cpu.astype(np.int32)).max() <= 1


# -- subtitle burn-in -------------------------------------------------------------

def _bgra(h, w, seed=2):
    rng = np.random.default_rng(seed)
    ov = rng.integers(0, 256, (h, w, 4), np.uint8)
    q = max(1, h // 5)
    ov[:q, :, 3], ov[q:2 * q, :, 3], ov[2 * q:3 * q, :, 3] = 255, 128, 0
    return ov


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ov_shape", [((2, 1088, 1920), (1080, 1920)),
                                            ((1, 48, 80), (48, 80)),
                                            ((2, 64, 96), (50, 70)),
                                            ((1, 1088, 1920), (37, 1001)),
                                            ((2, 32, 1936), (32, 1936)),
                                            ((1, 16, 16), (16, 16)),
                                            ((1, 2160, 3840), (2160, 3840))])
def test_front_end_overlay_kernel(cuda_device, shape, ov_shape):
    """K1 with an overlay: equal to K1 on planes blended beforehand bit for
    bit, to its plain version under K1's contract, and with alpha 0 to K1
    without an overlay; a smaller overlay leaves the rest as it was."""
    from flutpu_torch.ttml.render.composite import overlay_on_planes
    planes = [torch.from_numpy(p).to(cuda_device)
              for p in rand_planes(*shape, seed=7)]
    qy = torch.from_numpy(QY).to(cuda_device)
    qc = torch.from_numpy(QC).to(cuda_device)
    ov = torch.from_numpy(_bgra(*ov_shape)).to(cuda_device)
    before = F.front_end.launches
    got = F.front_end(*planes, qy, qc, overlay=ov)
    assert F.front_end.launches == before + 1
    full = ov.new_zeros((shape[1], shape[2], 4))
    full[:ov_shape[0], :ov_shape[1]] = ov
    staged = F.front_end(*overlay_on_planes(*planes, full), qy, qc)
    for a, c in zip(got, staged):
        assert torch.equal(a, c)
    for a, c in zip(got, F.front_end_plain(*planes, qy, qc, overlay=ov)):
        tie_contract(a.cpu().numpy(), c.cpu().numpy(), 1e-4)
    none = F.front_end(*planes, qy, qc)
    assert any(not torch.equal(a, c) for a, c in zip(got, none))
    for a, c in zip(F.front_end(*planes, qy, qc,
                                overlay=torch.zeros_like(ov)), none):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_front_end_overlay_raises_on_what_the_kernel_does_not_take(
        cuda_device):
    planes = [torch.from_numpy(p).to(cuda_device)
              for p in rand_planes(1, 32, 64, seed=8)]
    qy = torch.from_numpy(QY).to(cuda_device)
    qc = torch.from_numpy(QC).to(cuda_device)
    for bad in (torch.zeros((33, 64, 4), dtype=torch.uint8,
                            device=cuda_device),
                torch.zeros((32, 64, 4), dtype=torch.uint8),       # on the CPU
                torch.zeros((32, 64, 3), dtype=torch.uint8,
                            device=cuda_device)):
        before = F.front_end.launches
        with pytest.raises(ValueError):
            F.front_end(*planes, qy, qc, overlay=bad)
        assert F.front_end.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [True, False])
def test_encoder_with_overlay_on_card_matches_cpu(cuda_device, segmented):
    frames = np.stack([make_test_frame("gradient", 96, 64, i)
                       for i in range(3)])
    ov = _bgra(64, 96)

    def encode(device):
        enc = JpegEncoder(85, segmented=segmented, device=device)
        return enc.encode_gop_finalize(enc.encode_gop_dispatch(
            torch.from_numpy(frames).to(device), 64, 96, overlay=ov))

    assert encode(cuda_device) == encode("cpu")


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    """The compositor, the stroke filter and both atlases: the same
    windows on the card as on the CPU, pixel for pixel."""
    from flutpu_torch.core import Buffer, Harness
    from flutpu_torch.ttml.render import atlas as A
    from flutpu_torch.ttml.render import device as D
    doc = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="r" tts:origin="5% 70%" tts:extent="90% 25%"
            tts:backgroundColor="#00000080" tts:opacity="0.7"/>
  </layout></head>
  <body><div>
    <p begin="0s" end="1s" region="r" tts:color="white">first cue</p>
    <p begin="1s" end="2s" region="r" tts:color="yellow"
       tts:textOutline="black 2px 1px">second cue</p>
  </div></body>
</tt>"""

    def render(device, props=""):
        h = Harness(f"cudattmlrender window-width=320 window-height=192 "
                    f"device={device} {props}")
        h.set_src_caps("application/ttml+xml")
        h.push(Buffer(doc.encode(), pts=0))
        h.push_eos()
        out = []
        while (b := h.pull(timeout=30)) is not None:
            out.append(b.data)
        h.teardown()
        return out

    cpu = render("cpu")
    assert len(cpu) >= 2 and any((f[..., 3] > 0).any() for f in cpu)
    for props in ("", "crop-delivery=false", "batch-intervals=false"):
        for a, c in zip(render(cuda_device, props), cpu):
            np.testing.assert_array_equal(a, c)
    for t, c in zip(render(cuda_device, "device-out=true"), cpu):
        assert t.is_cuda
        np.testing.assert_array_equal(t.cpu().numpy(), c)
    rng = np.random.default_rng(9)
    tiles = rng.integers(0, 256, (3, A.TILE_H, A.TILE_W), np.uint8)
    a = A._stroke_tiles(torch.from_numpy(tiles).to(cuda_device), 2, 3)
    assert torch.equal(a.cpu(), A._stroke_tiles(torch.from_numpy(tiles), 2, 3))
    ints = np.array([[1, -30, 10, 400, 100, 0, 0, 200, 100],
                     [2, 50, -20, 512, 128, 10, 10, 190, 90]], np.int32)
    cols = np.array([[1, 0.5, 0.2, 0.5], [0.1, 0.9, 0.3, 0.77]], np.float32)
    wins = [D.composite_instances(
        A.atlas_from_numpy(list(tiles), device=d).device_array(), ints, cols,
        100, 200) for d in (cuda_device, "cpu")]
    assert wins[0].is_cuda and torch.equal(wins[0].cpu(), wins[1])


# -- search ranges 33-126: K3 and K6a in bands, K5 pooled from device memory

WIDE = {"K3": (lambda c, p, r: M.motion_search_mc(c, p, r),
               lambda c, p, r: M.motion_search_mc_plain(c, p, r),
               "motion_search_mc"),
        "K6a-16": (lambda c, p, r: M.motion_search_mc_blocks(c, p, r, 16),
                   lambda c, p, r: M.motion_search_mc_blocks_plain(
                       c, p, r, 16), "motion_search_mc_blocks"),
        "K6a-8": SEARCHES["K6a-8"], "K5": SEARCHES["K5"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE))
@pytest.mark.parametrize("h,w,r", [(96, 160, 33), (96, 176, 48),
                                   (96, 160, 64), (64, 96, 126),
                                   (160, 272, 126)])
def test_wide_search_kernels_match_plain(cuda_device, name, h, w, r):
    """Above r = 32 (K3 and K6a stage bands of candidate-row pairs, K5
    pools its window from device memory and refines from an 18-row window
    per macroblock): one launch, vectors and predictions bit-identical to
    the plain version on a rolled pair with one divergent macroblock, on
    integer-valued planes (ties abound), on a flat plane and on NaN in
    one macroblock of cur and one pixel of prev. At r = 126 the window
    wraps a 64x96 plane several times; 96x176 leaves a partial row of
    macroblocks."""
    kernel, plain, wrapper = WIDE[name]
    count = getattr(M, wrapper)
    rng = np.random.default_rng(h + w + r)
    cur, prev = _rolled_pair(h, w, h + r, (r // 3, -(r // 2)))
    cur[16:32, 32:48] = rng.uniform(0, 255, (16, 16))
    ints = rng.integers(0, 4, (h, w)).astype(np.float32)
    flat = np.full((h, w), 100.0, np.float32)
    part_c, part_p = cur.copy(), prev.copy()
    part_c[16:32, 16:32] = np.nan
    part_p[h // 2, w // 3] = np.nan
    for a, b in ((cur, prev), (np.roll(ints, (1, 40), (0, 1)), ints),
                 (flat, flat), (part_c, part_p)):
        c, p = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
        before = count.launches
        mv, pred = kernel(c, p, r)
        torch.cuda.synchronize()
        assert count.launches == before + 1
        mv_p, pred_p = plain(c, p, r)
        assert torch.equal(mv, mv_p), name
        assert _same_bits(pred, pred_p), name
        assert int(mv.abs().max()) <= r


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SEARCHES) + ["K6a-16"])
@pytest.mark.parametrize("h,w", [(96, 160), (64, 272)])
def test_wide_batched_search_kernels(cuda_device, name, h, w):
    """The chunk axis at r = 64: three unlike chunks in one launch, each
    equal to the plain version and to its own launch; 272 columns take
    several thread blocks of each kernel and a partial one."""
    kernel, plain, wrapper = {**SEARCHES, **WIDE}[name]
    cur, prev = (torch.from_numpy(a).to(cuda_device)
                 for a in chunk_pairs(3, h, w, seed=64))
    mv, pred = kernel(cur, prev, 64)
    mv_p, pred_p = plain(cur, prev, 64)
    assert torch.equal(mv, mv_p) and _same_bits(pred, pred_p)
    for k in range(3):
        one_mv, one_pred = kernel(cur[k], prev[k], 64)
        assert torch.equal(mv[k], one_mv) and _same_bits(pred[k], one_pred)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE))
@pytest.mark.parametrize("shift", [(8, 8), (0, 8), (8, 0)])
@pytest.mark.parametrize("r", [33, 64, 126])
def test_wide_search_exact_ties_keep_the_first(cuda_device, name, shift, r):
    """A plane periodic in 16 rows and columns, cur the plane rolled by
    ``shift``: every candidate congruent to the shift mod 16 has SAD 0,
    so two or four of them tie exactly at the least cost (|dy| + |dx| =
    8 or 16), in different items, warps and bands; the first in dy-major
    order must win, as in the plain version (K5: through its coarse
    stage's ties)."""
    kernel, plain, _ = WIDE[name]
    rng = np.random.default_rng(16)
    prev = np.tile(rng.uniform(0, 255, (16, 16)).astype(np.float32), (6, 10))
    cur = np.roll(prev, shift, axis=(0, 1))
    c, p = (torch.from_numpy(x).to(cuda_device) for x in (cur, prev))
    mv, pred = kernel(c, p, r)
    mv_p, pred_p = plain(c, p, r)
    assert torch.equal(mv, mv_p) and _same_bits(pred, pred_p)
    if name != "K5":
        want = [-s for s in shift]
        assert (mv.reshape(-1, 2).cpu() == torch.tensor(want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE))
@pytest.mark.parametrize("r", [33, 64, 65, 96, 126])
def test_wide_search_band_splits(cuda_device, name, r):
    """Every band split of the pairs of candidate rows (one band at r =
    33, three at 64 and 65, several above): vectors and predictions
    bit-identical to the plain version on a rolled pair with a divergent
    macroblock and on an integer-valued pair (ties abound)."""
    kernel, plain, _ = WIDE[name]
    rng = np.random.default_rng(r)
    cur, prev = _rolled_pair(64, 96, r, (r // 4, -(r // 3)))
    cur[16:32, 48:64] = rng.uniform(0, 255, (16, 16))
    ints = rng.integers(0, 4, (64, 96)).astype(np.float32)
    for a, b in ((cur, prev), (np.roll(ints, (2, 33), (0, 1)), ints)):
        c, p = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
        mv, pred = kernel(c, p, r)
        mv_p, pred_p = plain(c, p, r)
        assert torch.equal(mv, mv_p) and _same_bits(pred, pred_p), (a is cur)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE))
@pytest.mark.parametrize("w", [48, 112])
def test_wide_search_rows_narrower_than_a_block(cuda_device, name, w):
    """A row of 3 or 7 macroblocks: fewer than one thread block of K3 (4)
    at 112 columns partly, of K5 (8) wholly; the pooled and full windows
    wrap the narrow plane several times."""
    kernel, plain, _ = WIDE[name]
    cur, prev = _rolled_pair(48, w, w, (5, -9))
    for r in (33, 64):
        c, p = (torch.from_numpy(x).to(cuda_device) for x in (cur, prev))
        mv, pred = kernel(c, p, r)
        mv_p, pred_p = plain(c, p, r)
        assert torch.equal(mv, mv_p) and _same_bits(pred, pred_p), r


@pytest.mark.cuda
@pytest.mark.parametrize("r", [40, 64, 126])
def test_wide_hier_search_is_one_launch(cuda_device, r):
    """K5 above r = 32: one call is one device kernel, the wide one
    (torch.profiler; a window that traced nothing is taken again, as the
    profiler has been seen to miss a window's activity)."""
    from torch.profiler import ProfilerActivity, profile
    c, p = (torch.from_numpy(x).to(cuda_device)
            for x in _rolled_pair(96, 160, r, (5, -9)))
    M.motion_search_mc_hier(c, p, r)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            M.motion_search_mc_hier(c, p, r)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert len(names) == 1 and "motion_search_hier_wide" in names[0], names


@pytest.mark.cuda
def test_wide_ranges_launch_and_refuse(cuda_device):
    """Every range to 126 launches at both block sizes (the shapes of
    each band class); 127 is refused by the wrapper."""
    c, p = (torch.from_numpy(a).to(cuda_device)
            for a in _rolled_pair(32, 48, 5))
    for r in (33, 34, 35, 36, 95, 125, 126):
        for mb in (8, 16):
            for a, b in zip(M.motion_search_mc_blocks(c, p, r, mb),
                            M.motion_search_mc_blocks_plain(c, p, r, mb)):
                assert torch.equal(a, b), (r, mb)
        for a, b in zip(M.motion_search_mc_hier(c, p, r),
                        M.motion_search_mc_hier_plain(c, p, r)):
            assert _same_bits(a, b) if a.is_floating_point() \
                else torch.equal(a, b)
    with pytest.raises(ValueError):
        M.motion_search_mc(c, p, 127)


@pytest.mark.cuda
@pytest.mark.parametrize("hc,wc", [(544, 960), (24, 40)])
def test_chroma_kernel_takes_vectors_to_126(cuda_device, hc, wc):
    """K4 on luma vectors up to ±126 (chroma ±63, past a 24x40 plane's
    size), odd negative ones floor-halved: bit-identical to the plain
    version."""
    rng = np.random.default_rng(hc)
    cb, cr = (torch.from_numpy(rng.normal(128, 30, (hc, wc))
                               .astype(np.float32)).to(cuda_device)
              for _ in range(2))
    mv = rng.integers(-126, 127, (hc // 8, wc // 8, 2)).astype(np.int32)
    mv[0, 0] = (-125, 126)
    mv = torch.from_numpy(mv).to(cuda_device)
    for a, b in zip(M.chroma_mc(cb, cr, mv, 126),
                    M.chroma_mc_plain(cb, cr, mv, 126)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hier", [False, True])
def test_wide_range_chunk_on_card_matches_cpu(cuda_device, hier):
    """An FVC chunk at search range 64 of a pan of 40 columns per frame:
    the card's bytes equal the CPU's, and the vectors pass ±32."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (96, 160, 3)).astype(np.float32)
    pad = np.pad(base, ((1, 1), (1, 1), (0, 0)), mode="wrap")
    base = (sum(pad[i:i + 96, j:j + 160] for i in range(3)
                for j in range(3)) / 9.0).astype(np.uint8)
    frames = np.stack([np.roll(base, (2 * i, 40 * i), (0, 1))
                       for i in range(6)])
    card = FvcEncoder(85, motion=True, search_range=64, hier=hier,
                      device=cuda_device).encode_chunk(frames)
    cpu = FvcEncoder(85, motion=True, search_range=64, hier=hier,
                     device="cpu").encode_chunk(frames)
    assert card == cpu
    _, records = FvcDecoder.parse_chunk(card)
    assert max(np.abs(v).max() for _, v, _ in records if v is not None) > 32


@pytest.mark.cuda
def test_ladder_on_card(cuda_device):
    """cudafvcladderenc on the card: each rung's chunk equals a card
    FvcEncoder's on the card's scaled frames, which lie within one level
    of the CPU's."""
    from flutpu_torch.codec import ladder as L
    frames = np.stack([make_test_frame("ball", 128, 96, i) for i in range(4)])
    rungs = L.parse_rungs("128x96@85,64x48@75")
    enc = {}
    chunks = L.encode_ladder_chunk(frames, rungs, motion=True, encoders=enc,
                                   device=cuda_device)
    for rung, chunk in zip(rungs, chunks):
        scaled = L.scale_rung(torch.from_numpy(frames).to(cuda_device), rung)
        cpu = L.scale_rung(torch.from_numpy(frames), rung)
        assert (scaled.cpu().int() - cpu.int()).abs().max() <= 1
        assert chunk == FvcEncoder(rung.quality, motion=True,
                                   device=cuda_device).encode_chunk(scaled)


# -- row stripes and several shards (ROADMAP item 5) --------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("r,hs,n", [(3, 16, 3), (7, 32, 2), (16, 16, 4),
                                    (17, 32, 2), (7, 1088, 2)])
def test_striped_route_kernels_match_plain(cuda_device, r, hs, n):
    """K3 and K4 on stripes padded by whole macroblock rows of their ring
    neighbours: vectors, luma and chroma predictions bit-identical to the
    route on the plain versions (the kernels sum in their order), one K3
    and one K4 launch per stripe, two chunks per launch."""
    from flutpu_torch.codec.ops.motion_kernels import (
        chroma_mc_plain, chroma_mc_striped, motion_search_mc_plain,
        motion_search_mc_striped)
    rng = np.random.default_rng(r * hs)
    w = 96

    def stripes(rows, cols):
        a = rng.uniform(0, 255, (2, n * rows, cols)).astype(np.float32)
        return [torch.from_numpy(np.ascontiguousarray(p)).to(cuda_device)
                for p in np.split(a, n, axis=1)]

    cur, prev = stripes(hs, w), stripes(hs, w)
    cb, cr = stripes(hs // 2, w // 2), stripes(hs // 2, w // 2)
    k3, k4 = M.motion_search_mc.launches, M.chroma_mc.launches
    mvs, preds = motion_search_mc_striped(cur, prev, r)
    pcb, pcr = chroma_mc_striped(cb, cr, mvs, r)
    torch.cuda.synchronize()
    assert M.motion_search_mc.launches == k3 + n
    assert M.chroma_mc.launches == k4 + n
    mvs_p, preds_p = motion_search_mc_striped(cur, prev, r,
                                              motion_search_mc_plain)
    pcb_p, pcr_p = chroma_mc_striped(cb, cr, mvs_p, r, chroma_mc_plain)
    for got, want in ((mvs, mvs_p), (preds, preds_p), (pcb, pcb_p),
                      (pcr, pcr_p)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _stripe_clip(c, f, h, w):
    """C chunks of F frames: a pan by (4, 6) pixels per frame on a smooth
    seeded texture, so stripe-edge rows predict from the halo."""
    rng = np.random.default_rng(c * f + h)
    base = rng.integers(0, 256, (h + 8 * f * c, w + 12 * f * c, 3))
    base = ((base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3) \
        .astype(np.uint8)
    return np.stack([np.stack([base[4 * (k * f + i):4 * (k * f + i) + h,
                                    6 * (k * f + i):6 * (k * f + i) + w]
                               for i in range(f)]) for k in range(c)])


@pytest.mark.cuda
def test_two_shards_on_one_card_match_one(cuda_device):
    """A 2-shard mesh of cuda:0: each shard's block of chunks is its own
    dispatch, equal to that block alone; K1's outputs (JPEG, v1) equal
    one shard over all chunks, and so do the striped ones on a (2, 2)
    mesh of cuda:0."""
    from flutpu_torch.parallel.gop import encode_chunks, fvc_chunks
    from flutpu_torch.parallel.mesh import ChunkSpatialMesh, make_chunk_mesh
    frames = torch.from_numpy(_stripe_clip(4, 3, 96, 160)).to(cuda_device)
    qy, qc = (torch.from_numpy(t).to(cuda_device) for t in (QY, QC))
    two = make_chunk_mesh(2, [cuda_device] * 2)
    grid = ChunkSpatialMesh(2, 2, [cuda_device] * 4)
    for mesh, spatial in ((two, False), (grid, True)):
        for a, b in zip(encode_chunks(frames, qy, qc, mesh=mesh,
                                      spatial=spatial),
                        encode_chunks(frames, qy, qc)):
            assert torch.equal(a, b)
        for a, b in zip(fvc_chunks(frames, qy, qc, mesh=mesh,
                                   spatial=spatial),
                        fvc_chunks(frames, qy, qc)):
            assert torch.equal(a, b)
        for kw in (dict(motion=True), dict(motion=True, bframes=1)):
            got = fvc_chunks(frames, qy, qc, mesh=mesh, spatial=spatial,
                             **kw)
            for k, sl in enumerate((slice(0, 2), slice(2, 4))):
                block = fvc_chunks(frames[sl], qy, qc, mesh=ChunkSpatialMesh(
                    1, 2, [cuda_device] * 2) if spatial else None,
                    spatial=spatial, **kw)
                for a, b in zip(got, block):
                    assert torch.equal(a[sl], b)


@pytest.mark.cuda
@pytest.mark.parametrize("h,spatial", [(80, 2), (1080, 3)])
def test_striped_jpeg_on_card_equals_unstriped(cuda_device, h, spatial):
    """``cudahype spatial>1`` on the card: K1 per stripe, the planes
    cropped back to the standard MCU rows, JFIF byte-identical to
    ``spatial=1``."""
    import flutpu_torch.core as core
    frames = [make_test_frame("gradient", 192, h, i) for i in range(4)]

    def run(sp):
        hn = core.Harness(f"cudahype gop-size=2 chunks=2 spatial={sp}")
        hn.set_src_caps(f"video/x-raw, format=RGB, width=192, height={h}, "
                        "framerate=30/1")
        for i, f in enumerate(frames):
            hn.push(core.Buffer(f, pts=i, duration=1, offset=i))
        hn.push_eos()
        out = []
        while (o := hn.pull(timeout=60)) is not None:
            out.append(bytes(o.data))
        hn.teardown()
        return out

    assert run(spatial) == run(1)


@pytest.mark.cuda
def test_compositor_batch_vmap_on_card(cuda_device):
    """Item 8 on the card: every interval's instance i in one step, pixel
    for pixel ``composite_instances_batch``."""
    from flutpu_torch.ttml.render import device as D
    from flutpu_torch.ttml.render.atlas import TILE_H, TILE_W
    rng = np.random.default_rng(7)
    atlas = torch.from_numpy(rng.integers(0, 255, (8, TILE_H, TILE_W))
                             .astype(np.uint8)).to(cuda_device)
    k, n, w, h = 4, 12, 320, 192
    ints = np.zeros((k, n, 9), np.int32)
    cols = np.zeros((k, n, 4), np.float32)
    for kk in range(k):
        for i in range(n):
            x, y = int(rng.integers(-16, w - 10)), int(rng.integers(-16, h - 10))
            iw, ih = int(rng.integers(4, TILE_W)), int(rng.integers(4, TILE_H))
            ints[kk, i] = (int(rng.integers(0, 8)), x, y, iw, ih, x, y,
                           x + iw, y + ih)
            cols[kk, i] = (*rng.random(3), float(rng.random()))
    got = D.composite_instances_batch_vmap(atlas, ints, cols, h, w)
    assert got.is_cuda
    assert torch.equal(got, D.composite_instances_batch(atlas, ints, cols, h,
                                                        w))


# -- the command-line tools -------------------------------------------------

_ROOT = __file__.rsplit("/", 2)[0]


def _child(args, timeout):
    import os
    import subprocess
    import sys
    return subprocess.run([sys.executable, *args], cwd=_ROOT,
                          env=dict(os.environ, PYTHONPATH=_ROOT),
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.cuda
def test_launch_writes_the_elements_jfif_at_1080p(cuda_device, tmp_path):
    """``flutpu_torch.launch.main`` on a 1080p ``cudajpegenc`` line writes
    the JFIF the same launch string gives through ``appsink``, launching
    K1 and K2."""
    from flutpu_torch.core import parse_launch
    from flutpu_torch.launch import main
    out = tmp_path / "a.mjpeg"
    line = ("videotestsrc num-buffers=16 pattern=ball width=1920 "
            "height=1080 ! cudajpegenc batch-frames=16")
    k1, k2 = F.front_end.launches, K.pack_segments.launches
    assert main([f"{line} ! filesink location={out}"]) == 0
    assert F.front_end.launches > k1 and K.pack_segments.launches > k2
    p = parse_launch(f"{line} ! appsink name=out")
    sink = p.get_by_name("out")
    p.play()
    want = []
    while (b := sink.try_pull_buffer(timeout=60)) is not None:
        want.append(bytes(b.data))
    p.stop()
    assert len(want) == 16 and out.read_bytes() == b"".join(want)


@pytest.mark.cuda
def test_inspect_initialises_no_cuda_context(cuda_device):
    """The element reference constructs all 28 elements in a fresh process
    without initialising CUDA, and equals docs/ELEMENTS_TORCH.md."""
    import json
    res = _child(["-c", "import json, torch\n"
                  "from flutpu_torch.core import factories\n"
                  "from flutpu_torch.inspect import _markdown\n"
                  "md = _markdown(factories())\n"
                  "print(json.dumps([md, len(factories()), "
                  "torch.cuda.is_initialized()]))"], timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    md, n, initialised = json.loads(res.stdout)
    assert (n, initialised) == (28, False)
    with open(f"{_ROOT}/docs/ELEMENTS_TORCH.md") as fh:
        assert md == fh.read()


@pytest.mark.cuda
def test_launch_on_a_missing_card_exits_1(cuda_device):
    """``cudajpegenc device=cuda:N`` past the last card: the encoder fails,
    launch prints the error and exits 1; nothing runs on the CPU."""
    n = torch.cuda.device_count()
    res = _child(["-m", "flutpu_torch.launch", "videotestsrc num-buffers=8 "
                  f"! cudajpegenc device=cuda:{n} ! fakesink"], timeout=60)
    assert res.returncode == 1
    assert "ERROR from" in res.stderr and "Pipeline is PLAYING" in res.stderr


# -- the host entropy engine, encode_gop_scans and the planar DCT ------------

@pytest.mark.cuda
@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
def test_jpeg_host_engine_on_card(cuda_device, subsample):
    """``engine="host"`` on the card: K1 (4:2:0; 4:4:4 the plain front
    end), one copy of the coefficient planes and the native scan coder;
    the device engine's JFIF, and no pack kernel launched."""
    frames = _clip8()
    packs = (K.pack_segments, K.pack_block_bits_fused, K.pack_block_bits64)
    before = [F.front_end.launches] + [k.launches for k in packs]
    got = JpegEncoder(85, subsample=subsample, engine="host",
                      device=cuda_device).encode_gop(frames)
    after = [F.front_end.launches] + [k.launches for k in packs]
    assert after[1:] == before[1:]
    assert (after[0] > before[0]) == subsample
    assert got == JpegEncoder(85, subsample=subsample,
                              device=cuda_device).encode_gop(frames)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"motion": True},
                                {"motion": True, "hier": True, "bframes": 1},
                                {"motion": True, "subpel": True}],
                         ids=["v1", "P", "hier+B", "half-pel"])
def test_fvc_host_engine_on_card(cuda_device, kw):
    """The host engine's chunk on the card equals the device engine's; no
    pack kernel runs."""
    frames = _clip8()
    before = K.pack_segments.launches
    got = FvcEncoder(engine="host", device=cuda_device,
                     **kw).encode_chunk(frames)
    assert K.pack_segments.launches == before
    assert got == FvcEncoder(device=cuda_device, **kw).encode_chunk(frames)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["K7", "K8a"])
def test_encode_gop_scans_on_card_matches_plain(cuda_device, fused):
    """``encode_gop_scans`` on K1's coefficients of the clip launches K7
    (fused) or K8a once and equals its plain version, words and bits,
    with a window the noise frames overflow."""
    from flutpu_torch.codec.jpeg import encode_gop_to_coefs
    from flutpu_torch.codec.ops.entropy import encode_gop_scans, mcu_layout
    coefs = encode_gop_to_coefs(torch.from_numpy(_clip8()).to(cuda_device),
                                QY, QC, 96, 160)
    layout = mcu_layout(20, 12, 10, 6, True)
    kernel = K.pack_block_bits_fused if fused else K.pack_block_bits64
    before = kernel.launches
    packed, bits = encode_gop_scans(*coefs, layout, 256, fused=fused)
    assert kernel.launches == before + 1
    p_cpu, b_cpu = encode_gop_scans(*(c.cpu() for c in coefs), layout, 256,
                                    fused=fused)
    assert torch.equal(packed.cpu(), p_cpu) and torch.equal(bits.cpu(), b_cpu)
    assert int(bits.max()) > 256 * 32


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"bframes": 1}, {"subpel": True}],
                         ids=["P", "B", "half-pel"])
def test_planar_chunk_on_card(cuda_device, kw):
    """``planar = True`` on the card: header flags bit 3, and the card's
    and the CPU's decoders read the chunk within one level."""
    enc = FvcEncoder(motion=True, device=cuda_device, **kw)
    enc.planar = True
    chunk = enc.encode_chunk(_clip8())
    assert chunk[5] & 8
    a, info = FvcDecoder(cuda_device).decode_chunk(chunk)
    b, info_cpu = FvcDecoder("cpu").decode_chunk(chunk)
    assert info == info_cpu
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


@pytest.mark.cuda
def test_planar_decoder_has_no_drift_on_card(cuda_device):
    """The card's decoder rebuilds the encoder's in-loop planes exactly
    through the planar inverse, frame by frame."""
    frames = torch.from_numpy(_clip8()).to(cuda_device)
    qy, qc = (torch.from_numpy(t).to(cuda_device) for t in (QY, QC))
    assert planar_drift(frames, qy, qc) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("stripes", [2, 3])
def test_planar_stripes_decode_without_drift_on_card(cuda_device, stripes):
    """A planar chunk coded on row stripes of the card (stripe-height
    products in cuBLAS) is rebuilt exactly by the decoder's full-height
    products, every frame."""
    frames = torch.from_numpy(_clip8()).to(cuda_device)
    qy, qc = (torch.from_numpy(t).to(cuda_device) for t in (QY, QC))
    assert planar_drift(frames, qy, qc, stripes) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["plane_dct_planar", "plane_idct_planar"])
def test_planar_products_on_card_equal_the_cpus(cuda_device, op):
    """The planar products give the CPU's bits on the card, with TF32
    matmuls allowed or not: each sample is its own eight fp32 multiplies
    and adds in a fixed order."""
    from flutpu_torch.codec.ops import dct
    fn = getattr(dct, op)
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -300, 300, (3, 1088, 1920)).astype(np.float32))
    want = fn(x)
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            assert torch.equal(fn(x.to(cuda_device)).cpu(), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# -- the in-loop transform kernels (K9) ---------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1088, 1920), (3, 1088, 1920),
                                   (5, 56, 264)],
                         ids=["1080p", "C=3", "odd-blocks"])
def test_transform_kernels_match_plain_on_cpu(cuda_device, shape):
    """K9's DCT and IDCT on the card against their plain versions on the
    CPU, bit for bit (-0 among the inputs); one launch each, whatever the
    leading axes. (5, 56, 264): 7 x 33 blocks per plane, so a thread
    block's last 31 blocks are past the row's end."""
    from flutpu_torch.codec.ops import transform_kernels as T
    rng = np.random.default_rng(len(shape) * shape[-1])
    x = rng.uniform(-255, 255, shape).astype(np.float32)
    x[rng.random(shape) < 0.02] = -0.0
    x = torch.from_numpy(x)
    before = (T.block_dct.launches, T.block_idct.launches)
    coefs = T.block_dct(x.to(cuda_device))
    back = T.block_idct(coefs)
    torch.cuda.synchronize()
    assert (T.block_dct.launches, T.block_idct.launches) == (
        before[0] + 1, before[1] + 1)
    want = T.block_dct_plain(x)
    assert torch.equal(coefs.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(back.cpu().view(torch.int32),
                       T.block_idct_plain(want).view(torch.int32))


@pytest.mark.cuda
def test_transform_kernels_refuse_odd_sizes(cuda_device):
    from flutpu_torch.codec.ops import transform_kernels as T
    with pytest.raises(ValueError, match="multiples of 8"):
        T.block_dct(torch.zeros((12, 16), device=cuda_device))
    with pytest.raises(ValueError, match="8, 8"):
        T.block_idct(torch.zeros((2, 2, 4, 4), device=cuda_device))


def _k9_chunks(enc, frames, c: int, mesh=None):
    """(N, F, H, W, 3) frames as dispatches of ``c`` chunks each (or one
    dispatch on ``mesh``) → the N chunks in order."""
    if mesh is not None:
        return enc.encode_chunks_finalize(enc.encode_chunks_dispatch(frames,
                                                                     mesh))
    return [chunk for k in range(0, len(frames), c)
            for chunk in enc.encode_chunks_finalize(
                enc.encode_chunks_dispatch(frames[k:k + c]))]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"hier": True, "bframes": 1},
                                {"subpel": True}, {"bframes": 1}],
                         ids=["P", "hier+B", "half-pel", "B"])
def test_fvc_chunks_independent_of_batch_and_stripes_on_card(cuda_device,
                                                             kw):
    """8 chunks encoded on the card at C = 1, 2 and 8, and (full search:
    hier and half-pel take no stripes) on 2 row stripes of the card:
    byte-identical. Before K9 the batched cuBLAS transform split them."""
    from flutpu_torch.parallel.mesh import ChunkSpatialMesh
    frames = _stripe_clip(8, 4, 96, 160)
    enc = FvcEncoder(85, motion=True, device=cuda_device, **kw)
    one = _k9_chunks(enc, frames, 1)
    assert _k9_chunks(enc, frames, 2) == one
    assert _k9_chunks(enc, frames, 8) == one
    if not (kw.get("hier") or kw.get("subpel")):
        striped = _k9_chunks(enc, frames, 8, ChunkSpatialMesh(
            1, 2, [cuda_device] * 2))
        assert striped == one


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"bframes": 1}], ids=["P", "B"])
def test_fvc_decoder_on_card_rebuilds_the_encoders_references(cuda_device,
                                                              kw):
    """The card's decoder rebuilds the card encoder's in-loop planes bit
    for bit (per-block transform, every frame and plane), and its frames
    equal the CPU decoder's bit for bit."""
    frames = _clip8()
    qy, qc = (torch.from_numpy(t).to(cuda_device) for t in (QY, QC))
    if not kw:
        assert planar_drift(torch.from_numpy(frames).to(cuda_device), qy, qc,
                            planar=False) == 0
    chunk = FvcEncoder(85, motion=True, device=cuda_device,
                       **kw).encode_chunk(frames)
    a, ia = FvcDecoder(cuda_device).decode_chunk(chunk)
    b, ib = FvcDecoder("cpu").decode_chunk(chunk)
    assert ia == ib
    np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("span,state", [
    ("flu.fvc.codec", {}), ("flu.jpeg.redispatch", {"prefix_window": 16})])
def test_program_spans_and_kernels_share_one_clock(cuda_device, span, state):
    """Each kernel whose launch (the runtime's call, matched to the
    kernel by correlation id) lies inside a program span starts on the
    device no earlier than the span; no span is mirrored onto the
    device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    frames = _clip8()
    enc = FvcEncoder(85, motion=True, device=cuda_device)
    enc.encode_chunk(frames)   # the kernels built, the sizes adapted
    if state:   # a new encoder whose window overflows
        enc = FvcEncoder.from_numpy_state(QY, QC, 7, motion=True,
                                          device=cuda_device, **state)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enc.encode_chunk(frames)
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    assert not [e.name() for e in on_card if e.name().startswith("flu.")]
    kernel_start = {e.correlation_id(): e.start_ns() for e in on_card}
    spans = [(e.start_ns(), e.end_ns()) for e in events
             if e.name() == span and e.device_type() == DeviceType.CPU]
    assert len(spans) == 1
    lo, hi = spans[0]
    launched = [kernel_start[e.correlation_id()] for e in events
                if e.device_type() == DeviceType.CPU
                and "Launch" in e.name() and lo <= e.start_ns() <= hi
                and e.correlation_id() in kernel_start]
    assert len(launched) > 10
    assert min(launched) >= lo


def _pan_chunk(dev, h=1080, w=1920, step=(8, 48), frames=8, seed=5):
    """One chunk of the benchmark's pan content on ``dev``: a texture of
    uniform noise smoothed by six 3x3 box passes, cropped along a pan of
    ``step`` px a frame, and grain of 1 level in every frame."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tex = torch.randint(0, 256, (h + step[0] * (frames - 1),
                                 w + step[1] * (frames - 1), 3),
                        generator=g, device=dev,
                        dtype=torch.uint8).to(torch.float32)
    for _ in range(6):
        tex = sum(torch.roll(tex, (dy, dx), dims=(0, 1))
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
    clip = torch.stack([tex[step[0] * i:step[0] * i + h,
                            step[1] * i:step[1] * i + w]
                        for i in range(frames)])
    clip += torch.randn(clip.shape, generator=g, device=dev)
    return clip.round_().clamp_(0, 255).to(torch.uint8)


@pytest.mark.cuda
def test_a_1080p_chunk_codes_once_at_the_learned_window(cuda_device):
    """A 1080p chunk of panned, grainy content, full search ±64: its I
    frame needs more than the prefix cap, so the first dispatch (no usage
    known) is coded twice; the two after it start at the learned window,
    record no redispatch, launch half the first one's kernels and give
    its bytes."""
    from torch.profiler import ProfilerActivity, profile
    from flutpu_torch.codec.ops import transform_kernels as T
    wrappers = (M.motion_search_mc, M.chroma_mc, T.block_dct, T.block_idct,
                K.pack_segments)
    frames = _pan_chunk(cuda_device)
    enc = FvcEncoder(85, motion=True, search_range=64, device=cuda_device)
    coded = []
    for _ in range(3):
        before = sum(k.launches for k in wrappers)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            chunk = enc.encode_chunk(frames)
        redispatches = sum(e.name() == "flu.jpeg.redispatch"
                           for e in prof.profiler.kineto_results.events())
        coded.append((chunk, redispatches,
                      sum(k.launches for k in wrappers) - before))
    (warm, r0, n0), (a, r1, n1), (b, r2, n2) = coded
    assert (r0, r1, r2) == (1, 0, 0)
    assert a == b == warm
    assert n0 == 2 * n1 == 2 * n2 > 0


@pytest.mark.cuda
@pytest.mark.parametrize("entry,hier,search_range", [
    ("chunk", False, 64), ("chunks", False, 64), ("chunks", True, 126),
    ("jpeg", False, 7)])
def test_warmed_dispatch_never_syncs(cuda_device, entry, hier,
                                     search_range):
    """A warmed dispatch of each one-card entry (C = 4 chunks of 8
    frames at 272x480; the FVC search at full ±64 or hier ±126) under
    ``set_sync_debug_mode("error")`` raises at no synchronizing call and
    uploads no table; its bytes equal the same encoder's without the
    debug mode."""
    from flutpu_torch.codec.ops.constants import on_device
    dispatch, finalize, enc, _ = dispatch_entries(
        cuda_device, 4, 8, 272, 480, hier, search_range)[entry]
    want = finalize(enc, dispatch(enc))
    before = on_device.uploads
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = dispatch(enc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert on_device.uploads == before
    assert finalize(enc, handle) == want
