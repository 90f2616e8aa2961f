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
from torch_helpers import cuda_device, rand_planes, tie_contract  # noqa: F401

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
    tables) bit-identical to their plain versions and to each other."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,r", [(1088, 1920, 7), (96, 160, 7),
                                   (96, 160, 3), (64, 96, 1)])
def test_hier_kernels_match_plain(cuda_device, h, w, r):
    """K5: pool, K6a at mb=8 and the refine kernel, bit-identical to the
    plain version, on a rolled plane with one divergent macroblock and on
    a flat plane (every refine candidate ties)."""
    cur, prev = _rolled_pair(h, w, h + r, (4, -3))
    cur[16:32, 32:48] = np.random.default_rng(r).uniform(0, 255, (16, 16))
    flat = np.full((h, w), 100.0, np.float32)
    for a, b in ((cur, prev), (flat, flat)):
        c, p = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
        before = (M.motion_search_mc_hier.launches,
                  M.motion_search_mc_blocks.launches)
        mv, pred = M.motion_search_mc_hier(c, p, r)
        torch.cuda.synchronize()
        assert (M.motion_search_mc_hier.launches,
                M.motion_search_mc_blocks.launches) == (before[0] + 1,
                                                        before[1] + 1)
        mv_p, pred_p = M.motion_search_mc_hier_plain(c, p, r)
        assert torch.equal(mv, mv_p)
        assert torch.equal(pred, pred_p)


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
                                     (48, 80, 4)])
def test_chroma_kernel_matches_plain(cuda_device, hc, wc, r):
    rng = np.random.default_rng(hc + r)
    cb, cr = (torch.from_numpy(rng.normal(128, 30, (hc, wc))
                               .astype(np.float32)).to(cuda_device)
              for _ in range(2))
    mv = torch.from_numpy(rng.integers(-r, r + 1, (hc // 8, wc // 8, 2))
                          .astype(np.int32)).to(cuda_device)
    before = M.chroma_mc.launches
    got = M.chroma_mc(cb, cr, mv, r)
    assert M.chroma_mc.launches == before + 1
    for a, b in zip(got, M.chroma_mc_plain(cb, cr, mv, r)):
        assert torch.equal(a, b)


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
def test_fvc_motion_refuses_tf32(cuda_device):
    """The in-loop DCT is codec state: a TF32 matmul would drift the
    decoder's P chain, so the encoder raises rather than run with it."""
    frames = np.zeros((2, 32, 48, 3), np.uint8)
    enc = FvcEncoder(motion=True, device=cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            enc.encode_chunk(frames)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


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
