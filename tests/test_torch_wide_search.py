"""Search ranges 33-126 in flutpu_torch against flutpu on the CPU.

Contract: above r = 32 the plain versions of the search kernels (K3
``motion_search_mc_plain``, K6a ``motion_search_mc_blocks_plain``, K5
``motion_search_mc_hier_plain``) give vectors and predictions
bit-identical to flutpu's XLA ``motion_search`` + ``motion_compensate``
and ``motion_search_hier`` on integer-valued planes (exact SADs), with
edges that wrap on planes smaller than the window; the chroma
compensation (K4) takes vectors up to ±126; an FVC chunk at
``search_range=40`` equals flutpu's byte for byte; and the encoder takes
flutpu's ranges, 1..126 (1..62 with ``subpel``), raising ValueError
outside them. flutpu's Pallas kernels are not run here: their dx loop is
unrolled statically, which interpret mode cannot take at these ranges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec import fvc as jf
from flutpu.codec.ops import motion as jm
from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.ops import motion_kernels as K

torch.set_num_threads(1)

H, W = 64, 96
RANGES = [33, 40, 126]


def _pair(h, w, r, seed):
    """Integer-valued planes: the reference rolled by a vector in range
    plus small integer noise, clipped to 0..255."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (h, w)).astype(np.float32)
    cur = np.roll(prev, (rng.integers(-r, r + 1), rng.integers(-r, r + 1)),
                  axis=(0, 1)) + rng.integers(-3, 4, (h, w))
    return np.clip(cur, 0, 255).astype(np.float32), prev


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("r", RANGES)
def test_full_search_plain_matches_xla(r):
    """K3's plain version at ranges above 32; at 126 the window (16 +
    252 rows) wraps the 64-row plane four times."""
    cur, prev = _pair(H, W, r, seed=r)
    xmv = np.asarray(jm.motion_search(jnp.asarray(cur), jnp.asarray(prev),
                                      search_range=r))
    xpred = np.asarray(jm.motion_compensate(jnp.asarray(prev),
                                            jnp.asarray(xmv),
                                            search_range=r))
    mv, pred = K.motion_search_mc_plain(*_t(cur, prev), r)
    np.testing.assert_array_equal(mv.numpy(), xmv)
    np.testing.assert_array_equal(pred.numpy(), xpred)
    assert int(mv.abs().max()) <= r


@pytest.mark.parametrize("r", RANGES)
def test_hier_plain_matches_xla(r):
    """K5's plain version: the coarse search at ±r // 2 on the pooled
    planes (±63 at 126), the base clipped to ±(r - 1), the ±1 refine."""
    cur, prev = _pair(H, W, r, seed=100 + r)
    xmv = np.asarray(jm.motion_search_hier(jnp.asarray(cur),
                                           jnp.asarray(prev),
                                           search_range=r))
    xpred = np.asarray(jm.motion_compensate(jnp.asarray(prev),
                                            jnp.asarray(xmv),
                                            search_range=r))
    mv, pred = K.motion_search_mc_hier_plain(*_t(cur, prev), r)
    np.testing.assert_array_equal(mv.numpy(), xmv)
    np.testing.assert_array_equal(pred.numpy(), xpred)
    assert int(mv.abs().max()) <= r


@pytest.mark.parametrize("r", [33, 64])
def test_blocks_plain_matches_xla_at_8x8(r):
    """K6a's plain version at mb = 8: flutpu's vectors, and each 8x8
    block shifted by its full vector."""
    cur, prev = _pair(32, 48, r, seed=200 + r)
    xmv = np.asarray(jm.motion_search(jnp.asarray(cur), jnp.asarray(prev),
                                      search_range=r, mb=8))
    mv, pred = K.motion_search_mc_blocks_plain(*_t(cur, prev), r, 8)
    np.testing.assert_array_equal(mv.numpy(), xmv)
    rows = (np.arange(32)[:, None] - np.repeat(np.repeat(
        xmv[..., 0], 8, 0), 8, 1)) % 32
    cols = (np.arange(48)[None, :] - np.repeat(np.repeat(
        xmv[..., 1], 8, 0), 8, 1)) % 48
    np.testing.assert_array_equal(pred.numpy(), prev[rows, cols])


def test_chroma_plain_takes_vectors_to_126():
    """K4's plain version on luma vectors up to ±126 (chroma ±63, odd
    negative ones floor-halved), against flutpu's chroma compensation."""
    rng = np.random.default_rng(9)
    cb, cr = (rng.uniform(0, 255, (32, 48)).astype(np.float32)
              for _ in range(2))
    mv = rng.integers(-126, 127, (4, 6, 2)).astype(np.int32)
    mv[0, 0] = (126, -126)
    mv[0, 1] = (-125, 125)
    got = K.chroma_mc_plain(*_t(cb, cr, mv), 126)
    for plane, g in zip((cb, cr), got):
        want = np.asarray(jm.motion_compensate(
            jnp.asarray(plane), jnp.asarray(mv), search_range=126, mb=8))
        np.testing.assert_array_equal(g.numpy(), want)


def _pan(n, dy, dx, seed=7):
    """A seeded smooth texture panned (dy, dx) pixels per frame, wrapping
    (benches/rd_sweep.py's ``pan`` recipe, without its imports)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W, 3)).astype(np.float32)
    pad = np.pad(base, ((1, 1), (1, 1), (0, 0)), mode="wrap")
    base = sum(pad[i:i + H, j:j + W] for i in range(3)
               for j in range(3)) / 9.0
    base = base.astype(np.uint8)
    return np.stack([np.roll(base, (dy * i, dx * i), axis=(0, 1))
                     for i in range(n)])


@pytest.mark.parametrize("hier", [False, True], ids=["full", "hier"])
def test_chunk_at_range_40_byte_identical(hier):
    """An 8-frame 64x96 pan of 36 columns per frame at ``search_range=40``:
    the port's chunk equals flutpu's, and its vectors reach past ±32."""
    frames = _pan(8, 2, 36)
    je = jf.FvcEncoder(85, motion=True, search_range=40, hier=hier)
    te = FvcEncoder.from_numpy_state(je.qy, je.qc, 40, motion=True,
                                     hier=hier, device="cpu")
    got = te.encode_chunk(frames)
    assert got == je.encode_chunk(frames)
    assert got[12] == 40
    _, records = FvcDecoder.parse_chunk(got)
    vecs = np.stack([v for _, v, _ in records if v is not None])
    assert np.abs(vecs).max() > 32


@pytest.mark.parametrize("subpel,limit", [(False, 126), (True, 62)])
def test_encoder_takes_flutpus_ranges(subpel, limit):
    """Every range 1..limit builds, as in flutpu; 0 and limit + 1 raise
    ValueError in both packages."""
    for r in (1, 32, 33, limit // 2, limit):
        te = FvcEncoder(85, motion=True, search_range=r, subpel=subpel,
                        device="cpu")
        assert te.search_range == jf.FvcEncoder(
            85, motion=True, search_range=r, subpel=subpel).search_range
    for r in (0, limit + 1):
        with pytest.raises(ValueError):
            jf.FvcEncoder(85, motion=True, search_range=r, subpel=subpel)
        with pytest.raises(ValueError):
            FvcEncoder(85, motion=True, search_range=r, subpel=subpel,
                       device="cpu")


def test_kernel_limit_is_the_encoders():
    assert K.MAX_SEARCH_RANGE == 126
    z = torch.zeros((32, 48))
    with pytest.raises(ValueError):
        K.motion_search_mc(z, z, 127)
    with pytest.raises(ValueError):
        K.motion_search_mc_hier(z, z, 127)
