"""flutpu_torch's motion search and compensation against flutpu's on the CPU.

Contract: the plain versions of the search kernel (K3,
``motion_search_mc_plain``) and of the chroma kernel (K4,
``chroma_mc_plain``) give vectors and predictions bit-identical to the
JAX package's ``motion_search`` + ``motion_compensate`` and to its Pallas
kernels ``motion_search_mc_dxmajor_pallas`` / ``chroma_mc_pallas`` run in
interpret mode, on the shapes of flutpu's own kernel tests plus 96x160
(widths that are not multiples of 128), at search ranges 7, 5 and 4.
The inputs are continuous-valued, so SADs are not integers; a near-tie
of two candidates' fp32 costs could still order them differently, and
none occurs on these seeds. On a CPU tensor the wrappers take the plain
versions and count no launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.ops import motion as jm
from flutpu.codec.ops.motion_pallas import (chroma_mc_pallas,
                                            motion_search_mc_dxmajor_pallas)
from flutpu_torch.codec.ops import motion as tm
from flutpu_torch.codec.ops import motion_kernels as K

torch.set_num_threads(1)

SEARCH_CASES = [(64, 128, 7), (48, 256, 7), (64, 96, 7), (96, 160, 7),
                (96, 160, 5), (96, 160, 4)]
CHROMA_CASES = [(64, 128, 7), (72, 192, 7), (64, 128, 5), (64, 128, 4),
                (48, 80, 7), (48, 80, 4)]


def _pair(h, w, r, seed):
    """A reference plane and the current plane: the reference rolled by
    a vector in range plus Gaussian noise (flutpu's test recipe)."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    cur = np.roll(prev, (rng.integers(-r, r + 1), rng.integers(-r, r + 1)),
                  axis=(0, 1)) + rng.normal(0, 2, (h, w)).astype(np.float32)
    return cur.astype(np.float32), prev


@pytest.fixture(scope="module")
def search_refs():
    """JAX's vectors and predictions for every search case, computed once
    (XLA arm and the dy-major Pallas kernel in interpret mode)."""
    out = {}
    for i, (h, w, r) in enumerate(SEARCH_CASES):
        cur, prev = _pair(h, w, r, seed=11 + i)
        mv = np.asarray(jm.motion_search(jnp.asarray(cur), jnp.asarray(prev),
                                         search_range=r))
        pred = np.asarray(jm.motion_compensate(jnp.asarray(prev),
                                               jnp.asarray(mv),
                                               search_range=r))
        kmv, kpred = motion_search_mc_dxmajor_pallas(
            jnp.asarray(cur), jnp.asarray(prev), search_range=r,
            interpret=True)
        out[(h, w, r)] = (cur, prev, mv, pred, np.asarray(kmv),
                          np.asarray(kpred))
    return out


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_search_plain_matches_xla(search_refs, case):
    cur, prev, mv, pred, _, _ = search_refs[case]
    got_mv, got_pred = K.motion_search_mc_plain(torch.from_numpy(cur),
                                                torch.from_numpy(prev),
                                                case[2])
    assert got_mv.dtype == torch.int32 and got_pred.dtype == torch.float32
    np.testing.assert_array_equal(got_mv.numpy(), mv)
    np.testing.assert_array_equal(got_pred.numpy(), pred)


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_search_plain_matches_dxmajor_pallas(search_refs, case):
    cur, prev, _, _, kmv, kpred = search_refs[case]
    got_mv, got_pred = K.motion_search_mc_plain(torch.from_numpy(cur),
                                                torch.from_numpy(prev),
                                                case[2])
    np.testing.assert_array_equal(got_mv.numpy(), kmv)
    np.testing.assert_array_equal(got_pred.numpy(), kpred)


@pytest.mark.parametrize("case", CHROMA_CASES)
def test_chroma_plain_matches_xla_and_pallas(case):
    hc, wc, r = case
    rng = np.random.default_rng(9 + hc + r)
    cb, cr = (rng.normal(128, 30, (hc, wc)).astype(np.float32)
              for _ in range(2))
    mv = rng.integers(-r, r + 1, (hc // 8, wc // 8, 2)).astype(np.int32)
    got = K.chroma_mc_plain(torch.from_numpy(cb), torch.from_numpy(cr),
                            torch.from_numpy(mv), r)
    for g, p in zip(got, (cb, cr)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(
            jm.motion_compensate(jnp.asarray(p), jnp.asarray(mv),
                                 search_range=r, mb=8)))
    if wc % 64 == 0:          # chroma_mc_pallas's grid alignment
        want = chroma_mc_pallas(jnp.asarray(cb), jnp.asarray(cr),
                                jnp.asarray(mv), search_range=r,
                                interpret=True)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("v", [-7, -5, -3, -1, 1, 3, 7])
def test_chroma_floor_halves_odd_vectors(v):
    """-7 // 2 == -4: the halving floors, it does not truncate."""
    rng = np.random.default_rng(3)
    p = rng.normal(128, 30, (24, 40)).astype(np.float32)
    mv = np.zeros((3, 5, 2), np.int32)
    mv[1, 2] = (v, -v)
    mv[0, 0] = (v, 0)
    got = K.chroma_mc_plain(torch.from_numpy(p), torch.from_numpy(p),
                            torch.from_numpy(mv), 7)[0].numpy()
    want = np.asarray(jm.motion_compensate(jnp.asarray(p), jnp.asarray(mv),
                                           search_range=7, mb=8))
    np.testing.assert_array_equal(got, want)
    shifted = np.roll(p, (v // 2, (-v) // 2), axis=(0, 1))
    np.testing.assert_array_equal(got[8:16, 16:24], shifted[8:16, 16:24])


def test_chroma_plain_matches_pallas_at_range_32():
    """Vectors of ±32 (±16 after the halving) on a 48x64 plane move
    blocks further than a block, and a third of the plane's height."""
    rng = np.random.default_rng(32)
    cb, cr = (rng.normal(128, 30, (48, 64)).astype(np.float32)
              for _ in range(2))
    mv = rng.integers(-32, 33, (6, 8, 2)).astype(np.int32)
    mv[0, 0], mv[1, 1] = (-32, 32), (-31, -17)
    got = K.chroma_mc_plain(torch.from_numpy(cb), torch.from_numpy(cr),
                            torch.from_numpy(mv), 32)
    want = chroma_mc_pallas(jnp.asarray(cb), jnp.asarray(cr),
                            jnp.asarray(mv), search_range=32, interpret=True)
    for g, p, w_ in zip(got, (cb, cr), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(g.numpy(), np.asarray(
            jm.motion_compensate(jnp.asarray(p), jnp.asarray(mv),
                                 search_range=32, mb=8)))


def test_luma_compensate_matches_xla_on_random_vectors():
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 255, (48, 80)).astype(np.float32)
    mv = rng.integers(-7, 8, (3, 5, 2)).astype(np.int32)
    got = tm.motion_compensate(torch.from_numpy(p), torch.from_numpy(mv), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jm.motion_compensate(jnp.asarray(p), jnp.asarray(mv),
                             search_range=7)))


def test_ties_go_to_the_first_scanned_candidate():
    """A flat plane ties every candidate's SAD: the |mv| bias picks
    (0, 0). A plane of period 2 in x ties dx = -1 with dx = +1 at equal
    bias: dy-major order scans dx = -1 first, and it wins, as in flutpu."""
    flat = np.full((32, 48), 100.0, np.float32)
    stripes = np.tile(np.array([10.0, 200.0], np.float32), (32, 24))
    cur = np.roll(stripes, 1, axis=1) + 0.25
    for c, p in ((flat, flat), (cur, stripes)):
        got = tm.motion_search(torch.from_numpy(c), torch.from_numpy(p), 3)
        want = np.asarray(jm.motion_search(jnp.asarray(c), jnp.asarray(p),
                                           search_range=3))
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[..., 1] == -1).all() and (want[..., 0] == 0).all()


def test_mb_sums_order():
    """Columns down their rows first, then the column sums left to right."""
    d = np.random.default_rng(5).random((16, 32)).astype(np.float32) * 255
    got = tm._mb_sums(torch.from_numpy(d), 16).numpy()
    for bx in range(2):
        blk = d[:, 16 * bx:16 * bx + 16]
        cols = []
        for j in range(16):
            s = np.float32(blk[0, j])
            for i in range(1, 16):
                s = np.float32(s + blk[i, j])
            cols.append(s)
        t = cols[0]
        for c in cols[1:]:
            t = np.float32(t + c)
        assert got[0, bx] == t


def test_wrappers_take_the_plain_versions_on_cpu():
    cur, prev = _pair(32, 48, 3, seed=2)
    mv_c = np.random.default_rng(1).integers(-3, 4, (2, 3, 2), np.int32)
    before = (K.motion_search_mc.launches, K.chroma_mc.launches)
    a = K.motion_search_mc(torch.from_numpy(cur), torch.from_numpy(prev), 3)
    b = K.motion_search_mc_plain(torch.from_numpy(cur),
                                 torch.from_numpy(prev), 3)
    c = K.chroma_mc(torch.from_numpy(prev[:16, :24].copy()),
                    torch.from_numpy(cur[:16, :24].copy()),
                    torch.from_numpy(mv_c), 3)
    d = K.chroma_mc_plain(torch.from_numpy(prev[:16, :24].copy()),
                          torch.from_numpy(cur[:16, :24].copy()),
                          torch.from_numpy(mv_c), 3)
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)
    assert (K.motion_search_mc.launches, K.chroma_mc.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "odd", "range", "mv"])
def test_argument_checks(bad):
    z = torch.zeros((32, 48))
    with pytest.raises(ValueError):
        if bad == "dtype":
            K.motion_search_mc(z.double(), z.double(), 7)
        elif bad == "shape":
            K.motion_search_mc(z, torch.zeros((32, 64)), 7)
        elif bad == "odd":
            K.motion_search_mc(torch.zeros((24, 48)), torch.zeros((24, 48)),
                               7)
        elif bad == "range":
            K.motion_search_mc(z, z, K.MAX_SEARCH_RANGE + 1)
        else:
            K.chroma_mc(z[:16, :24], z[:16, :24],
                        torch.zeros((2, 2, 2), dtype=torch.int32), 7)


HALF_PEL_CASES = [(64, 96, 7, True), (96, 160, 5, True), (48, 80, 3, False)]


@pytest.mark.parametrize("h,w,r,integer", HALF_PEL_CASES)
def test_subpel_refine_matches_flutpu(h, w, r, integer):
    """``subpel_refine`` against flutpu's on the integer vectors of the
    full search: exact on integer-valued planes (every half-pel sample
    and SAD is exact in fp32, so no summation order can move a choice),
    and equal here on continuous-valued planes too. The refined vectors
    stay within one half-pel step of twice the integer ones."""
    cur, prev = _pair(h, w, r, seed=h + w + r)
    if integer:
        cur, prev = np.round(cur), np.round(prev)
    mv = tm.motion_search(torch.from_numpy(cur), torch.from_numpy(prev), r)
    got = tm.subpel_refine(torch.from_numpy(cur), torch.from_numpy(prev), mv)
    want = jm.subpel_refine(jnp.asarray(cur), jnp.asarray(prev),
                            jnp.asarray(mv.numpy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got - 2 * mv).abs().max() <= 1


@pytest.mark.parametrize("mb", [16, 8])
@pytest.mark.parametrize("integer", [True, False])
def test_subpel_compensate_matches_flutpu(mb, integer):
    """``motion_compensate_subpel`` for luma (mb 16) and chroma (mb 8:
    vectors floor-halved onto the chroma grid, odd negative ones among
    them) against flutpu's: bit-identical (the bilinear weights are 0,
    1/2 and 1, so each product is exact and the sum order is the
    original's)."""
    rng = np.random.default_rng(mb)
    h, w = (96, 160) if mb == 16 else (48, 80)
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    if integer:
        prev = np.round(prev)
    mv = rng.integers(-15, 16, (6, 10, 2)).astype(np.int32)
    got = tm.motion_compensate_subpel(torch.from_numpy(prev),
                                      torch.from_numpy(mv), mb=mb)
    want = jm.motion_compensate_subpel(jnp.asarray(prev), jnp.asarray(mv),
                                       mb=mb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mb == 16:   # even half-pel vectors are the integer compensation
        np.testing.assert_array_equal(
            tm.motion_compensate_subpel(torch.from_numpy(prev),
                                        torch.from_numpy(mv * 2)).numpy(),
            tm.motion_compensate(torch.from_numpy(prev),
                                 torch.from_numpy(mv)).numpy())


def test_subpel_ops_take_a_chunk_axis():
    """Both take (C, H, W) planes and (C, H/16, W/16, 2) vectors, each
    chunk inside its own plane, as a loop of single calls."""
    rng = np.random.default_rng(5)
    cur = torch.from_numpy(rng.uniform(0, 255, (3, 32, 48))
                           .astype(np.float32))
    prev = torch.from_numpy(rng.uniform(0, 255, (3, 32, 48))
                            .astype(np.float32))
    mv = torch.from_numpy(rng.integers(-5, 6, (3, 2, 3, 2)).astype(np.int32))
    ref = tm.subpel_refine(cur, prev, mv)
    luma = tm.motion_compensate_subpel(prev, ref)
    chroma = tm.motion_compensate_subpel(prev[:, :16, :24], ref, mb=8)
    for k in range(3):
        assert torch.equal(ref[k], tm.subpel_refine(cur[k], prev[k], mv[k]))
        assert torch.equal(luma[k],
                           tm.motion_compensate_subpel(prev[k], ref[k]))
        assert torch.equal(chroma[k], tm.motion_compensate_subpel(
            prev[k, :16, :24], ref[k], mb=8))
