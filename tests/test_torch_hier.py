"""flutpu_torch's block-size-generic search (K6a), its dy-grid counterpart
(K6b) and the hierarchical search (K5) against flutpu's on the CPU.

Contract: the plain versions give vectors and predictions bit-identical
to flutpu's Pallas kernels run in interpret mode —
``motion_search_mc_pallas`` at mb = 16 and mb = 8,
``motion_search_mc_dygrid_pallas`` and ``motion_search_mc_hier_pallas``
— and K5's also to flutpu's XLA arm (``motion_search_hier`` +
``motion_compensate``). At mb = 8 K6a's prediction shifts each 8x8 block
by its full vector, as the TPU kernel does; ``motion_compensate(...,
mb=8)`` would halve it (chroma semantics). On integer-valued planes every
pooled value is a multiple of 0.25 and every SAD is exact, so no order
of summation can split the packages; the continuous-valued inputs (the
recipes of flutpu's own kernel tests) hold no near-tie on these seeds.
On a CPU tensor the wrappers take the plain versions and count no
launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.ops import colorspace as jcs
from flutpu.codec.ops import motion as jm
from flutpu.codec.ops.motion_pallas import (motion_search_mc_dygrid_pallas,
                                            motion_search_mc_hier_pallas,
                                            motion_search_mc_pallas)
from flutpu_torch.codec.ops import motion as tm
from flutpu_torch.codec.ops import motion_kernels as K

torch.set_num_threads(1)

SHAPES = [(64, 128), (48, 256), (64, 96)]
BLOCK_CASES = ([(h, w, r, 16) for r in (3, 7) for h, w in SHAPES]
               + [(h, w, r, 8) for r in (3, 7)
                  for h, w in SHAPES + [(32, 48)]])


def _pair(h, w, r, seed):
    """A reference plane and the current plane: the reference rolled by a
    vector in range plus Gaussian noise (flutpu's test recipe)."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    cur = np.roll(prev, (rng.integers(-r, r + 1), rng.integers(-r, r + 1)),
                  axis=(0, 1)) + rng.normal(0, 2, (h, w)).astype(np.float32)
    return cur.astype(np.float32), prev


def _divergent(h, w, rng):
    """flutpu's hier kernel test input: a plane rolled by (4, -3) with one
    macroblock of fresh noise."""
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    cur = np.roll(prev, (4, -3), axis=(0, 1)).astype(np.float32)
    cur[16:32, 32:48] = rng.uniform(0, 255, (16, 16))
    return cur, prev


def _hier_inputs():
    rng = np.random.default_rng(11)
    out = {f"divergent {h}x{w}": _divergent(h, w, rng)
           for h, w in ((64, 128), (128, 192), (64, 96))}
    flat = np.full((64, 96), 100.0, np.float32)
    out["flat"] = (flat, flat.copy())
    irng = np.random.default_rng(3)
    prev = irng.integers(0, 256, (96, 160)).astype(np.float32)
    cur = np.roll(prev, (5, 2), axis=(0, 1))
    cur[32:64, 48:80] = irng.integers(0, 256, (32, 32))
    out["integer 96x160"] = (cur, prev)
    return out


HIER = _hier_inputs()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("h,w,r,mb", BLOCK_CASES)
def test_blocks_plain_matches_pallas(h, w, r, mb):
    cur, prev = _pair(h, w, r, seed=h + w + r + mb)
    kmv, kpred = motion_search_mc_pallas(jnp.asarray(cur), jnp.asarray(prev),
                                         search_range=r, mb=mb,
                                         interpret=True)
    mv, pred = K.motion_search_mc_blocks_plain(*_t(cur, prev), r, mb)
    assert mv.dtype == torch.int32 and mv.shape == (h // mb, w // mb, 2)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(kmv))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(kpred))


def test_blocks_prediction_shifts_by_the_full_vector():
    """At mb = 8 the TPU kernel's prediction is not motion_compensate's:
    each 8x8 block moves by its whole vector, not the halved one."""
    prev = np.random.default_rng(5).uniform(0, 255, (32, 48)) \
        .astype(np.float32)
    cur = np.roll(prev, (3, 1), axis=(0, 1))
    mv, pred = K.motion_search_mc_blocks_plain(*_t(cur, prev), 3, 8)
    assert (mv.numpy() == (3, 1)).all()
    want = np.roll(prev, (3, 1), axis=(0, 1))[8:16, 16:24]
    np.testing.assert_array_equal(pred.numpy()[8:16, 16:24], want)
    halved = np.asarray(jm.motion_compensate(jnp.asarray(prev),
                                             jnp.asarray(mv.numpy()),
                                             search_range=3, mb=8))
    assert not np.array_equal(pred.numpy(), halved)


@pytest.mark.parametrize("h,w", SHAPES)
def test_dygrid_plain_matches_pallas(h, w):
    cur, prev = _pair(h, w, 7, seed=17 + h + w)
    kmv, kpred = motion_search_mc_dygrid_pallas(
        jnp.asarray(cur), jnp.asarray(prev), search_range=7, interpret=True)
    mv, pred = K.motion_search_mc_dygrid_plain(*_t(cur, prev), 7)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(kmv))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(kpred))


@pytest.mark.parametrize("name", sorted(HIER))
def test_hier_plain_matches_pallas_and_xla(name):
    cur, prev = HIER[name]
    kmv, kpred = motion_search_mc_hier_pallas(
        jnp.asarray(cur), jnp.asarray(prev), search_range=7, interpret=True)
    xmv = np.asarray(jm.motion_search_hier(jnp.asarray(cur),
                                           jnp.asarray(prev), search_range=7))
    xpred = np.asarray(jm.motion_compensate(jnp.asarray(prev),
                                            jnp.asarray(xmv), search_range=7))
    mv, pred = K.motion_search_mc_hier_plain(*_t(cur, prev), 7)
    assert mv.dtype == torch.int32 and pred.dtype == torch.float32
    for want_mv, want_pred in ((kmv, kpred), (xmv, xpred)):
        np.testing.assert_array_equal(mv.numpy(), np.asarray(want_mv))
        np.testing.assert_array_equal(pred.numpy(), np.asarray(want_pred))
    assert int(mv.abs().max()) <= 7


def test_hier_refine_ties_go_to_the_first_offset():
    """A flat plane ties all nine refine candidates (no centre bias):
    (oy, ox) = (-1, -1) is scanned first and wins around a zero base."""
    cur, prev = HIER["flat"]
    mv = tm.motion_search_hier(*_t(cur, prev), 7)
    assert (mv.numpy() == -1).all()


@pytest.mark.parametrize("r", [1, 2, 3, 5])
def test_hier_small_ranges_match_xla(r):
    """Coarse range max(1, r // 2) and base clip ±(r - 1), down to r = 1
    (base 0, refine ±1)."""
    cur, prev = _pair(64, 96, r, seed=30 + r)
    want = np.asarray(jm.motion_search_hier(jnp.asarray(cur),
                                            jnp.asarray(prev),
                                            search_range=r))
    got = tm.motion_search_hier(*_t(cur, prev), r)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.abs().max()) <= r


@pytest.mark.parametrize("r", [16, 32])
@pytest.mark.parametrize("h,w", [(64, 96), (96, 176)])
def test_hier_plain_matches_xla_at_large_ranges(h, w, r):
    """The ranges where the CUDA kernel's staged window outgrows a small
    plane (at r = 32 the window of a 64x96 plane wraps more than once),
    and 96x176 (11 macroblocks a row: a thread block of the kernel takes
    a partial row of them)."""
    cur, prev = _pair(h, w, r, seed=h + w + r)
    xmv = np.asarray(jm.motion_search_hier(jnp.asarray(cur),
                                           jnp.asarray(prev), search_range=r))
    xpred = np.asarray(jm.motion_compensate(jnp.asarray(prev),
                                            jnp.asarray(xmv), search_range=r))
    mv, pred = K.motion_search_mc_hier_plain(*_t(cur, prev), r)
    np.testing.assert_array_equal(mv.numpy(), xmv)
    np.testing.assert_array_equal(pred.numpy(), xpred)
    assert int(mv.abs().max()) <= r


@pytest.mark.parametrize("a,b", [(0, 0), (1, -2), (-3, 5), (17, -29)])
def test_pool_commutes_with_even_wraps(a, b):
    """subsample_420(roll(x, (2a, 2b))) == roll(subsample_420(x), (a, b))
    on a plane of non-integers, shifts past the pooled plane's size
    included: the premise of pooling the hier kernel's staged window,
    which starts at an even row and column of the wrapped plane."""
    x = torch.from_numpy(np.random.default_rng(100 + 7 * a + b).uniform(
        0, 255, (32, 48)).astype(np.float32))
    got = tm.subsample_420(torch.roll(x, (2 * a, 2 * b), dims=(0, 1)))
    want = torch.roll(tm.subsample_420(x), (a, b), dims=(0, 1))
    assert torch.equal(got, want)
    assert not torch.equal(x, x.round())


def test_pool_is_flutpus_mean():
    """The hier pool is subsample_420's expression; on integer planes the
    mean of four is exact, a multiple of 0.25."""
    _, prev = HIER["integer 96x160"]
    got = tm.subsample_420(torch.from_numpy(prev)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jcs.subsample_420(jnp.asarray(prev))))
    assert (got * 4 == np.round(got * 4)).all()


def test_wrappers_take_the_plain_versions_on_cpu():
    cur, prev = _pair(32, 48, 3, seed=2)
    counts = (K.motion_search_mc_blocks, K.motion_search_mc_hier,
              K.motion_search_mc_dygrid)
    before = [f.launches for f in counts]
    pairs = [(K.motion_search_mc_blocks(*_t(cur, prev), 3, 8),
              K.motion_search_mc_blocks_plain(*_t(cur, prev), 3, 8)),
             (K.motion_search_mc_hier(*_t(cur, prev), 3),
              K.motion_search_mc_hier_plain(*_t(cur, prev), 3)),
             (K.motion_search_mc_dygrid(*_t(cur, prev), 3),
              K.motion_search_mc_plain(*_t(cur, prev), 3))]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert [f.launches for f in counts] == before


@pytest.mark.parametrize("bad", ["mb", "blocks-odd", "hier-odd",
                                 "hier-range", "device"])
def test_argument_checks(bad):
    z = torch.zeros((32, 48))
    with pytest.raises(ValueError):
        if bad == "mb":
            K.motion_search_mc_blocks(z, z, 3, 4)
        elif bad == "blocks-odd":
            K.motion_search_mc_blocks(torch.zeros((24, 44)),
                                      torch.zeros((24, 44)), 3, 8)
        elif bad == "hier-odd":
            K.motion_search_mc_hier(torch.zeros((24, 48)),
                                    torch.zeros((24, 48)), 3)
        elif bad == "hier-range":
            K.motion_search_mc_hier(z, z, 0)
        else:
            K.motion_search_mc_hier(z.to("meta"), z.to("meta"), 3)
