"""Row stripes in the port (``ops/motion.py``'s striped functions and the
rounded-halo route of ``ops/motion_kernels.py``) against flutpu's
sequence-parallel formulations on the CPU.

flutpu's ``exchange_row_halos`` runs under ``shard_map`` over 4 of
``conftest``'s virtual CPU devices; its ``motion_search_striped`` and
``motion_compensate_striped`` on stripes with r-row halos. The port's
route pads each stripe by whole macroblock rows (hr = 16 * ceil(r / 16))
and runs K3's and K4's plain versions on it: vectors and predictions must
equal flutpu's exactly, at r = 3, 7, 16 and 17 on stripes of 16 and 32
rows (hr = Hs included). The planes are integer-valued, so every SAD is
exact and the first-wins order alone decides ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from flutpu.codec.ops import motion as JM
from flutpu_torch.codec.ops import motion as TM
from flutpu_torch.codec.ops import motion_kernels as K

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

W = 48


def _planes(seed, s, hs, lead=(), w=W):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (*lead, s * hs, w)).astype(np.float32)


def _cut(a, s):
    return [torch.from_numpy(np.ascontiguousarray(p))
            for p in np.split(a, s, axis=-2)]


def _haloed(a, s, r):
    """flutpu's view of stripe k: its rows with r rows of the whole
    frame's wrap on either side (what ``exchange_row_halos`` assembles)."""
    h = a.shape[-2]
    hs = h // s
    return [np.take(a, np.arange(k * hs - r, (k + 1) * hs + r) % h, axis=-2)
            for k in range(s)]


@pytest.mark.parametrize("r,hs", [(1, 16), (3, 16), (16, 16), (5, 32)])
def test_exchange_row_halos_equals_flutpus_ring(r, hs):
    """The port's halo exchange over a list of 4 stripes = flutpu's two
    ring ppermutes under ``shard_map`` over 4 CPU devices."""
    a = _planes(1, 4, hs)
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    fn = shard_map(lambda p: JM.exchange_row_halos(p, r, "spatial", 4),
                   mesh=mesh, in_specs=P("spatial", None),
                   out_specs=P("spatial", None))
    want = np.split(np.asarray(fn(jnp.asarray(a))), 4, axis=0)
    got = TM.exchange_row_halos(_cut(a, 4), r)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)
    with pytest.raises(ValueError, match="stripe"):
        TM.exchange_row_halos(_cut(a, 4), hs + 1)


@pytest.mark.parametrize("r", [1, 3, 7])
def test_striped_search_and_compensation_equal_flutpus(r):
    """``motion_search_striped`` / ``motion_compensate_striped`` (luma,
    and chroma at halo (r + 1) // 2) of the port = flutpu's, stripe by
    stripe, and = the unstriped search's rows."""
    s, hs = 3, 16
    cur, prev = _planes(2, s, hs), _planes(3, s, hs)
    chroma = _planes(4, s, hs // 2, w=W // 2)
    rc = (r + 1) // 2
    whole = TM.motion_search(torch.from_numpy(cur), torch.from_numpy(prev), r)
    for k, (c, ph, pc) in enumerate(zip(np.split(cur, s), _haloed(prev, s, r),
                                        _haloed(chroma, s, rc))):
        want = np.asarray(JM.motion_search_striped(jnp.asarray(c),
                                                   jnp.asarray(ph), r))
        mv = TM.motion_search_striped(torch.from_numpy(c),
                                      torch.from_numpy(ph), r)
        np.testing.assert_array_equal(mv.numpy(), want)
        assert torch.equal(mv, whole[k * hs // 16:(k + 1) * hs // 16])
        np.testing.assert_array_equal(
            TM.motion_compensate_striped(torch.from_numpy(ph), mv, r,
                                         r).numpy(),
            np.asarray(JM.motion_compensate_striped(jnp.asarray(ph),
                                                    jnp.asarray(want), r,
                                                    r)))
        np.testing.assert_array_equal(
            TM.motion_compensate_striped(torch.from_numpy(pc), mv, rc, r,
                                         mb=8).numpy(),
            np.asarray(JM.motion_compensate_striped(
                jnp.asarray(pc), jnp.asarray(want), rc, r, mb=8)))


@pytest.mark.parametrize("r,hs", [(3, 16), (7, 16), (16, 16), (3, 32),
                                  (7, 32), (16, 32), (17, 32)])
def test_rounded_halo_route_equals_flutpus_striped(r, hs):
    """K3 and K4 (plain versions) on stripes padded by whole macroblock
    rows: each stripe's vectors, luma prediction and chroma predictions
    = flutpu's striped search and compensation with an r-row halo, for
    2 chunks of 3 stripes; hr = Hs at (16, 16) and (17, 32)."""
    s, lead = 3, (2,)
    cur, prev = _planes(5, s, hs, lead), _planes(6, s, hs, lead)
    cb, cr = _planes(7, s, hs // 2, lead, W // 2), \
        _planes(8, s, hs // 2, lead, W // 2)
    mvs, preds = K.motion_search_mc_striped(_cut(cur, s), _cut(prev, s), r)
    pcb, pcr = K.chroma_mc_striped(_cut(cb, s), _cut(cr, s), mvs, r)
    rc = (r + 1) // 2
    for k in range(s):
        for c in range(2):
            ph = _haloed(prev[c], s, r)[k]
            want = np.asarray(JM.motion_search_striped(
                jnp.asarray(np.split(cur[c], s)[k]), jnp.asarray(ph), r))
            np.testing.assert_array_equal(mvs[k][c].numpy(), want)
            np.testing.assert_array_equal(
                preds[k][c].numpy(), np.asarray(JM.motion_compensate_striped(
                    jnp.asarray(ph), jnp.asarray(want), r, r)))
            for got, plane in ((pcb, cb), (pcr, cr)):
                hc = _haloed(plane[c], s, rc)[k]
                np.testing.assert_array_equal(
                    got[k][c].numpy(), np.asarray(
                        JM.motion_compensate_striped(
                            jnp.asarray(hc), jnp.asarray(want), rc, r,
                            mb=8)))


def test_route_equals_the_unstriped_kernels_rows():
    """The route's stripes = K3's and K4's (plain) unstriped output cut
    into the same rows, at r = 7 over 4 stripes of 16 rows."""
    s, hs, r = 4, 16, 7
    cur, prev = _planes(9, s, hs), _planes(10, s, hs)
    cb, cr = _planes(11, s, hs // 2, w=W // 2), \
        _planes(12, s, hs // 2, w=W // 2)
    mv, pred = K.motion_search_mc(torch.from_numpy(cur),
                                  torch.from_numpy(prev), r)
    wcb, wcr = K.chroma_mc(torch.from_numpy(cb), torch.from_numpy(cr), mv, r)
    mvs, preds = K.motion_search_mc_striped(_cut(cur, s), _cut(prev, s), r)
    pcb, pcr = K.chroma_mc_striped(_cut(cb, s), _cut(cr, s), mvs, r)
    assert torch.equal(torch.cat(mvs), mv) and torch.equal(torch.cat(preds),
                                                           pred)
    assert torch.equal(torch.cat(pcb), wcb) and torch.equal(torch.cat(pcr),
                                                            wcr)


def test_thin_stripe_raises():
    """A stripe thinner than its rounded halo: ValueError naming the
    stripe height (r = 17 needs 32 halo rows, the stripes have 16)."""
    cur, prev = _planes(13, 2, 16), _planes(14, 2, 16)
    with pytest.raises(ValueError, match="16 rows"):
        K.motion_search_mc_striped(_cut(cur, 2), _cut(prev, 2), 17)
    cb = _planes(15, 2, 8, w=W // 2)
    mv = [torch.zeros((1, 3, 2), dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="rows"):
        K.chroma_mc_striped(_cut(cb, 2), _cut(cb, 2), mv, 17)
    assert K.halo_rows(16, 16) == 16 and K.halo_rows(17, 32) == 32
