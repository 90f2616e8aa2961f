"""The port's chunk-parallel encode (``flutpu_torch.parallel``) against
flutpu's sharded one on the 8-CPU mesh, and against itself chunk by
chunk: ``encode_chunks`` (K1 over C x F frames) and ``fvc_chunks`` (the
FVC codec with a chunk axis through K1, K3, K5 and K4) for v1, P (full
and hier) and B frames; the plain versions of K3, K5, K6a and K4 with a
chunk axis against a loop of single-chunk calls; the mesh and the
multi-process helpers. flutpu's references are computed once per module
(one jax program per codec mode)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                    scale_qtable)
from flutpu.parallel import multihost as j_multihost
from flutpu.parallel.gop import encode_chunks_sharded, fvc_chunks_sharded
from flutpu.parallel.mesh import make_chunk_mesh as j_make_chunk_mesh
from flutpu.parallel.mesh import \
    make_chunk_spatial_mesh as j_make_chunk_spatial_mesh
from flutpu_torch.codec.ops import motion_kernels as M
from flutpu_torch.core.elements import make_test_frame
from flutpu_torch.parallel import multihost as t_multihost
from flutpu_torch.parallel.gop import (encode_chunks, encode_chunks_single,
                                       fvc_chunks)
from flutpu_torch.parallel.mesh import (ChunkMesh, ChunkSpatialMesh,
                                        deal_devices, make_chunk_mesh,
                                        make_chunk_spatial_mesh)
from torch_helpers import chunk_pairs, tie_contract

torch.set_num_threads(1)

QY = scale_qtable(LUMA_QTABLE, 85)
QC = scale_qtable(CHROMA_QTABLE, 85)
QYB = scale_qtable(LUMA_QTABLE, 77)
QCB = scale_qtable(CHROMA_QTABLE, 77)
# 4 chunks of 3 frames of 32x48 (W/2 = 24: XLA:CPU's 4:2:0 sums in the
# port's order): a moving ball, a static plane, a cut to noise, a pan
C, F_, H, W = 4, 3, 32, 48
R = 3
MODES = {"v1": dict(), "full": dict(motion=True),
         "hier": dict(motion=True, hier=True),
         "B": dict(motion=True, bframes=1),
         "subpel": dict(motion=True, subpel=True),
         "hier-subpel": dict(motion=True, hier=True, subpel=True)}


def _clip():
    out = np.empty((C, F_, H, W, 3), np.uint8)
    still = make_test_frame("gradient", W, H, 5)
    for f in range(F_):
        out[0, f] = make_test_frame("ball", W, H, f)
        out[1, f] = still
        out[2, f] = make_test_frame("ball" if f < 2 else "noise", W, H, f)
        out[3, f] = np.roll(still, 2 * f, axis=1)
    return out


CLIP = _clip()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_tables(kw):
    extra = dict(qy_b=_t(QYB), qc_b=_t(QCB)) if kw.get("bframes") else {}
    return _t(QY), _t(QC), extra


@pytest.fixture(scope="module")
def flutpu_refs():
    """flutpu's sharded outputs on 4 of the 8 CPU devices, one jax program
    per mode, as numpy."""
    mesh = j_make_chunk_mesh(4)
    qy, qc = jnp.asarray(QY), jnp.asarray(QC)
    planes = tuple(jnp.asarray(CLIP[..., c]) for c in range(3))
    out = {"jpeg": [np.asarray(a) for a in encode_chunks_sharded(
        planes, qy, qc, mesh=mesh)]}
    for name, kw in MODES.items():
        extra = dict(qy_b=jnp.asarray(QYB), qc_b=jnp.asarray(QCB)) \
            if kw.get("bframes") else {}
        out[name] = [np.asarray(a) for a in fvc_chunks_sharded(
            planes, qy, qc, mesh, search_range=R, **kw, **extra)]
    return out


def test_encode_chunks_equal_flutpus_sharded(flutpu_refs):
    """K1 over the C x F frames (its plain version here) against
    ``encode_chunks_sharded``: equal but for ±1 on rounding ties (none
    here), in (C, F, BH, BW, 64) layout; interleaved and planar input
    alike, and ``encode_chunks_single`` over any leading shape."""
    got = encode_chunks(_t(CLIP), _t(QY), _t(QC))
    planar = encode_chunks(tuple(_t(CLIP[..., c]) for c in range(3)),
                           _t(QY), _t(QC), mesh=make_chunk_mesh(1, ["cpu"]))
    single = encode_chunks_single(_t(CLIP), _t(QY), _t(QC))
    for a, b, c_, want in zip(got, planar, single, flutpu_refs["jpeg"]):
        assert a.shape == want.shape and a.dtype == torch.int16
        assert torch.equal(a, b) and torch.equal(a, c_)
        assert tie_contract(a.numpy(), want, 1e-4) == 0.0


@pytest.mark.parametrize("mode", list(MODES))
def test_fvc_chunks_equal_flutpus_sharded(flutpu_refs, mode):
    """``fvc_chunks`` against ``fvc_chunks_sharded`` for v1, P with the
    full and the hier search, B frames, and half-pel P (full and hier):
    the same tuples (residuals, vectors, B modes, frame types), equal
    value for value; the static chunk is P throughout, the cut chunk
    turns intra at the noise."""
    kw = MODES[mode]
    qy, qc, extra = _port_tables(kw)
    got = fvc_chunks(_t(CLIP), qy, qc, search_range=R, **kw, **extra)
    want = flutpu_refs[mode]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    if mode in ("full", "hier", "subpel", "hier-subpel"):
        itypes = got[4].numpy()
        assert itypes[1].tolist() == [1, 0, 0] and itypes[2, 2] == 1


@pytest.mark.parametrize("mode", ["full", "hier", "B", "subpel"])
def test_fvc_chunks_batch_equals_single_chunks(mode):
    """C chunks in one call equal the same chunks one at a time (C = 1
    through the same code): decisions and modes are per chunk."""
    kw = MODES[mode]
    qy, qc, extra = _port_tables(kw)
    batch = fvc_chunks(_t(CLIP), qy, qc, search_range=R, **kw, **extra)
    for k in range(C):
        one = fvc_chunks(_t(CLIP[k:k + 1]), qy, qc, search_range=R, **kw,
                         **extra)
        for a, b in zip(batch, one):
            assert torch.equal(a[k], b[0])


PLAIN = {"K3": lambda c, p: M.motion_search_mc_plain(c, p, 7),
         "K5": lambda c, p: M.motion_search_mc_hier_plain(c, p, 7),
         "K6a-8": lambda c, p: M.motion_search_mc_blocks_plain(c, p, 3, 8),
         "K6b": lambda c, p: M.motion_search_mc_dygrid_plain(c, p, 7)}


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_searches_take_a_chunk_axis(name):
    """The plain versions with a chunk axis (the kernels' references on
    the card) equal a loop of single-plane calls on unlike chunks; the
    wrappers take them for CPU tensors."""
    cur, prev = (_t(a) for a in chunk_pairs(5, 32, 48, seed=3))
    mv, pred = PLAIN[name](cur, prev)
    assert mv.shape[0] == pred.shape[0] == 5
    for k in range(5):
        one_mv, one_pred = PLAIN[name](cur[k], prev[k])
        assert torch.equal(mv[k], one_mv) and torch.equal(pred[k], one_pred)
    assert all(torch.equal(a, b) for a, b in zip(
        M.motion_search_mc(cur, prev, 7), PLAIN["K3"](cur, prev)))


def test_plain_chroma_takes_a_chunk_axis():
    rng = np.random.default_rng(4)
    cb, cr = (_t(rng.normal(128, 30, (3, 24, 40)).astype(np.float32))
              for _ in range(2))
    mv = _t(rng.integers(-7, 8, (3, 3, 5, 2)).astype(np.int32))
    got = M.chroma_mc_plain(cb, cr, mv, 7)
    for k in range(3):
        for a, b in zip(M.chroma_mc_plain(cb[k], cr[k], mv[k], 7), got):
            assert torch.equal(a, b[k])
    with pytest.raises(ValueError):
        M.chroma_mc_plain(cb, cr, mv[0], 7)


def test_what_is_not_ported_raises():
    """What flutpu refuses, the port refuses with flutpu's ValueErrors:
    the hier search and half-pel with stripes, a mesh whose chunk shards
    do not divide C, a spatial mesh short of devices, half-pel with B
    frames, motion with 4:4:4; nothing falls back."""
    two = make_chunk_mesh(2, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="split evenly"):
        encode_chunks(_t(CLIP[:3]), _t(QY), _t(QC), mesh=two)
    with pytest.raises(ValueError, match="split evenly"):
        fvc_chunks(_t(CLIP[:3]), _t(QY), _t(QC), mesh=two, motion=True)
    grid = ChunkSpatialMesh(2, 2, ["cpu"] * 4)
    for kw in (dict(hier=True), dict(subpel=True),
               dict(hier=True, bframes=1)):
        with pytest.raises(ValueError, match="full-search integer-pel"):
            fvc_chunks(_t(CLIP), _t(QY), _t(QC), mesh=grid, motion=True,
                       spatial=True, **kw)
    with pytest.raises(ValueError, match="subpel"):
        fvc_chunks(_t(CLIP), _t(QY), _t(QC), motion=True, subpel=True,
                   bframes=1)
    with pytest.raises(ValueError, match="4:2:0"):
        fvc_chunks(_t(CLIP), _t(QY), _t(QC), motion=True, subsample=False)
    with pytest.raises(ValueError, match="need 4 devices"):
        make_chunk_spatial_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        fvc_chunks(_t(CLIP), _t(QY), _t(QC), bframes=1)
    with pytest.raises(ValueError):
        encode_chunks(_t(CLIP[0]), _t(QY), _t(QC))


def test_chunk_mesh():
    mesh = make_chunk_mesh(1, ["cpu", "cuda:0"])
    assert isinstance(mesh, ChunkMesh) and mesh.axis_names == ("chunk",)
    assert mesh.size == 1 and mesh.single_device() == torch.device("cpu")
    with pytest.raises(ValueError):
        make_chunk_mesh(3, ["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            make_chunk_mesh()      # no visible card: no chunk axis


def test_chunk_assignment_and_stitch_are_flutpus():
    """Copies: the same code as flutpu's, and the same answers."""
    for name in ("ChunkAssignment", "stitch_order"):
        assert inspect.getsource(getattr(t_multihost, name)) == \
            inspect.getsource(getattr(j_multihost, name))
    for p, n, c in ((0, 4, 16), (2, 4, 16), (1, 2, 8), (0, 1, 5)):
        a, b = (m.ChunkAssignment(p, n, c) for m in (t_multihost,
                                                     j_multihost))
        assert a.local_chunks() == b.local_chunks()
        assert [a.owner_of(k) for k in range(c)] == \
            [b.owner_of(k) for k in range(c)]
    pieces = [(2, b"C"), (0, b"A"), (1, b"B")]
    assert t_multihost.stitch_order(pieces) == \
        j_multihost.stitch_order(pieces) == b"ABC"


def test_single_process_initialize_and_assignment():
    t_multihost.initialize()            # a no-op in one process
    a = t_multihost.assignment(8)
    assert (a.process_id, a.num_processes, a.local_chunks()) == \
        (0, 1, list(range(8)))
    assert t_multihost.assignment().chunks_per_batch == max(
        1, torch.cuda.device_count())


# -- several shards and row stripes ------------------------------------------

def _moving(c=2, f=3, h=64, w=32):
    """flutpu's striped clip (``test_parallel.py``'s ``_moving``): C
    chunks of a moving ball at 64 x 32."""
    return np.stack([np.stack([make_test_frame("ball", w, h, ci * 7 + i)
                               for i in range(f)]) for ci in range(c)])


STRIPED = {"v1": (dict(), 2), "P": (dict(motion=True), 3),
           "B": (dict(motion=True, bframes=1), 4)}


@pytest.mark.parametrize("mode", list(STRIPED))
def test_striped_fvc_chunks_equal_flutpus_sharded(mode):
    """``fvc_chunks(spatial=True)`` on a ``ChunkSpatialMesh(2, 4)`` of
    "cpu" = ``fvc_chunks_sharded(spatial=True)`` on flutpu's 2 x 4 mesh of
    CPU devices (stripes of 16 rows, r = 3, halos across every stripe
    edge), and = the port's unstriped one-shard call, field for field."""
    kw, f = STRIPED[mode]
    frames = _moving(f=f)
    want = fvc_chunks_sharded(jnp.asarray(frames), jnp.asarray(QY),
                              jnp.asarray(QC), j_make_chunk_spatial_mesh(2, 4),
                              search_range=R, spatial=True, **kw)
    got = fvc_chunks(_t(frames), _t(QY), _t(QC),
                     mesh=ChunkSpatialMesh(2, 4, ["cpu"] * 8),
                     search_range=R, spatial=True, **kw)
    one = fvc_chunks(_t(frames), _t(QY), _t(QC), search_range=R, **kw)
    assert len(got) == len(want) == len(one)
    for a, b, c_ in zip(got, want, one):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c_)


def test_striped_encode_chunks_equal_flutpus_sharded():
    """K1 per stripe (no halo) on a ``ChunkSpatialMesh(2, 4)`` = flutpu's
    striped ``encode_chunks_sharded`` and the unstriped call."""
    frames = _moving()
    want = encode_chunks_sharded(
        tuple(jnp.asarray(np.ascontiguousarray(frames[..., c]))
              for c in range(3)), jnp.asarray(QY), jnp.asarray(QC),
        mesh=j_make_chunk_spatial_mesh(2, 4), spatial=True)
    got = encode_chunks(_t(frames), _t(QY), _t(QC),
                        mesh=ChunkSpatialMesh(2, 4, ["cpu"] * 8),
                        spatial=True)
    one = encode_chunks(_t(frames), _t(QY), _t(QC))
    for a, b, c_ in zip(got, want, one):
        assert tie_contract(a.numpy(), np.asarray(b), 1e-4) == 0.0
        assert torch.equal(a, c_)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode", ["v1", "full", "B"])
def test_several_shards_equal_one(shards, mode):
    """Meshes of 2 and 4 "cpu" shards: each shard's block of C / M chunks
    is its own dispatch, and the outputs in chunk order equal one
    shard's; ``encode_chunks`` likewise."""
    kw = MODES[mode]
    qy, qc, extra = _port_tables(kw)
    mesh = make_chunk_mesh(shards, ["cpu"] * shards)
    got = fvc_chunks(_t(CLIP), qy, qc, mesh=mesh, search_range=R, **kw,
                     **extra)
    one = fvc_chunks(_t(CLIP), qy, qc, search_range=R, **kw, **extra)
    assert all(torch.equal(a, b) for a, b in zip(got, one))
    assert all(torch.equal(a, b) for a, b in zip(
        encode_chunks(_t(CLIP), qy, qc, mesh=mesh),
        encode_chunks(_t(CLIP), qy, qc)))


def test_spatial_mesh_layout_and_dealing():
    """A (chunk, spatial) grid filled row by row from the device list,
    its shards' stripe devices, and slots dealt round the cards in
    order (slot k on device k mod n)."""
    grid = make_chunk_spatial_mesh(2, 3, ["cpu"] * 7)
    assert grid.axis_names == ("chunk", "spatial")
    assert grid.shape == (2, 3) and grid.size == 2 and grid.spatial == 3
    assert all(len(s) == 3 for s in grid.shards())
    assert grid.single_device() == torch.device("cpu")
    assert deal_devices(5, ["cuda:0", "cuda:1"]) == tuple(
        torch.device(d) for d in ("cuda:0", "cuda:1", "cuda:0", "cuda:1",
                                  "cuda:0"))
    assert make_chunk_mesh(2, ["cpu", "cuda:0"]).shards() == (
        (torch.device("cpu"),), (torch.device("cuda:0"),))
    with pytest.raises(ValueError):
        make_chunk_mesh(2, ["cpu", "cuda:0"]).single_device()
    with pytest.raises(ValueError):
        deal_devices(2, [])
