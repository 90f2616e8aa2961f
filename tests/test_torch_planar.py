"""The planar in-loop formulation (FVC header flags bit 3): flutpu_torch
against flutpu on the CPU.

Contract: ``plane_dct_planar`` / ``plane_idct_planar`` lie within 1e-3 of
flutpu's (and of the per-block DCT), ``quantize_planar`` /
``dequantize_planar`` equal flutpu's; ``fvc_mc_encode_chunk(planar=True)``
and ``fvc_mc_encode_chunk_b(planar=True)`` give flutpu's outputs but
where a coefficient splits at a float64-verified tie
(``torch_helpers.split_at_ties``); an ``FvcEncoder`` with ``planar =
True`` writes flags bit 3 and flutpu's bytes; either package's planar
chunk decodes in the other's ``FvcDecoder`` within one level of its own
decoder; the port's decoder reconstructs exactly the encoder's in-loop
planes (no drift), within 0.1 dB of the per-block chunk's PSNR."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec import fvc as jf
from flutpu.codec.ops import dct as j_dct
from flutpu.codec.ops import quant as j_quant
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec import fvc as tf
from flutpu_torch.codec.decode import decode_scan_to_coefs
from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.ops import dct as t_dct
from flutpu_torch.codec.ops import quant as t_quant
from flutpu_torch.parallel.gop import fvc_chunks
from flutpu_torch.parallel.mesh import ChunkSpatialMesh
from torch_helpers import planar_drift, split_at_ties

torch.set_num_threads(1)

H, W = 96, 160


def _clip(pattern, n=8, h=H, w=W):
    return np.stack([make_test_frame(pattern, w, h, i) for i in range(n)])


CLIPS = {"ball": _clip("ball"),
         "cut": np.concatenate([_clip("ball", 4), _clip("noise", 4)])}


def _psnr(rgb, frames):
    mse = ((rgb.astype(np.float64) - frames) ** 2).mean(axis=(1, 2, 3))
    return 10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))


def _planar_pair(**kw):
    """flutpu's planar encoder and the port's built from its state."""
    je = jf.FvcEncoder(85, motion=True, **kw)
    je.planar = True
    te = FvcEncoder.from_numpy_state(
        je.qy, je.qc, je.search_range, motion=True, hier=je.hier,
        subpel=je.subpel, bframes=je.bframes, bquality=je.bquality,
        device="cpu")
    te.planar = True
    return je, te


# -- the planar ops ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 24), (2, 96, 160), (3, 1, 40, 8)])
def test_planar_transforms_match_flutpus(shape):
    rng = np.random.default_rng(7)
    x = rng.uniform(-255, 255, shape).astype(np.float32)
    coefs = t_dct.plane_dct_planar(torch.from_numpy(x))
    assert coefs.dtype == torch.float32 and coefs.shape == shape
    np.testing.assert_allclose(
        coefs.numpy(), np.asarray(j_dct.plane_dct_planar(jnp.asarray(x))),
        rtol=0, atol=1e-3)
    # the same coefficients as the per-block DCT, in plane layout
    np.testing.assert_allclose(
        coefs.numpy(),
        t_dct.unblockize(t_dct.plane_dct(torch.from_numpy(x))).numpy(),
        rtol=0, atol=1e-3)
    back = t_dct.plane_idct_planar(coefs)
    np.testing.assert_allclose(
        back.numpy(),
        np.asarray(j_dct.plane_idct_planar(jnp.asarray(coefs.numpy()))),
        rtol=0, atol=1e-3)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-3)


def test_planar_quantizers_equal_flutpus():
    rng = np.random.default_rng(8)
    x = rng.uniform(-900, 900, (2, 32, 48)).astype(np.float32)
    q = j_quant.scale_qtable(j_quant.LUMA_QTABLE, 60)
    got = t_quant.quantize_planar(torch.from_numpy(x), torch.from_numpy(q))
    assert got.dtype == torch.int32
    want = np.asarray(j_quant.quantize_planar(jnp.asarray(x), jnp.asarray(q)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_quant.dequantize_planar(got, torch.from_numpy(q)).numpy(),
        np.asarray(j_quant.dequantize_planar(jnp.asarray(want),
                                             jnp.asarray(q))))


def test_block_diagonal_matrix_is_cached_per_device():
    """The planar products' DCT is uploaded once per device and is the
    diagonal block of flutpu's block-diagonal matrix."""
    a = t_dct._dct_on(torch.device("cpu"))
    assert a is t_dct._dct_on(torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(),
                                  j_dct._bd_dct_matrix(96)[8:16, 8:16])


@pytest.mark.parametrize("op", ["plane_dct_planar", "plane_idct_planar"])
def test_planar_products_do_not_depend_on_height_or_batch(op):
    """A row stripe's products are the whole plane's rows bit for bit, and
    a plane's are the same alone and in a batch: the decoder rebuilds an
    encoder that ran on stripes or on several chunks at once."""
    fn = getattr(t_dct, op)
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -300, 300, (3, 96, 160)).astype(np.float32))
    whole = fn(x)
    for rows in (slice(0, 32), slice(32, 48), slice(48, 96)):
        assert torch.equal(fn(x[:, rows]), whole[:, rows])
    assert torch.equal(fn(x[1]), whole[1])


# -- the chunk programs ---------------------------------------------------------

@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("kw", [{}, {"hier": True}, {"subpel": True},
                                {"search_range": 3}],
                         ids=["full", "hier", "half-pel", "r3"])
def test_planar_program_matches_flutpus(kw, clip):
    frames = CLIPS[clip]
    je, te = _planar_pair(**kw)
    r = je.search_range
    want = jf.fvc_mc_encode_chunk(
        jnp.asarray(frames), je._qy_dev, je._qc_dev, pad_h=H, pad_w=W,
        search_range=r, hier=je.hier, subpel=je.subpel, planar=True)
    qy, qc = te.scans.qy_dev, te.scans.qc_dev
    got = tf.fvc_mc_encode_chunk(torch.from_numpy(frames), qy, qc, H, W, r,
                                 hier=te.hier, subpel=te.subpel, planar=True)
    split_at_ties(frames, [g.numpy() for g in got],
                  [np.asarray(w_) for w_ in want], je.qy, je.qc,
                  subpel=je.subpel)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("hier,bframes", [(False, 1), (True, 1), (False, 2)])
def test_planar_b_program_matches_flutpus(hier, bframes, clip):
    frames = CLIPS[clip]
    je, te = _planar_pair(hier=hier, bframes=bframes)
    want = jf.fvc_mc_encode_chunk_b(
        jnp.asarray(frames), je._qy_dev, je._qc_dev, pad_h=H, pad_w=W,
        search_range=je.search_range, bframes=bframes, hier=hier,
        planar=True, qy_b=je._qyb_dev, qc_b=je._qcb_dev)
    got = tf.fvc_mc_encode_chunk_b(
        torch.from_numpy(frames), te.scans.qy_dev,
        te.scans.qc_dev, H, W, je.search_range, bframes, hier=hier,
        planar=True, qy_b=te._qyb_dev, qc_b=te._qcb_dev)
    split_at_ties(frames, [g.numpy() for g in got],
                  [np.asarray(w_) for w_ in want], je.qy, je.qc,
                  bframes=bframes, qy_b=np.asarray(je._qyb_dev),
                  qc_b=np.asarray(je._qcb_dev))


def test_per_block_stays_the_default():
    """``planar`` None or False is the per-block formulation (flags bit 3
    clear) on every device; the encoder's attribute defaults to False."""
    frames = torch.from_numpy(CLIPS["ball"][:3])
    q = torch.from_numpy(j_quant.scale_qtable(j_quant.LUMA_QTABLE, 85))
    a = tf.fvc_mc_encode_chunk(frames, q, q, H, W, 7)
    b = tf.fvc_mc_encode_chunk(frames, q, q, H, W, 7, planar=None)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    enc = FvcEncoder(85, motion=True, device="cpu")
    assert enc.planar is False and FvcEncoder.planar is False
    assert not enc.encode_chunk(CLIPS["ball"][:3])[5] & 8


# -- chunks and their decoders --------------------------------------------------

#: header flags of a planar chunk: 4:2:0 | zlib'd vectors | planar, and
#: half-pel (bit 2) or B frames (bit 5)
FLAGS = {"P": 0x0b, "hier": 0x0b, "half-pel": 0x0f, "B": 0x2b}
CONFIGS = {"P": {}, "hier": {"hier": True}, "half-pel": {"subpel": True},
           "B": {"bframes": 1}}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_planar_chunk_equals_flutpus(config, engine):
    """flags bit 3 and flutpu's bytes on the ball clip, on either engine;
    half-pel splits there at the near-tie of one vector of frame 2 that
    the per-block chunk has too (``test_torch_fvc.py``), and
    ``split_at_ties`` holds."""
    je, te = _planar_pair(**CONFIGS[config])
    te.scans.engine = engine
    frames = CLIPS["ball"]
    got = te.encode_chunk(frames)
    assert got[5] == FLAGS[config]
    assert (got == je.encode_chunk(frames)) == (config != "half-pel")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_planar_chunks_decode_in_either_package(config):
    """A port planar chunk through flutpu's decoder and a flutpu planar
    chunk through the port's: within one RGB level of the writer's own
    decoder, the same frame types."""
    je, te = _planar_pair(**CONFIGS[config])
    frames = CLIPS["cut"]
    t_dec, j_dec = FvcDecoder(device="cpu"), jf.FvcDecoder()
    for chunk in (te.encode_chunk(frames), je.encode_chunk(frames)):
        assert chunk[5] & 8
        (a, ia), (b, ib) = t_dec.decode_chunk(chunk), j_dec.decode_chunk(chunk)
        assert ia["types"] == ib["types"]
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def _tables():
    return [torch.from_numpy(j_quant.scale_qtable(t, 85))
            for t in (j_quant.LUMA_QTABLE, j_quant.CHROMA_QTABLE)]


@pytest.mark.parametrize("kw", [{}, {"subpel": True}],
                         ids=["full", "half-pel"])
def test_planar_decoder_has_no_drift(kw):
    """The port's decoder rebuilds the encoder's in-loop planes exactly,
    frame by frame, through the planar inverse."""
    assert planar_drift(torch.from_numpy(CLIPS["cut"]), *_tables(),
                        **kw) == 0


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("stripes", [2, 3])
def test_planar_stripes_decode_without_drift(stripes, clip):
    """A planar chunk coded on row stripes (stripe-height block-diagonal
    products) is rebuilt exactly by the decoder's full-height products,
    every frame: each coefficient's eight terms meet in the same order,
    the other terms being exact zeros."""
    assert planar_drift(torch.from_numpy(CLIPS[clip]), *_tables(),
                        stripes) == 0


def test_striped_planar_chunk_carries_the_striped_loop():
    """The chunk ``FvcEncoder`` writes on ChunkSpatialMesh(1, 2) with
    ``planar``: flags bit 3, and the striped loop's coefficients, vectors
    and frame types, whose in-loop planes the decoder rebuilds exactly
    (``test_planar_stripes_decode_without_drift``)."""
    frames = CLIPS["cut"]
    enc = FvcEncoder(85, motion=True, device="cpu")
    enc.planar = True
    mesh = ChunkSpatialMesh(1, 2, ["cpu"] * 2)
    chunk = enc.encode_chunks_finalize(enc.encode_chunks_dispatch(
        frames[None], mesh=mesh))[0]
    assert chunk[5] == 0x0b
    ry, rcb, rcr, mvs, itypes = (p[0].numpy() for p in fvc_chunks(
        torch.from_numpy(frames)[None], *_tables(), mesh=mesh, spatial=True,
        motion=True, planar=True))
    _, recs = FvcDecoder.parse_chunk(chunk)
    coefs = [np.stack(c) for c in zip(*(decode_scan_to_coefs(
        p, W // 8, H // 8, W // 16, H // 16, True) for _, _, p in recs))]
    for got, want in zip(coefs, (ry, rcb, rcr)):
        np.testing.assert_array_equal(got, want)
    for i, (ftype, mv, _) in enumerate(recs):
        assert (ftype == 0) == (i == 0 or itypes[i] == 1)
        if ftype:
            np.testing.assert_array_equal(mv, mvs[i])


def test_planar_quality_is_the_per_block_quality():
    frames = CLIPS["cut"]
    je, te = _planar_pair()
    flat = FvcEncoder(85, motion=True, device="cpu")
    dec = FvcDecoder(device="cpu")
    p_planar = _psnr(dec.decode_chunk(te.encode_chunk(frames))[0], frames)
    p_block = _psnr(dec.decode_chunk(flat.encode_chunk(frames))[0], frames)
    assert np.abs(p_planar - p_block).max() <= 0.1


def test_planar_composes_with_stripes():
    """Two row stripes of one chunk, planar: the stripes' records equal
    the unstriped planar encode's (or split at a float64-verified tie)."""
    frames = torch.from_numpy(CLIPS["ball"][:6])[None]
    q = [torch.from_numpy(j_quant.scale_qtable(t, 85))
         for t in (j_quant.LUMA_QTABLE, j_quant.CHROMA_QTABLE)]
    mesh = ChunkSpatialMesh(1, 2, ["cpu"] * 2)
    got = fvc_chunks(frames, *q, mesh=mesh, spatial=True, motion=True,
                     planar=True)
    want = fvc_chunks(frames, *q, motion=True, planar=True)
    split_at_ties(frames[0].numpy(), [g[0].numpy() for g in got],
                  [w_[0].numpy() for w_ in want], *q)
