"""FVC B frames and the hierarchical search: flutpu_torch's chunk codec
against flutpu's on the CPU.

Contract: for the same frames and tables, the port's motion chunks
(``device="cpu"``, the kernels' plain versions) equal flutpu's
``FvcEncoder(85, motion=True, hier=..., bframes=...)`` byte for byte at
q85 ±7 for (hier, bframes) = (True, 0), (True, 1) and (False, 1), on the
160x96 ball clip and the ball→noise cut clip of ``test_torch_fvc.py``,
through ``encode_chunk``, dispatch/finalize with two chunks in flight,
an overflow redispatch and the ``cudafvcenc`` element. At bframes = 2 a
quantization tie splits the streams: anchor frame 3 is predicted from
frame 0, and at luma block (10, 15) of the ball clip its DC lands at
exactly 127.5 quantization steps in the port's per-block DCT, a hair
below in XLA's einsum; the tie contract of ``_tie_contract_b`` holds
there. Each package's decoder reads the other's B chunks: the frames
equal each package's decode of its own chunk where the chunks are equal,
and the two decoders agree within one RGB level (exactly on the ball
clip), with the same frame types (2 = B)."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flutpu.core
import flutpu_torch.core
from flutpu.codec import fvc as jf
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec import fvc as tf
from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
from torch_helpers import pull_all

torch.set_num_threads(1)

W, H = 160, 96


def _clip(pattern, n=8, start=0, w=W, h=H):
    return np.stack([make_test_frame(pattern, w, h, i)
                     for i in range(start, start + n)])


CLIPS = {"ball": _clip("ball"),
         "cut": np.concatenate([_clip("ball", 4), _clip("noise", 4, 4)])}
CONFIGS = [(True, 0), (True, 1), (False, 1), (False, 2)]
#: (hier, bframes) whose chunks break byte identity at a rounding tie
TIES = {(False, 2)}
CASES = [(c, n) for c in CONFIGS for n in CLIPS]


def _jax(hier, bframes, **kw):
    return jf.FvcEncoder(85, motion=True, hier=hier, bframes=bframes, **kw)


def _port(je, **state):
    return FvcEncoder.from_numpy_state(
        je.qy, je.qc, je.search_range, motion=True, hier=je.hier,
        bframes=je.bframes, bquality=je.bquality, device="cpu", **state)


@pytest.fixture(scope="module")
def chunks():
    """flutpu's and the port's chunk for every (config, clip), encoded
    once."""
    out = {}
    for hier, bframes in CONFIGS:
        je = _jax(hier, bframes)
        te = _port(je)
        for name, frames in CLIPS.items():
            out[(hier, bframes), name] = (je.encode_chunk(frames),
                                          te.encode_chunk(frames))
    return out


def _psnr(rgb, frames):
    mse = ((rgb.astype(np.float64) - frames) ** 2).mean(axis=(1, 2, 3))
    return 10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))


def _tie_contract_b(frames, je, te):
    """Where a rounding tie splits the streams: the same frame types,
    vectors and B modes; residual coefficients within ±1 on at most 1e-4
    of them; flutpu's decoder reads the port's chunk within 0.05 dB of
    flutpu's own chunk."""
    kw = dict(search_range=je.search_range, bframes=je.bframes)
    j_parts = jf.fvc_mc_encode_chunk_b(
        jnp.asarray(frames), je._qy_dev, je._qc_dev, pad_h=H, pad_w=W,
        hier=je.hier, planar=False, qy_b=je._qyb_dev, qc_b=je._qcb_dev, **kw)
    t_parts = tf.fvc_mc_encode_chunk_b(
        torch.from_numpy(frames), te.scans.qy_dev,
        te.scans.qc_dev, H, W, hier=te.hier, qy_b=te._qyb_dev,
        qc_b=te._qcb_dev, **kw)
    j_parts = [np.asarray(p) for p in j_parts]
    t_parts = [p.numpy() for p in t_parts]
    for a, b in zip(t_parts[3:], j_parts[3:]):   # fwd, bwd, modes, types
        np.testing.assert_array_equal(a, b)
    d = np.concatenate([np.abs(a.astype(np.int32) - b.astype(np.int32))
                        .ravel() for a, b in zip(t_parts[:3], j_parts[:3])])
    assert d.max() <= 1 and 0 < (d > 0).mean() <= 1e-4
    dec = jf.FvcDecoder()
    p_port, p_jax = (_psnr(dec.decode_chunk(c)[0], frames)
                     for c in (te.encode_chunk(frames),
                               je.encode_chunk(frames)))
    assert np.abs(p_port - p_jax).max() <= 0.05


@pytest.mark.parametrize("config,clip", CASES)
def test_chunk_byte_identical(chunks, config, clip):
    want, got = chunks[config, clip]
    if config in TIES:
        assert got != want
        je = _jax(*config)
        _tie_contract_b(CLIPS[clip], je, _port(je))
    else:
        assert got == want


@pytest.mark.parametrize("config", [(True, 1), (False, 1), (True, 0)])
def test_chunk_without_segments_byte_identical(chunks, config):
    """``segmented=False`` (the per-block pack) with hier and B frames."""
    je = _jax(*config)
    want, _ = chunks[config, "ball"]
    assert _port(je, segmented=False).encode_chunk(CLIPS["ball"]) == want


def test_bframes_2_tie_is_a_half_step():
    """The tie at bframes = 2: in the port's pipeline the DC of anchor
    frame 3's luma residual at block (10, 15) is 127.5 steps exactly, and
    rounds half to even (128); flutpu's chunk carries 127."""
    je = _jax(False, 2)
    te = _port(je)
    frames = CLIPS["ball"]
    y, cb, cr = tf._i420_planes(torch.from_numpy(frames), H, W)
    qy = te.scans.qy_dev
    anchors = [0, 3, 6, 7]
    (stripe,), itypes, recs = tf._anchor_loop(
        [y[None, anchors]], [cb[None, anchors]], [cr[None, anchors]], qy,
        te.scans.qc_dev, tf._search_fn(False), 7)
    mv = stripe[3]
    assert itypes.tolist() == [[1, 0, 0, 0]] and (mv[0, 1, 5, 7] == 0).all()
    resid = (y[3] - recs[0][0][0][0])[80:88, 120:128].double()
    assert float(resid.sum() / 8 / float(qy[0, 0])) == 127.5
    j_ry = np.asarray(jf.fvc_mc_encode_chunk_b(
        jnp.asarray(frames), je._qy_dev, je._qc_dev, pad_h=H, pad_w=W,
        bframes=2, planar=False, qy_b=je._qyb_dev, qc_b=je._qcb_dev)[0])
    t_ry = tf.fvc_mc_encode_chunk_b(
        torch.from_numpy(frames), qy, te.scans.qc_dev, H, W,
        bframes=2, qy_b=te._qyb_dev, qc_b=te._qcb_dev)[0].numpy()
    assert (j_ry[3, 10, 15, 0], t_ry[3, 10, 15, 0]) == (127, 128)


@pytest.mark.parametrize("hier", [False, True])
def test_explicit_bquality_byte_identical(hier):
    je = _jax(hier, 1, bquality=60)
    got = _port(je).encode_chunk(CLIPS["cut"])
    assert got == je.encode_chunk(CLIPS["cut"])
    assert got[5] & 32 and got[13] == 60


def test_b_chunk_program_matches_jax():
    """The B program's parts: residual coefficients, fwd and bwd vectors,
    modes and frame types equal flutpu's fvc_mc_encode_chunk_b
    (planar=False), all in display order."""
    je = _jax(True, 1)
    te = _port(je)
    frames = CLIPS["cut"]
    want = jf.fvc_mc_encode_chunk_b(
        jnp.asarray(frames), je._qy_dev, je._qc_dev, pad_h=H, pad_w=W,
        search_range=7, bframes=1, hier=True, planar=False,
        qy_b=je._qyb_dev, qc_b=je._qcb_dev)
    got = tf.fvc_mc_encode_chunk_b(
        torch.from_numpy(frames), te.scans.qy_dev,
        te.scans.qc_dev, H, W, 7, 1, True, qy_b=te._qyb_dev,
        qc_b=te._qcb_dev)
    for g, w_ in zip(got, want):
        assert g.dtype == {np.int16: torch.int16, np.int8: torch.int8}[
            np.asarray(w_).dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[6].tolist() == [1, 2, 0, 2, 1, 2, 1, 1]
    assert (got[4][[0, 2, 4, 6, 7]] == 0).all()      # anchors: no bwd
    assert (got[5][[0, 2, 4, 6, 7]] == 0).all()      # anchors: no modes


@pytest.mark.parametrize("config,clip", CASES)
def test_decoders_read_each_others_b_chunks(chunks, config, clip):
    want, got = chunks[config, clip]
    j_dec, t_dec = jf.FvcDecoder(), FvcDecoder(device="cpu")
    j_own, j_info = j_dec.decode_chunk(want)
    t_own, t_info = t_dec.decode_chunk(got)
    assert t_info == j_info and (2 in t_info["types"]) == (config[1] > 0)
    j_other = j_dec.decode_chunk(got)[0]
    t_other = t_dec.decode_chunk(want)[0]
    if config not in TIES:
        np.testing.assert_array_equal(j_other, j_own)
        np.testing.assert_array_equal(t_other, t_own)
    d = np.abs(t_other.astype(np.int32) - j_own.astype(np.int32))
    assert d.max() <= (0 if clip == "ball" else 1)


def test_b_types_and_vectors_parse(chunks):
    """B records carry fwd | bwd | modes (5 bytes per macroblock), P
    anchors their fwd vectors, I frames nothing; the header's bquality
    follows the search range."""
    hdr, frames = FvcDecoder.parse_chunk(chunks[(True, 1), "ball"][1])
    assert (hdr["flags"], hdr["search_range"], hdr["bquality"]) == (
        1 | 2 | 32, 7, 77)
    assert [t for t, _, _ in frames] == [0, 2, 1, 2, 1, 2, 1, 1]
    for t, mv, _ in frames:
        if t == 2:
            fwd, bwd, modes = mv
            assert fwd.shape == bwd.shape == (6, 10, 2)
            assert modes.shape == (6, 10) and modes.max() <= 3
            assert (fwd[(modes == 2) | (modes == 3)] == 0).all()
            assert (bwd[(modes == 1) | (modes == 3)] == 0).all()
        else:
            assert (mv is None) == (t == 0)


def _mv_bytes(ftype, mv) -> bytes:
    """A frame record's zlib'd motion block (empty for an intra frame)."""
    if mv is None:
        return b""
    parts = mv if ftype == 2 else (mv,)
    return zlib.compress(b"".join(np.asarray(m).tobytes() for m in parts), 6)


def _rebuild(data, edit):
    """The chunk ``data`` with its frame records passed through
    ``edit(i, ftype, mv_bytes, payload) -> (ftype, mv_bytes, payload)``."""
    hdr, frames = FvcDecoder.parse_chunk(data)
    off = 14 if hdr["flags"] & 32 else 13
    out = [data[:off]]
    for i, (t, mv, payload) in enumerate(frames):
        t, raw, payload = edit(i, t, _mv_bytes(t, mv), payload)
        out += [struct.pack(">BHI", t, len(raw), len(payload)), raw, payload]
    return b"".join(out)


@pytest.mark.parametrize("fault", ["trailing-b", "no-motion-block",
                                   "subpel-with-b"])
def test_decoder_errors_match_flutpu(chunks, fault):
    data = chunks[(False, 1), "ball"][1]
    if fault == "trailing-b":      # the last frame a B frame: no next anchor
        b_mv, b_payload = next((mv, p) for t, mv, p in
                               FvcDecoder.parse_chunk(data)[1] if t == 2)
        data = _rebuild(data, lambda i, t, raw, p: (
            (2, _mv_bytes(2, b_mv), b_payload) if i == 7 else (t, raw, p)))
    elif fault == "no-motion-block":
        data = _rebuild(data, lambda i, t, raw, p:
                        (t, b"" if t == 2 else raw, p))
    else:
        data = bytearray(data)
        data[5] |= 4
        data = bytes(data)
    errors = []
    for dec in (jf.FvcDecoder(), FvcDecoder(device="cpu")):
        with pytest.raises(ValueError) as e:
            dec.decode_chunk(data)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert {"trailing-b": "surrounding", "no-motion-block": "without motion",
            "subpel-with-b": "subpel"}[fault] in errors[0]


@pytest.mark.parametrize("kwargs", [
    {"motion": False, "bframes": 1}, {"bframes": 8}, {"bframes": -1},
    {"bframes": 1, "bquality": 0}, {"bframes": 1, "bquality": 101},
    {"bframes": 1, "subpel": True}])
def test_validation_errors_match_flutpu(kwargs):
    kw = {"motion": True, **kwargs}
    with pytest.raises(ValueError) as want:
        jf.FvcEncoder(85, **kw)
    with pytest.raises(ValueError) as got:
        FvcEncoder(85, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_default_bquality():
    for q, bq in ((85, 77), (30, 22), (15, 10)):
        assert FvcEncoder(q, motion=True, bframes=1,
                          device="cpu").bquality == bq == \
            jf.FvcEncoder(q, motion=True, bframes=1).bquality


def test_dispatch_src_two_in_flight_and_redispatch(chunks):
    """Hier + B through the on-device source (both encoders read the
    port's planes) with two chunks in flight, the second finalized after
    an overflow redispatch of a tiny segment capacity."""
    je = _jax(True, 1)
    te = _port(je, seg_words=2)
    h = 88
    t_src = lambda ph, pw, n, s: gradient_ball_planes(  # noqa: E731
        ph, pw, n, s, device="cpu")
    planes = tuple(jnp.asarray(p.numpy()) for p in t_src(96, W, 8, 8))
    want = je.encode_chunk_finalize(je.encode_chunk_dispatch_src(
        lambda ph, pw, n, s: planes, jnp.float32(8), 8, h, W))
    first = te.encode_chunk_dispatch_src(t_src, 8, 8, h, W)
    second = te.encode_chunk_dispatch(CLIPS["cut"])
    assert te.encode_chunk_finalize(first) == want
    assert te.encode_chunk_finalize(second) == chunks[(True, 1), "cut"][0]
    assert te.scans._seg_words > 2


@pytest.mark.parametrize("n", [1, 2, 3])
def test_short_chunks_byte_identical(n):
    """Chunks shorter than the anchor spacing: one frame (an I anchor,
    no B), two (two anchors, no B) and three (one B)."""
    je = _jax(True, 2)
    frames = CLIPS["ball"][:n]
    got = _port(je).encode_chunk(frames)
    assert got == je.encode_chunk(frames)
    types = FvcDecoder(device="cpu").decode_chunk(got)[1]["types"]
    assert types == [[0], [0, 1], [0, 2, 1]][n - 1]


def test_cudafvcenc_hier_b_matches_fvcenc_in_one_launch():
    """The same launch string through flutpu's parse_launch (``fvcenc``)
    and the port's (``cudafvcenc``): each package's registry holds its own
    elements."""
    src = f"videotestsrc num-buffers=16 pattern=ball width={W} height={H}"
    opts = "motion=true search=hier bframes=1"
    out = {"a": pull_all(flutpu.core.parse_launch,
                         f"{src} ! fvcenc {opts} ! appsink name=out"),
           "b": pull_all(flutpu_torch.core.parse_launch,
                         f"{src} ! cudafvcenc {opts} device=cpu "
                         "! appsink name=out")}
    assert len(out["b"]) == 2
    assert [bytes(b.data) for b in out["b"]] == \
        [bytes(b.data) for b in out["a"]]
    assert [b.meta["frame_pts"] for b in out["b"]] == \
        [b.meta["frame_pts"] for b in out["a"]]
    assert 2 in FvcDecoder(device="cpu").decode_chunk(
        bytes(out["b"][0].data))[1]["types"]
