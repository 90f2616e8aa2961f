"""The FVC slice: flutpu_torch's chunk codec against flutpu's on the CPU.

Contract: for the same frames and tables, the port's chunks
(``device="cpu"``, the kernels' plain versions) equal flutpu's
``FvcEncoder(...).encode_chunk`` byte for byte at q85 ±7, version 1 and
version 2 (P frames), through every entry point: ``encode_chunk``,
dispatch/finalize with two chunks in flight, the on-device source, the
``cudafvcenc`` element against ``fvcenc``, and chunks whose segments or
prefix window overflow and are redispatched. The inputs are
``make_test_frame("ball", 160, 96, i)`` and a clip with a cut in the
middle (ball, then noise), which makes the per-frame I/P decision pick
intra. At q90 ±5 and q95 ±5 a rounding tie splits the streams (the
in-loop DCT is within 1e-4 of XLA's, and SADs are summed in another
order); there the tie contract of ``_tie_contract`` holds instead. The
port's ``FvcDecoder`` reads flutpu's chunks within one RGB level of
flutpu's decoder, with the same frame types."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flutpu.core
import flutpu_torch.core
from flutpu.codec import fvc as jf
from flutpu.codec.ops.testsrc import gradient_ball_planes as j_ball_planes
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec import fvc as tf
from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.ops.colorspace import planes_to_i420
from flutpu_torch.codec.ops.motion import motion_compensate_subpel
from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
from torch_helpers import pull_all

torch.set_num_threads(1)

W, H = 160, 96


def _clip(pattern, n=8, start=0, w=W, h=H):
    return np.stack([make_test_frame(pattern, w, h, i)
                     for i in range(start, start + n)])


CLIPS = {"ball": _clip("ball"),
         "cut": np.concatenate([_clip("ball", 4), _clip("noise", 4, 4)])}
CASES = [(m, c) for m in (False, True) for c in CLIPS]


def _port(je, **state):
    return FvcEncoder.from_numpy_state(je.qy, je.qc, je.search_range,
                                       motion=je.motion, device="cpu",
                                       **state)


@pytest.fixture(scope="module")
def jax_chunks():
    """flutpu's chunks for every (motion, clip), encoded once."""
    out = {}
    for motion in (False, True):
        je = jf.FvcEncoder(85, motion=motion)
        for name, frames in CLIPS.items():
            out[(motion, name)] = je.encode_chunk(frames)
    return out


@pytest.mark.parametrize("motion,clip", CASES)
def test_chunk_byte_identical(jax_chunks, motion, clip):
    je = jf.FvcEncoder(85, motion=motion)
    assert _port(je).encode_chunk(CLIPS[clip]) == jax_chunks[(motion, clip)]


@pytest.mark.parametrize("motion,clip", CASES)
def test_chunk_without_segments_byte_identical(jax_chunks, motion, clip):
    """``segmented=False``: the per-block pack and the block concat, the
    layout flutpu's encoder takes on the CPU."""
    je = jf.FvcEncoder(85, motion=motion)
    te = _port(je, segmented=False)
    assert te._scan_coder.segmented is False
    assert te.encode_chunk(CLIPS[clip]) == jax_chunks[(motion, clip)]


def _near_tie(cur, refs, mb, vecs):
    """Two vectors the packages chose for one macroblock, each on its own
    reference plane (the packages' in-loop reconstructions, which differ
    by fp32 roundings): in float64, each choice costs no more than the
    other's on its own reference, up to the fp32 rounding of a 256-term
    SAD — each is right for its reference, and they rank the pair apart
    only because the references differ."""
    by, bx = mb

    def cost(ref, v):
        dy, dx = int(v[0]), int(v[1])
        rows = (np.arange(16) + 16 * by - dy) % ref.shape[0]
        cols = (np.arange(16) + 16 * bx - dx) % ref.shape[1]
        blk = cur[16 * by:16 * by + 16, 16 * bx:16 * bx + 16]
        sad = np.abs(blk.astype(np.float64)
                     - ref[np.ix_(rows, cols)].astype(np.float64)).sum()
        return sad * 64 + abs(dy) + abs(dx), sad

    for ref, mine, other in ((refs[0], vecs[0], vecs[1]),
                             (refs[1], vecs[1], vecs[0])):
        (c_mine, sad), (c_other, _) = cost(ref, mine), cost(ref, other)
        assert c_mine <= c_other + 64 * 256 * 2.0 ** -23 * max(sad, 1.0), \
            (mb, vecs)


def _tie_contract(frames, je, te):
    """The contract where a rounding tie splits the two streams: equal
    frame types; vectors equal except at float64-verified near-ties;
    coefficients within ±1 on at most 1e-4 of them; flutpu's decoder
    reads the port's chunk within 0.05 dB of flutpu's own chunk."""
    r = je.search_range
    j_parts = jf.fvc_mc_encode_chunk(jnp.asarray(frames), je._qy_dev,
                                     je._qc_dev, pad_h=H, pad_w=W,
                                     search_range=r, planar=False)
    j_rec = np.asarray(jf.fvc_mc_decode_chunk(
        *j_parts, je._qy_dev, je._qc_dev, search_range=r, planar=False)[0])
    qy, qc = te._scan_coder._qy_dev, te._scan_coder._qc_dev
    t_parts = tf.fvc_mc_encode_chunk(torch.from_numpy(frames), qy, qc, H, W,
                                     r)
    t_rec = tf.fvc_mc_decode_chunk(*t_parts, qy, qc)[0].numpy()
    j_parts = [np.asarray(p) for p in j_parts]
    t_parts = [p.numpy() for p in t_parts]
    np.testing.assert_array_equal(t_parts[4], j_parts[4])      # frame types
    cur = planes_to_i420(*(torch.from_numpy(frames[..., c])
                           for c in range(3)))[0].numpy()
    for f, by, bx in zip(*np.nonzero((t_parts[3] != j_parts[3]).any(-1))):
        _near_tie(cur[f], (t_rec[f - 1], j_rec[f - 1]), (by, bx),
                  (t_parts[3][f, by, bx], j_parts[3][f, by, bx]))
    d = np.concatenate([np.abs(a.astype(np.int32) - b.astype(np.int32))
                        .ravel() for a, b in zip(t_parts[:3], j_parts[:3])])
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4
    dec = jf.FvcDecoder()
    psnr = []
    for chunk in (te.encode_chunk(frames), je.encode_chunk(frames)):
        rgb = dec.decode_chunk(chunk)[0].astype(np.float64)
        mse = ((rgb - frames) ** 2).mean(axis=(1, 2, 3))
        psnr.append(10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12)))
    assert np.abs(psnr[0] - psnr[1]).max() <= 0.05


@pytest.mark.parametrize("quality,search_range,identical",
                         [(60, 4, True), (90, 5, False), (95, 5, False)])
def test_quality_and_search_range(quality, search_range, identical):
    """Byte identity holds at q60 ±4. At q90 ±5 the two packages pick
    different vectors for one macroblock of frame 2 (a float64 near-tie,
    SADs equal to 1e-8), at q95 ±5 nine coefficients of frames 2-3 land
    on the other side of a quantization tie (the in-loop DCT is within
    1e-4 of XLA's, not bit-equal): the tie contract holds there."""
    je = jf.FvcEncoder(quality, motion=True, search_range=search_range)
    te = _port(je)
    frames = CLIPS["cut"]
    assert (te.encode_chunk(frames) == je.encode_chunk(frames)) == identical
    _tie_contract(frames, je, te)


@pytest.mark.parametrize("motion", [False, True])
def test_edge_padded_geometry_byte_identical(motion):
    """150x90 frames code at 160x96: both packages edge-pad the frames,
    and the header carries 150x90."""
    frames = _clip("ball", 4, w=150, h=90)
    je = jf.FvcEncoder(85, motion=motion)
    got = _port(je).encode_chunk(frames)
    assert got == je.encode_chunk(frames)
    assert FvcDecoder(device="cpu").decode_chunk(got)[0].shape \
        == (4, 90, 150, 3)


def test_cut_makes_intra_frames(jax_chunks):
    """The mid-chunk cut is coded intra by both packages: the noise
    frames predict worse from motion than from flat 128."""
    types = FvcDecoder.parse_chunk(jax_chunks[(True, "cut")])[1]
    assert [t for t, _, _ in types] == [0, 1, 1, 1, 0, 0, 0, 0]
    assert all((mv is None) == (t == 0) for t, mv, _ in types)


@pytest.mark.parametrize("motion", [False, True])
def test_dispatch_src_and_two_in_flight(jax_chunks, motion):
    """The source renders at the coded size (96 rows) and the header
    carries the frame size (88 rows), in both packages; two chunks in
    flight finalize in order. Both encoders read the port's source
    planes: flutpu's jitted source rounds its red ramp differently
    (``test_reference_source_ramp_rounds_through_a_reciprocal``)."""
    je = jf.FvcEncoder(85, motion=motion)
    te = _port(je)
    h = 88
    t_src = lambda ph, pw, n, s: gradient_ball_planes(  # noqa: E731
        ph, pw, n, s, device="cpu")
    planes = tuple(jnp.asarray(p.numpy()) for p in t_src(96, W, 8, 8))
    want = je.encode_chunk_finalize(je.encode_chunk_dispatch_src(
        lambda ph, pw, n, s: planes, jnp.float32(8), 8, h, W))
    first = te.encode_chunk_dispatch_src(t_src, 8, 8, h, W)
    second = te.encode_chunk_dispatch(CLIPS["cut"])
    assert te.encode_chunk_finalize(first) == want
    assert te.encode_chunk_finalize(second) == jax_chunks[(motion, "cut")]


def test_reference_source_ramp_rounds_through_a_reciprocal():
    """flutpu's jitted gradient-ball source computes ``x * 255 / (w - 1)``
    as XLA:CPU folds it, through the reciprocal of w - 1: at w = 160 its
    red channel is one level lower at x = 53, 106, 159. The port divides
    (IEEE), and equals numpy; everything else of the frames agrees."""
    j = [np.asarray(p) for p in j_ball_planes(96, W, 8, jnp.float32(8))]
    t = [p.numpy() for p in gradient_ball_planes(96, W, 8, 8, device="cpu")]
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])
    x = np.arange(W, dtype=np.float32)
    ramp = (x * np.float32(255.0) / np.float32(W - 1)).astype(np.uint8)
    ball = t[0] == 255
    np.testing.assert_array_equal(np.where(ball, 255, ramp), t[0])
    cols = np.nonzero((j[0] != t[0]).any(axis=(0, 1)))[0]
    assert cols.tolist() == [53, 106, 159]
    assert (t[0] - j[0]).max() == 1


@pytest.mark.parametrize("motion,clip", CASES)
def test_decoder_matches_flutpu(jax_chunks, motion, clip):
    data = jax_chunks[(motion, clip)]
    want, j_info = jf.FvcDecoder().decode_chunk(data)
    got, info = FvcDecoder(device="cpu").decode_chunk(data)
    assert info == j_info
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_decoder_reads_planar_flag():
    """A chunk written with the planar in-loop DCT (header flags bit 3, the
    JAX encoder's TPU formulation) reconstructs through the planar
    inverse."""
    je = jf.FvcEncoder(85, motion=True)
    je.planar = True
    data = je.encode_chunk(CLIPS["ball"][:4])
    assert data[5] & 8
    want, _ = jf.FvcDecoder().decode_chunk(data)
    got, _ = FvcDecoder(device="cpu").decode_chunk(data)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_decoder_defaults_to_the_card():
    """Like every entry point of the port, the decoder runs on the card
    unless the caller names another device (a torch.device needs no
    card to exist)."""
    assert FvcDecoder().device.type == "cuda"
    assert FvcDecoder(device="cpu").device.type == "cpu"


def test_motion_chunk_program_matches_jax():
    """The v2 device program's parts: residual coefficients, vectors and
    frame types equal flutpu's fvc_mc_encode_chunk (planar=False)."""
    frames = CLIPS["cut"]
    je = jf.FvcEncoder(85, motion=True)
    want = jf.fvc_mc_encode_chunk(jnp.asarray(frames), je._qy_dev,
                                  je._qc_dev, pad_h=H, pad_w=W,
                                  search_range=7, planar=False)
    te = _port(je)
    got = tf.fvc_mc_encode_chunk(torch.from_numpy(frames),
                                 te._scan_coder._qy_dev,
                                 te._scan_coder._qc_dev, H, W, 7)
    for g, w_ in zip(got, want):
        assert g.dtype == {np.int16: torch.int16, np.int8: torch.int8}[
            np.asarray(w_).dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_residual_scan_and_accumulate_match_jax():
    rng = np.random.default_rng(0)
    planes = [rng.integers(-2000, 2000, (5, 3, 4, 64)).astype(np.int16)
              for _ in range(3)]
    got = tf.fvc_residuals(*(torch.from_numpy(p) for p in planes))
    want = jf.fvc_residuals(*(jnp.asarray(p) for p in planes))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    acc = tf.fvc_accumulate(*got)
    j_acc = jf.fvc_accumulate(*want)
    for g, w_ in zip(acc, j_acc):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("state", [{"seg_words": 2}, {"prefix_window": 16}])
def test_overflow_redispatches_at_reported_size(jax_chunks, state):
    te = _port(jf.FvcEncoder(85, motion=True), **state)
    assert te.encode_chunk(CLIPS["cut"]) == jax_chunks[(True, "cut")]
    sc = te._scan_coder
    if "seg_words" in state:
        assert sc._seg_words > 2
    else:
        assert sc._prefix_window > 16


def test_overflow_without_segments_redispatches(jax_chunks):
    """The non-segment window overflows (bits > window * 32) and the
    redispatch at the reported need gives flutpu's chunk."""
    te = _port(jf.FvcEncoder(85, motion=True), prefix_window=16,
               segmented=False)
    assert te.encode_chunk(CLIPS["cut"]) == jax_chunks[(True, "cut")]
    assert te._scan_coder._prefix_window > 16


def test_beyond_theoretical_bound_raises():
    te = _port(jf.FvcEncoder(85, motion=True), seg_words=2)
    te._scan_coder.BLOCK_BITS_BOUND = 8   # a bound no real content fits
    with pytest.raises(OverflowError):
        te.encode_chunk(CLIPS["cut"][:2])


def test_from_numpy_state_needs_a_quality_table():
    je = jf.FvcEncoder(70)
    assert _port(je).quality == 70
    with pytest.raises(ValueError):
        FvcEncoder.from_numpy_state(je.qy + 1, je.qc, device="cpu")


#: options the port runs; the others raise
PORTED = ({"hier": True}, {"bframes": 1}, {"subpel": True},
          {"search_range": 40}, "search=hier", "bframes=1", "subpel=true",
          "bitrate=100000")


@pytest.mark.parametrize("kwargs", [
    {"subpel": True}, {"hier": True}, {"bframes": 1}, {"subsample": False},
    {"engine": "host"}, {"search_range": 40}])
def test_unported_encoder_options_raise(kwargs):
    """The host engine raises NotImplementedError (by design); hier,
    bframes, subpel and a range above 32 build a motion encoder that
    carries them (``test_torch_wide_search.py`` holds range 40 to
    flutpu's bytes); 4:4:4 builds a version 1 encoder and, with motion,
    raises flutpu's ValueError."""
    if kwargs in PORTED:
        enc = FvcEncoder(85, motion=True, device="cpu", **kwargs)
        assert (enc.hier, enc.bframes, enc.subpel, enc.search_range) == (
            kwargs.get("hier", False), kwargs.get("bframes", 0),
            kwargs.get("subpel", False), kwargs.get("search_range", 7))
        return
    if kwargs == {"subsample": False}:
        assert FvcEncoder(85, device="cpu", **kwargs).subsample is False
        with pytest.raises(ValueError, match="4:2:0"):
            FvcEncoder(85, motion=True, device="cpu", **kwargs)
        return
    with pytest.raises(NotImplementedError):
        FvcEncoder(85, motion=True, device="cpu", **kwargs)


@pytest.mark.parametrize("bit", [4, 16, 32])
def test_unported_stream_features_raise(jax_chunks, bit):
    """Every header flag is read. Bit 2 (half-pel): a P chunk's integer
    vectors read as half-pel decode as flutpu's decoder reads them. Bit 4
    (coded size): the extension after the search range gives the same
    frames as the minimum padding. Bit 5 (B frames): with its bquality
    byte after the search range, a P-only chunk flagged for B frames
    decodes to the same frames."""
    data = bytearray(jax_chunks[(True, "ball")])
    data[5] |= bit
    plain = FvcDecoder(device="cpu").decode_chunk(jax_chunks[(True, "ball")])
    if bit == 4:
        got, info = FvcDecoder(device="cpu").decode_chunk(bytes(data))
        want, j_info = jf.FvcDecoder().decode_chunk(bytes(data))
        assert info == j_info and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert not np.array_equal(got, plain[0])
        return
    data[13:13] = struct.pack(">HH", W, H) if bit == 16 else bytes([77])
    got, info = FvcDecoder(device="cpu").decode_chunk(bytes(data))
    if bit == 32:
        assert FvcDecoder.parse_chunk(bytes(data))[0]["bquality"] == 77
    assert info == plain[1]
    np.testing.assert_array_equal(got, plain[0])
    np.testing.assert_array_equal(
        got, FvcDecoder(device="cpu").decode_chunk(
            jf.FvcEncoder(85, motion=True).encode_chunk(CLIPS["ball"]))[0])


def test_unported_program_options_raise():
    """The planar DCT raises; hier runs the coarse-to-fine search; subpel
    runs the half-pel loop, equal to flutpu's program on these frames."""
    frames = torch.from_numpy(CLIPS["ball"][:2])
    q = torch.ones((8, 8), dtype=torch.int32)
    ry, _, _, mvs, itypes = tf.fvc_mc_encode_chunk(frames, q, q, H, W, 7,
                                                   hier=True)
    assert ry.shape[0] == mvs.shape[0] == 2 and itypes.tolist() == [1, 0]
    with pytest.raises(NotImplementedError):
        tf.fvc_mc_encode_chunk(frames, q, q, H, W, 7, planar=True)
    got = tf.fvc_mc_encode_chunk(frames, q, q, H, W, 7, subpel=True)
    want = jf.fvc_mc_encode_chunk(jnp.asarray(frames.numpy()),
                                  jnp.asarray(q.numpy()),
                                  jnp.asarray(q.numpy()), pad_h=H, pad_w=W,
                                  search_range=7, subpel=True, planar=False)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("prop", ["bitrate=100000", "search=hier",
                                  "subpel=true", "bframes=1"])
def test_cudafvcenc_unported_properties_raise(prop):
    """Every one now reaches the encoder: search=hier, subpel and bframes
    its settings; bitrate the rate controller, whose first chunk is
    encoded at the quality property (``test_torch_ratecontrol.py`` holds
    its chunks to fvcenc's)."""
    name, value = prop.split("=")
    el = flutpu_torch.core.make("cudafvcenc", device="cpu", motion=True)
    el.set_property(name, {"true": True}.get(value, value if not
                                              value.isdigit()
                                              else int(value)))
    assert prop in PORTED
    enc = el._enc()
    assert (enc.hier, enc.bframes, enc.subpel, enc.quality) == (
        prop == "search=hier", int(prop == "bframes=1"),
        prop == "subpel=true", 85)
    if prop == "bitrate=100000":
        j = flutpu.core.make("fvcenc", bitrate=100000)
        dur = 33 * flutpu_torch.core.MSECOND
        assert el._chunk_target_bytes(
            [flutpu_torch.core.Buffer(None, duration=dur)] * 8) == \
            j._chunk_target_bytes([flutpu.core.Buffer(None, duration=dur)]
                                  * 8) > 0


def _subpel_cost(cur, ref, mb, v):
    """float64 SAD of macroblock ``mb`` of ``cur`` against the bilinear
    half-pel prediction of ``ref`` at vector ``v`` (half-pel units)."""
    by, bx = mb
    mv = np.zeros((ref.shape[0] // 16, ref.shape[1] // 16, 2), np.int64)
    mv[by, bx] = v
    pred = motion_compensate_subpel(torch.from_numpy(ref.astype(np.float64)),
                                    torch.from_numpy(mv)).numpy()
    sl = (slice(16 * by, 16 * by + 16), slice(16 * bx, 16 * bx + 16))
    return float(np.abs(cur[sl].astype(np.float64) - pred[sl]).sum())


def _subpel_near_tie(cur, refs, mb, vecs):
    """Two half-pel vectors the packages chose for one macroblock, each on
    its own in-loop reference: in float64 each costs no more than the
    other on its own reference, up to one fp32 rounding of a sample below
    256 per pixel (the references differ by such roundings)."""
    tol = 256 * 2.0 ** -16
    for ref, mine, other in ((refs[0], vecs[0], vecs[1]),
                             (refs[1], vecs[1], vecs[0])):
        assert _subpel_cost(cur, ref, mb, mine) <= \
            _subpel_cost(cur, ref, mb, other) + tol, (mb, vecs)


def _subpel_tie_contract(frames, je, te):
    """``_tie_contract`` for half-pel chunks: equal frame types; vectors
    equal except at float64-verified near-ties of the half-pel cost;
    coefficients within ±1 on at most 1e-4 of them; flutpu's decoder
    reads the port's chunk within 0.05 dB of flutpu's own. Returns the
    count of split vectors."""
    r, hier = je.search_range, je.hier
    j_parts = jf.fvc_mc_encode_chunk(jnp.asarray(frames), je._qy_dev,
                                     je._qc_dev, pad_h=H, pad_w=W,
                                     search_range=r, hier=hier, subpel=True,
                                     planar=False)
    j_rec = np.asarray(jf.fvc_mc_decode_chunk(
        *j_parts, je._qy_dev, je._qc_dev, search_range=r, subpel=True,
        planar=False)[0])
    qy, qc = te._scan_coder._qy_dev, te._scan_coder._qc_dev
    t_parts = tf.fvc_mc_encode_chunk(torch.from_numpy(frames), qy, qc, H, W,
                                     r, hier=hier, subpel=True)
    t_rec = tf.fvc_mc_decode_chunk(*t_parts, qy, qc, subpel=True)[0].numpy()
    j_parts = [np.asarray(p) for p in j_parts]
    t_parts = [p.numpy() for p in t_parts]
    np.testing.assert_array_equal(t_parts[4], j_parts[4])      # frame types
    cur = planes_to_i420(*(torch.from_numpy(frames[..., c])
                           for c in range(3)))[0].numpy()
    split = list(zip(*np.nonzero((t_parts[3] != j_parts[3]).any(-1))))
    for f, by, bx in split:
        _subpel_near_tie(cur[f], (t_rec[f - 1], j_rec[f - 1]), (by, bx),
                         (t_parts[3][f, by, bx], j_parts[3][f, by, bx]))
    d = np.concatenate([np.abs(a.astype(np.int32) - b.astype(np.int32))
                        .ravel() for a, b in zip(t_parts[:3], j_parts[:3])])
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4
    dec = jf.FvcDecoder()
    psnr = []
    for chunk in (te.encode_chunk(frames), je.encode_chunk(frames)):
        rgb = dec.decode_chunk(chunk)[0].astype(np.float64)
        mse = ((rgb - frames) ** 2).mean(axis=(1, 2, 3))
        psnr.append(10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12)))
    assert np.abs(psnr[0] - psnr[1]).max() <= 0.05
    return len(split)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("hier", [False, True], ids=["full", "hier"])
def test_subpel_chunk_matches_flutpu(hier, clip):
    """``FvcEncoder(subpel=True)`` (the search's integer vectors, the
    half-pel refine, bilinear predictions; header flags bit 2) against
    flutpu's on the CPU: byte-identical, or split only where the two
    in-loop references, which differ by fp32 roundings, rank two half-pel
    candidates of one macroblock apart at a float64 near-tie (on the
    ball clip, one vector of frame 2, costs equal to 1e-15)."""
    je = jf.FvcEncoder(85, motion=True, subpel=True, hier=hier)
    te = FvcEncoder.from_numpy_state(je.qy, je.qc, je.search_range,
                                     motion=True, hier=hier, subpel=True,
                                     device="cpu")
    frames = CLIPS[clip]
    got = te.encode_chunk(frames)
    assert got[:6] == b"FVC1\x02\x07"
    n_split = _subpel_tie_contract(frames, je, te)
    assert (got == je.encode_chunk(frames)) == (n_split == 0)
    assert n_split <= 1


def test_subpel_refusals_match_flutpu():
    """Half-pel vectors stay int8: ranges above 62 raise ValueError; B
    frames with subpel raise ValueError, as flutpu's encoder does; range
    62 with subpel builds, as in flutpu."""
    for kw in ({"search_range": 63}, {"bframes": 1}):
        with pytest.raises(ValueError):
            jf.FvcEncoder(85, motion=True, subpel=True, **kw)
        with pytest.raises(ValueError):
            FvcEncoder(85, motion=True, subpel=True, device="cpu", **kw)
    enc = FvcEncoder(85, motion=True, subpel=True, search_range=62,
                     device="cpu")
    assert (enc.subpel, enc.search_range) == (True, 62) == (
        jf.FvcEncoder(85, motion=True, subpel=True, search_range=62).subpel,
        62)


@pytest.mark.parametrize("w,h", [(W, H), (76, 44)])
@pytest.mark.parametrize("segmented", [True, False])
def test_444_v1_chunk_byte_identical(w, h, segmented):
    """``FvcEncoder(subsample=False)``: version 1 in 4:4:4 (flags bit 0
    clear, frames padded to multiples of 8) equals flutpu's chunk byte
    for byte, in either layout of the entropy stage."""
    frames = np.concatenate([_clip("ball", 3, w=w, h=h),
                             _clip("noise", 2, 3, w=w, h=h)])
    je = jf.FvcEncoder(85, subsample=False)
    te = FvcEncoder.from_numpy_state(je.qy, je.qc, subsample=False,
                                     segmented=segmented, device="cpu")
    got = te.encode_chunk(frames)
    assert got == je.encode_chunk(frames)
    assert got[5] == 0
    assert FvcDecoder(device="cpu").decode_chunk(got)[0].shape == \
        frames.shape


def _element_pair(opts: str, port_opts: str = ""):
    """The same source through ``fvcenc`` (flutpu's parse_launch) and
    ``cudafvcenc`` (the port's: each package's registry holds its own
    elements) → {"a": flutpu's buffers, "b": the port's}."""
    src = f"videotestsrc num-buffers=16 pattern=ball width={W} height={H}"
    return {"a": pull_all(flutpu.core.parse_launch,
                          f"{src} ! fvcenc {opts} ! appsink name=out"),
            "b": pull_all(flutpu_torch.core.parse_launch,
                          f"{src} ! cudafvcenc {opts} device=cpu "
                          f"{port_opts} ! appsink name=out")}


def test_cudafvcenc_matches_fvcenc_in_one_launch():
    """The same launch string through each package's parse_launch (each
    registry holds its own elements): the same buffers."""
    out = _element_pair("motion=true")
    assert len(out["b"]) == 2
    assert [bytes(b.data) for b in out["b"]] == \
        [bytes(b.data) for b in out["a"]]
    assert [b.pts for b in out["b"]] == [b.pts for b in out["a"]]
    assert [b.meta["frame_pts"] for b in out["b"]] == \
        [b.meta["frame_pts"] for b in out["a"]]


@pytest.mark.parametrize("opts", ["", "motion=true"])
def test_cudafvcenc_without_segments_matches_fvcenc(opts):
    """``cudafvcenc segmented=false`` (the per-block pack) against flutpu's
    default ``fvcenc`` on the CPU, which takes the same layout."""
    out = _element_pair(opts, "segmented=false")
    assert len(out["b"]) == 2
    assert [bytes(b.data) for b in out["b"]] == \
        [bytes(b.data) for b in out["a"]]


def test_v2_header_writes_per_block_dct_flag(jax_chunks):
    """flags = 4:2:0 | zlib vectors; bit 3 (planar DCT) stays 0, as the
    JAX encoder writes it on the CPU."""
    data = _port(jf.FvcEncoder(85, motion=True)).encode_chunk(CLIPS["ball"])
    assert data[:6] == b"FVC1\x02\x03"
    assert data[12] == 7
