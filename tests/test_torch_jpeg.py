"""The whole slice: flutpu_torch's JPEG encoder against flutpu's on the CPU.

Contract: for the same frames and tables the port's JFIF bytes equal
``flutpu.codec.jpeg.JpegEncoder(use_pallas=False)``'s, through every
entry point (encode_gop, dispatch/finalize, the on-device source, the
cudajpegenc element), including GOPs whose segments or prefix window
overflow and are redispatched at the reported size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.decode import decode_scan_to_coefs as j_decode_scan
from flutpu.codec.decoders import parse_jfif as j_parse_jfif
from flutpu.codec.jpeg import JpegEncoder as JaxEncoder
from flutpu.codec.ops.testsrc import gradient_ball_frames as j_ball_frames
from flutpu.codec.ops.testsrc import gradient_ball_planes as j_ball_planes
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec.convert import encoder_state_from_numpy
from flutpu_torch.codec.decode import (coefs_to_rgb, decode_scan_to_coefs,
                                       parse_jfif)
from flutpu_torch.codec.jpeg import JpegEncoder, _planes_front_end
from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
from flutpu_torch.core import make, parse_launch
from torch_helpers import capped_prefix, profiled_spans, pull_all

torch.set_num_threads(1)


def _frames(pattern, w, h, n=3, start=0):
    return np.stack([make_test_frame(pattern, w, h, i)
                     for i in range(start, start + n)])


def _pair(**state):
    je = JaxEncoder(quality=85, use_pallas=False)
    te = JpegEncoder.from_numpy_state(je.qy, je.qc, device="cpu", **state)
    return je, te


@pytest.mark.parametrize("pattern,w,h", [("gradient", 64, 48),
                                         ("ball", 64, 48),
                                         ("smpte", 72, 40),
                                         ("noise", 48, 32)])
def test_encode_gop_byte_identical(pattern, w, h):
    je, te = _pair()
    frames = _frames(pattern, w, h)
    assert te.encode_gop(frames) == je.encode_gop(frames)


@pytest.mark.parametrize("quality", [30, 95])
def test_quality_byte_identical(quality):
    frames = _frames("ball", 64, 48, n=2)
    want = JaxEncoder(quality=quality, use_pallas=False).encode_gop(frames)
    assert JpegEncoder(quality=quality, device="cpu").encode_gop(frames) \
        == want


def test_dispatch_finalize_and_source_byte_identical():
    """The source renders at the coded size (48 rows) and the headers
    carry the frame size (40 rows), in both packages."""
    je, te = _pair()
    h, w, ph, pw = 40, 64, 48, 64
    j_src = lambda ph_, pw_, start: j_ball_planes(  # noqa: E731
        ph_, pw_, 4, start)
    want = je.encode_gop_finalize(je.encode_gop_dispatch_src(
        j_src, jnp.float32(8), h, w, ph, pw))
    t_src = lambda ph_, pw_, start: gradient_ball_planes(  # noqa: E731
        ph_, pw_, 4, start, device="cpu")
    assert te.encode_gop_finalize(te.encode_gop_dispatch_src(
        t_src, 8, h, w, ph, pw)) == want
    frames = np.array(j_ball_frames(ph, pw, 4, jnp.float32(8)))
    assert te.encode_gop_finalize(te.encode_gop_dispatch(
        torch.from_numpy(frames), h, w)) == want
    assert je.encode_gop_finalize(je.encode_gop_dispatch(
        jnp.asarray(frames), h, w)) == want


def test_two_gops_in_flight():
    je, te = _pair()
    a, b = _frames("ball", 64, 48, 2, 0), _frames("ball", 64, 48, 2, 5)
    ha = te.encode_gop_dispatch(torch.from_numpy(a), 48, 64)
    hb = te.encode_gop_dispatch(torch.from_numpy(b), 48, 64)
    assert te.encode_gop_finalize(ha) == je.encode_gop(a)
    assert te.encode_gop_finalize(hb) == je.encode_gop(b)


def test_segment_overflow_redispatches_at_reported_size():
    je, te = _pair(seg_words=2)
    frames = _frames("noise", 48, 32, n=2)
    got = te.encode_gop(frames)
    assert got == je.encode_gop(frames)
    assert te.scans._seg_words > 2      # grew to cover the densest segment


def test_prefix_overflow_redispatches_at_reported_size():
    je, te = _pair(prefix_window=16)
    frames = _frames("noise", 48, 32, n=2)
    assert te.encode_gop(frames) == je.encode_gop(frames)
    assert te.scans._prefix_window > 16


def test_encode_gop_starts_at_the_learned_window(monkeypatch):
    """With the prefix cap below the GOP's usage only the first dispatch
    overflows; the next starts at the learned window and codes once."""
    je, te = _pair()
    starts = capped_prefix(monkeypatch, te.scans, 64)
    frames = _frames("noise", 48, 32, n=2)
    first, spans = profiled_spans(lambda: te.encode_gop(frames))
    assert [s[0] for s in spans] == ["jpeg.copy", "jpeg.fetch_wait",
                                     "jpeg.redispatch", "jpeg.copy",
                                     "jpeg.fetch_wait", "jpeg.compact"]
    again, spans = profiled_spans(lambda: te.encode_gop(frames))
    assert [s[0] for s in spans] == ["jpeg.copy", "jpeg.fetch_wait",
                                     "jpeg.compact"]
    assert starts[0] == 64 < starts[1]
    assert first == again == je.encode_gop(frames)


def test_beyond_theoretical_bound_raises():
    _, te = _pair(seg_words=2)
    te.scans.BLOCK_BITS_BOUND = 8       # a bound no real content fits under
    with pytest.raises(OverflowError):
        te.encode_gop(_frames("noise", 48, 32, n=1))


def test_adaptive_sizes_follow_usage():
    """Usage recorded at finalize sizes the next dispatch."""
    _, te = _pair()
    assert te.scans._prefix_target() is None
    te.encode_gop(_frames("gradient", 64, 48, n=2))
    assert te.scans._prefix_used_words > 0
    target = te.scans._prefix_target()
    assert target >= 8192
    h = te.encode_gop_dispatch(torch.from_numpy(_frames("gradient", 64, 48)),
                               48, 64)
    # adopted, and clamped by the frame's theoretical bound
    assert te.scans._prefix_window == target
    assert h.scans.prefix == min(target,
                                 72 * JpegEncoder.BLOCK_BITS_BOUND // 32)


def test_encoder_state_from_numpy():
    je = JaxEncoder(quality=70, use_pallas=False)
    st = encoder_state_from_numpy(je.qy, je.qc, seg_words=96,
                                  prefix_window=4096, device="cpu")
    assert st.qy.dtype == torch.int32 and st.qy.shape == (8, 8)
    np.testing.assert_array_equal(st.qc.numpy(), je.qc)
    assert (st.seg_words, st.prefix_window) == (96, 4096)
    with pytest.raises(ValueError):
        encoder_state_from_numpy(je.qy[:4], je.qc, device="cpu")
    with pytest.raises(ValueError):
        encoder_state_from_numpy(je.qy * 0, je.qc, device="cpu")


def test_444_is_not_ported():
    """4:4:4 is ported: ``JpegEncoder(subsample=False)`` writes SOF0
    sampling 0x11 for every component and flutpu's bytes."""
    frames = _frames("ball", 64, 48, n=2)
    te = JpegEncoder(subsample=False, device="cpu")
    got = te.encode_gop(frames)
    assert got == JaxEncoder(quality=85, subsample=False,
                             use_pallas=False).encode_gop(frames)
    assert parse_jfif(got[0])["subsample"] is False
    assert b"\x01\x11\x00\x02\x11\x01\x03\x11\x01" in got[0]


@pytest.mark.parametrize("segmented", [True, False])
@pytest.mark.parametrize("pattern,w,h", [("gradient", 64, 48),
                                         ("smpte", 72, 40),
                                         ("noise", 44, 30)])
def test_444_gop_byte_identical(pattern, w, h, segmented):
    """4:4:4 GOPs (frames padded to multiples of 8, one-block MCUs) in
    either layout of the entropy stage: flutpu's JFIF bytes; dispatch
    from a tensor on the device gives the same."""
    frames = _frames(pattern, w, h)
    want = JaxEncoder(quality=85, subsample=False,
                      use_pallas=False).encode_gop(frames)
    je = JaxEncoder(quality=85, use_pallas=False)
    te = JpegEncoder.from_numpy_state(je.qy, je.qc, subsample=False,
                                      segmented=segmented, device="cpu")
    assert te.encode_gop(frames) == want
    assert te.encode_gop_finalize(te.encode_gop_dispatch(
        torch.from_numpy(frames), h, w)) == want


def test_444_front_end_is_flutpus_xla_arm():
    """The plain 4:4:4 front end against flutpu's
    ``encode_gop_planes_to_coefs(subsample=False)``: the same
    coefficients; ``_planes_front_end`` takes it on ``subsample`` alone
    and refuses sizes that are no multiple of 8."""
    from flutpu.codec.jpeg import encode_gop_planes_to_coefs
    from flutpu_torch.codec.ops.frontend import front_end_444
    rng = np.random.default_rng(11)
    planes = [rng.integers(0, 256, (2, 40, 56), np.uint8) for _ in range(3)]
    je = JaxEncoder(quality=85, use_pallas=False)
    want = encode_gop_planes_to_coefs(*map(jnp.asarray, planes), je._qy_dev,
                                      je._qc_dev, pad_h=40, pad_w=56,
                                      subsample=False)
    qy, qc = torch.from_numpy(je.qy), torch.from_numpy(je.qc)
    t = [torch.from_numpy(p) for p in planes]
    got = front_end_444(*t, qy, qc)
    for a, b, c_ in zip(got, want, _planes_front_end(*t, qy, qc, 40, 56,
                                                     subsample=False)):
        assert a.shape == (2, 5, 7, 64) and a.dtype == torch.int16
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c_)
    with pytest.raises(ValueError):
        front_end_444(*(p[:, :36] for p in t), qy, qc)


def test_444_with_an_overlay_byte_identical():
    """4:4:4 burn-in at a size that needs no padding (the port pads, then
    blends; flutpu's CPU path blends, then pads, the same where nothing
    is padded): flutpu's bytes."""
    h, w = 48, 64
    frames = _frames("gradient", w, h, n=2)
    rng = np.random.default_rng(2)
    ov = rng.integers(0, 256, (h, w, 4), np.uint8)
    ov[: h // 2, :, 3] = 255
    ov[h // 2:, :, 3] = 0
    je = JaxEncoder(quality=85, subsample=False, use_pallas=False)
    want = je.encode_gop_finalize(je.encode_gop_dispatch(
        jnp.asarray(frames), h, w, overlay=jnp.asarray(ov)))
    te = JpegEncoder(quality=85, subsample=False, device="cpu")
    got = te.encode_gop_finalize(te.encode_gop_dispatch(
        torch.from_numpy(frames), h, w, overlay=torch.from_numpy(ov)))
    assert got == want and got != te.encode_gop(frames)


def test_cudajpegenc_444_matches_tpujpegenc():
    """``cudajpegenc subsample=false device=cpu`` against flutpu's
    ``tpujpegenc subsample=false`` in one launch string each: the same
    buffers."""
    import flutpu.core
    src = "videotestsrc num-buffers=6 pattern=ball width=72 height=40"
    a = pull_all(flutpu.core.parse_launch, f"{src} ! tpujpegenc "
                 "subsample=false batch-frames=4 ! appsink name=out")
    b = pull_all(parse_launch, f"{src} ! cudajpegenc subsample=false "
                 "batch-frames=4 device=cpu ! appsink name=out")
    assert len(b) == 6
    assert [bytes(x.data) for x in b] == [bytes(x.data) for x in a]


def test_decode_jpeg_and_psnr_are_flutpus():
    """The check helpers: ``decode_jpeg`` (Pillow, an independent
    decoder) and ``psnr`` give flutpu's values."""
    from flutpu.codec.jpeg import decode_jpeg as j_decode_jpeg
    from flutpu.codec.jpeg import psnr as j_psnr
    from flutpu_torch.codec.jpeg import decode_jpeg, psnr
    frames = _frames("ball", 64, 48, n=2)
    for sub in (True, False):
        data = JpegEncoder(subsample=sub, device="cpu").encode_gop(frames)[0]
        img = decode_jpeg(data)
        np.testing.assert_array_equal(img, j_decode_jpeg(data))
        assert psnr(frames[0], img) == j_psnr(frames[0], img) > 30
    assert psnr(frames[0], frames[0]) == float("inf")


def test_decode_helpers_match_flutpu():
    _, te = _pair()
    frames = _frames("ball", 64, 48, n=2)
    for data in te.encode_gop(frames):
        info, j_info = parse_jfif(data), j_parse_jfif(data)
        assert info["scan"] == j_info["scan"]
        assert (info["h"], info["w"]) == (j_info["h"], j_info["w"])
        for a, b in zip(decode_scan_to_coefs(info["scan"], 8, 6, 4, 3, True),
                        j_decode_scan(info["scan"], 8, 6, 4, 3, True)):
            np.testing.assert_array_equal(a, b)


def test_scan_decodes_to_front_end_coefficients():
    """What chip_smoke checks on the card, here on the CPU: each scan
    decodes to exactly the front end's coefficients, and reconstructs
    the frame at a PSNR above 30 dB."""
    _, te = _pair()
    frames = _frames("gradient", 64, 48, n=2)
    t = torch.from_numpy(frames)
    coefs = _planes_front_end(t[..., 0], t[..., 1], t[..., 2], te.scans.qy_dev,
                              te.scans.qc_dev, 48, 64)
    for i, data in enumerate(te.encode_gop(frames)):
        dec = decode_scan_to_coefs(parse_jfif(data)["scan"], 8, 6, 4, 3, True)
        for a, c in zip(dec, coefs):
            np.testing.assert_array_equal(a, c[i].numpy())
    rgb = coefs_to_rgb(*coefs, te.scans.qy_dev, te.scans.qc_dev, 48,
                       64).numpy()
    mse = ((rgb.astype(np.float64) - frames) ** 2).mean()
    assert 10 * np.log10(255.0 ** 2 / mse) > 30


def test_cudajpegenc_element_byte_identical():
    p = parse_launch("videotestsrc num-buffers=5 pattern=ball width=64 "
                     "height=48 ! cudajpegenc device=cpu batch-frames=4 "
                     "! appsink name=out")
    sink = p.get_by_name("out")
    p.play()
    bufs = []
    while (buf := sink.try_pull_buffer(timeout=30)) is not None:
        bufs.append(buf)
    p.stop()
    assert [b.pts for b in bufs] == sorted(b.pts for b in bufs)
    want = JaxEncoder(quality=85, use_pallas=False).encode_gop(
        _frames("ball", 64, 48, n=5))
    assert [bytes(b.data) for b in bufs] == want


def test_cudajpegenc_rejects_host_engine():
    """``engine=host`` builds the host entropy engine, whose GOP equals
    the device engine's byte for byte; an engine that is none of auto |
    device | host is refused."""
    el = make("cudajpegenc", device="cpu", engine="host")
    enc = el._get_encoder()
    assert enc.engine == "host"
    frames = _frames("ball", 64, 48, n=4)
    assert enc.encode_gop(frames) == JpegEncoder(device="cpu").encode_gop(
        frames)
    with pytest.raises(ValueError, match="engine"):
        make("cudajpegenc", device="cpu", engine="cpu")._get_encoder()


# -- the non-segment layout (segmented=False) ---------------------------------

def _blocks_pair(**state):
    je = JaxEncoder(quality=85, use_pallas=False)
    assert je.segmented is False         # flutpu's CPU default
    return je, JpegEncoder.from_numpy_state(je.qy, je.qc, device="cpu",
                                            segmented=False, **state)


@pytest.mark.parametrize("pattern,w,h", [("gradient", 64, 48),
                                         ("smpte", 72, 40),
                                         ("noise", 48, 32)])
def test_nonsegment_encode_gop_byte_identical(pattern, w, h):
    je, te = _blocks_pair()
    frames = _frames(pattern, w, h)
    assert te.encode_gop(frames) == je.encode_gop(frames)


def test_nonsegment_dispatch_finalize_and_source():
    """dispatch/finalize, the on-device source and two GOPs in flight."""
    je, te = _blocks_pair()
    h, w, ph, pw = 40, 64, 48, 64
    want = je.encode_gop_finalize(je.encode_gop_dispatch_src(
        lambda ph_, pw_, start: j_ball_planes(ph_, pw_, 4, start),
        jnp.float32(8), h, w, ph, pw))
    handle = te.encode_gop_dispatch_src(
        lambda ph_, pw_, start: gradient_ball_planes(ph_, pw_, 4, start,
                                                     device="cpu"),
        8, h, w, ph, pw)
    assert handle.scans.n_segs == 0 and handle.scans.seg_words is None
    frames = np.array(j_ball_frames(ph, pw, 4, jnp.float32(8)))
    second = te.encode_gop_dispatch(torch.from_numpy(frames), h, w)
    assert te.encode_gop_finalize(handle) == want
    assert te.encode_gop_finalize(second) == want


def test_nonsegment_prefix_overflow_redispatches():
    """Column 0 carries bits here: an overflow is bits > window * 32, and
    the redispatch runs at the reported need."""
    je, te = _blocks_pair(prefix_window=16)
    frames = _frames("noise", 48, 32, n=2)
    assert te.encode_gop(frames) == je.encode_gop(frames)
    assert te.scans._prefix_window > 16
    assert te.scans._seg_used_words == 0       # no segment usage recorded


def test_nonsegment_matches_flutpu_k7_in_interpret_mode():
    """flutpu's device engine with its K7 Pallas kernel in interpret mode
    (the patch of tests/test_entropy_pallas.py) and the port's layouts
    give the same bytes."""
    import flutpu.codec.ops.entropy_pallas as ep
    frames = make_test_frame("gradient", 32, 32, 2)[None]
    dev = JaxEncoder(quality=85, engine="device", use_pallas=True)
    orig = ep.pack_block_bits_fused
    ep.pack_block_bits_fused = lambda z, c, interpret=False: orig(
        z, c, interpret=True)
    try:
        want = dev.encode_gop(frames)
    finally:
        ep.pack_block_bits_fused = orig
    for segmented in (False, True):
        te = JpegEncoder(85, segmented=segmented, device="cpu")
        assert te.encode_gop(frames) == want


def test_nonsegment_k8a_arm_byte_identical(monkeypatch):
    monkeypatch.setenv("FLUTPU_NO_FUSED_PACK", "1")
    je, te = _blocks_pair()
    frames = _frames("ball", 64, 48, n=2)
    assert te.encode_gop(frames) == je.encode_gop(frames)


def test_segmented_resolves_explicit_then_environment(monkeypatch):
    assert JpegEncoder(device="cpu").segmented is True
    monkeypatch.setenv("FLUTPU_SEGMENTED", "0")
    assert JpegEncoder(device="cpu").segmented is False
    assert JpegEncoder(segmented=True, device="cpu").segmented is True
    monkeypatch.setenv("FLUTPU_SEGMENTED", "yes")
    assert JpegEncoder(device="cpu").segmented is True
    assert JpegEncoder(segmented=False, device="cpu").segmented is False


def test_cudajpegenc_segmented_property():
    """``segmented=false`` reaches the encoder, and a change rebuilds it."""
    bufs = pull_all(parse_launch, "videotestsrc num-buffers=5 pattern=ball "
                    "width=64 height=48 ! cudajpegenc device=cpu "
                    "batch-frames=4 segmented=false ! appsink name=out")
    want = JaxEncoder(quality=85, use_pallas=False).encode_gop(
        _frames("ball", 64, 48, n=5))
    assert [bytes(b.data) for b in bufs] == want
    el = make("cudajpegenc", device="cpu", segmented="false")
    assert el._get_encoder().segmented is False
    el.set_property("segmented", "true")
    assert el._get_encoder().segmented is True
