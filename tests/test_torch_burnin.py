"""Subtitle burn-in in the encode path: the overlay branch of the front
end (kernel K1) and ``JpegEncoder(..., overlay=)`` against the JAX
package on the CPU (the CUDA kernel against its plain version on the
card: tests/test_torch_cuda.py).

Contract: the blend has no rounding ties (for 8-bit pixel, overlay and
alpha its value before the u8 round lies at least 1/510 from an integer),
so ``overlay_on_planes`` / ``overlay_on_frames`` equal flutpu's byte for
byte and the front end with an overlay equals the front end on planes
blended beforehand bit for bit; against the Pallas kernel (interpret
mode) and ``front_end_reference`` the coefficients hold K1's contract
(±1 on rounding ties of the DCT, on at most 1e-3 of them at test size);
the JFIF bytes with an overlay equal flutpu's
``JpegEncoder(use_pallas=False)``'s, in both bitstream layouts. The port
pads the frames first and blends second on every device, as flutpu's
kernel path does; flutpu's CPU path blends first, so the parity tests
feed frames already at the coded size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.jpeg import JpegEncoder as JaxEncoder
from flutpu.codec.ops.dct import blockize
from flutpu.codec.ops.frontend_pallas import (front_end_pallas,
                                              front_end_reference)
from flutpu.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                    scale_qtable, zigzag_flatten)
from flutpu.codec.ops.testsrc import gradient_ball_planes as j_ball_planes
from flutpu.core.elements import make_test_frame
from flutpu.ttml.render import composite as j_comp
from flutpu_torch.codec.jpeg import JpegEncoder, _planes_front_end
from flutpu_torch.codec.ops import frontend as F
from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
from flutpu_torch.ttml.render import composite as t_comp
from torch_helpers import rand_planes, tie_contract

torch.set_num_threads(1)

QY = scale_qtable(LUMA_QTABLE, 85)
QC = scale_qtable(CHROMA_QTABLE, 85)


def _overlay(h, w, seed=2):
    """A BGRA overlay with random colour and alpha, an opaque band, a
    half-transparent band and a transparent band."""
    rng = np.random.default_rng(seed)
    ov = rng.integers(0, 256, (h, w, 4), np.uint8)
    q = max(1, h // 5)
    ov[:q, :, 3] = 255
    ov[q:2 * q, :, 3] = 128
    ov[2 * q:3 * q, :, 3] = 0
    return ov


def _port(planes, overlay=None):
    r, g, b = (torch.from_numpy(p.copy()) for p in planes)
    ov = None if overlay is None else torch.from_numpy(overlay.copy())
    out = F.front_end(r, g, b, torch.from_numpy(QY), torch.from_numpy(QC),
                      overlay=ov)
    return [o.numpy() for o in out]


def _zz_planes(planes_out):
    return [np.asarray(zigzag_flatten(blockize(p))) for p in planes_out]


def _ovp(ov):
    return tuple(jnp.asarray(ov[..., c]) for c in (2, 1, 0, 3))


# -- the blend ------------------------------------------------------------------

def test_blend_has_no_rounding_tie():
    """2 * (p * (255 - k) + ov * k) is even, an odd multiple of 255 is
    not: o + 0.5 is never an integer, and the nearest miss is 1/510."""
    p, ov, k = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                           indexing="ij", sparse=True)
    twice = 2 * (p * (255 - k) + ov * k) + 255       # 510 * (o + 0.5)
    assert (twice % 510 != 0).all()
    r = twice % 510
    assert np.minimum(r, 510 - r).min() == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_overlay_on_planes_byte_identical(seed):
    planes = rand_planes(3, 48, 80, seed)
    ov = _overlay(48, 80, seed + 5)
    want = j_comp.overlay_on_planes(*(jnp.asarray(p) for p in planes),
                                    jnp.asarray(ov))
    got = t_comp.overlay_on_planes(*(torch.from_numpy(p) for p in planes),
                                   torch.from_numpy(ov))
    for a, c in zip(got, want):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_overlay_on_planes_every_pixel_overlay_alpha_triple():
    """All 256^3 (pixel, overlay, alpha) triples, both packages."""
    p = np.arange(256, dtype=np.uint8)
    plane = np.broadcast_to(p[:, None, None], (256, 256, 256)).copy()
    ov = np.zeros((256, 256, 4), np.uint8)
    ov[..., :3] = p[:, None, None]
    ov[..., 3] = p[None, :]
    want = j_comp.overlay_on_planes(*(jnp.asarray(plane),) * 3,
                                    jnp.asarray(ov))[0]
    got = t_comp.overlay_on_planes(*(torch.from_numpy(plane),) * 3,
                                   torch.from_numpy(ov))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overlay_on_frames_byte_identical():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 40, 56, 3), np.uint8)
    ov = _overlay(40, 56)
    want = np.asarray(j_comp.overlay_on_frames(jnp.asarray(frames),
                                               jnp.asarray(ov)))
    got = t_comp.overlay_on_frames(torch.from_numpy(frames),
                                   torch.from_numpy(ov)).numpy()
    np.testing.assert_array_equal(got, want)
    # and the planar form is the same blend
    planar = t_comp.overlay_on_planes(
        *(torch.from_numpy(frames[..., c].copy()) for c in range(3)),
        torch.from_numpy(ov))
    np.testing.assert_array_equal(np.stack([p.numpy() for p in planar], -1),
                                  want)


# -- the front end with an overlay ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel_interpret_with_overlay(seed):
    planes = rand_planes(2, 64, 256, seed)
    ov = _overlay(64, 256, seed + 2)
    want = _zz_planes(front_end_pallas(
        *(jnp.asarray(p) for p in planes), jnp.asarray(QY), jnp.asarray(QC),
        overlay_planes=_ovp(ov), interpret=True))
    for got, w in zip(_port(planes, ov), want):
        assert got.shape == w.shape and got.dtype == np.int16
        tie_contract(got, w, 1e-3)


def test_plain_matches_front_end_reference_with_overlay():
    planes = rand_planes(2, 64, 256, 4)
    ov = _overlay(64, 256, 6)
    want = _zz_planes(front_end_reference(
        *(jnp.asarray(p) for p in planes), jnp.asarray(QY), jnp.asarray(QC),
        overlay_planes=_ovp(ov)))
    for got, w in zip(_port(planes, ov), want):
        tie_contract(got, w, 1e-3)


def test_overlay_fold_bit_identical_to_blend_then_front_end():
    """The TPU test's contract
    (test_overlay_fold_byte_identical_to_blend_then_encode)."""
    planes = rand_planes(2, 64, 256, 1)
    ov = _overlay(64, 256)
    folded = _port(planes, ov)
    blended = t_comp.overlay_on_planes(
        *(torch.from_numpy(p) for p in planes), torch.from_numpy(ov))
    staged = _port([p.numpy() for p in blended])
    for a, c in zip(folded, staged):
        np.testing.assert_array_equal(a, c)
    assert any((a != c).any() for a, c in zip(folded, _port(planes)))


def test_alpha_zero_overlay_is_no_overlay():
    planes = rand_planes(1, 32, 64, 7)
    ov = _overlay(32, 64)
    ov[..., 3] = 0
    for a, c in zip(_port(planes, ov), _port(planes)):
        np.testing.assert_array_equal(a, c)


def test_smaller_overlay_leaves_the_rest_untouched():
    """Rows and columns past the overlay's size keep their value, as
    under the zero-alpha pad of flutpu's kernel path."""
    planes = rand_planes(1, 48, 64, 8)
    ov = _overlay(40, 50)
    full = np.zeros((48, 64, 4), np.uint8)
    full[:40, :50] = ov
    for a, c in zip(_port(planes, ov), _port(planes, full)):
        np.testing.assert_array_equal(a, c)
    none = _port(planes)
    got = _port(planes, ov)
    # luma blocks wholly outside the overlay (block rows 5.., columns 7..)
    np.testing.assert_array_equal(got[0][:, 5:], none[0][:, 5:])
    np.testing.assert_array_equal(got[0][:, :, 7:], none[0][:, :, 7:])


@pytest.mark.parametrize("ov", [
    pytest.param(np.zeros((33, 64, 4), np.uint8), id="taller"),
    pytest.param(np.zeros((32, 65, 4), np.uint8), id="wider"),
    pytest.param(np.zeros((32, 64, 3), np.uint8), id="three-channels"),
    pytest.param(np.zeros((32, 64, 4), np.float32), id="float")])
def test_rejects_overlays_the_kernel_does_not_take(ov):
    with pytest.raises(ValueError):
        _port(rand_planes(1, 32, 64, 9), ov)


# -- the encoder with an overlay ---------------------------------------------------

def _frames(pattern, w, h, n=3):
    return np.stack([make_test_frame(pattern, w, h, i) for i in range(n)])


def _pair(segmented, **state):
    je = JaxEncoder(quality=85, use_pallas=False, segmented=segmented)
    te = JpegEncoder.from_numpy_state(je.qy, je.qc, device="cpu",
                                      segmented=segmented, **state)
    return je, te


@pytest.mark.parametrize("segmented", [True, False])
@pytest.mark.parametrize("pattern,w,h", [("gradient", 64, 48),
                                         ("noise", 48, 32)])
def test_dispatch_with_overlay_byte_identical(pattern, w, h, segmented):
    je, te = _pair(segmented)
    frames = _frames(pattern, w, h)
    ov = _overlay(h, w)
    want = je.encode_gop_finalize(je.encode_gop_dispatch(
        jnp.asarray(frames), h, w, overlay=jnp.asarray(ov)))
    got = te.encode_gop_finalize(te.encode_gop_dispatch(
        torch.from_numpy(frames), h, w, overlay=torch.from_numpy(ov)))
    assert got == want
    assert got != te.encode_gop(frames)
    # numpy overlays are taken too
    assert te.encode_gop_finalize(te.encode_gop_dispatch(
        torch.from_numpy(frames), h, w, overlay=ov)) == want


@pytest.mark.parametrize("segmented", [True, False])
def test_dispatch_src_with_overlay_byte_identical(segmented):
    """The config-5 entry point: on-device source + overlay. The source
    planes come from one package (flutpu's jitted red ramp rounds through
    a reciprocal at some widths), fed to both encoders."""
    je, te = _pair(segmented)
    h, w = 48, 64
    ov = _overlay(h, w, 11)
    planes = [np.asarray(p) for p in j_ball_planes(h, w, 4, jnp.float32(8))]
    want = je.encode_gop_finalize(je.encode_gop_dispatch_src(
        lambda ph, pw, start: tuple(jnp.asarray(p) for p in planes),
        jnp.float32(8), h, w, h, w, overlay=jnp.asarray(ov)))
    got = te.encode_gop_finalize(te.encode_gop_dispatch_src(
        lambda ph, pw, start: tuple(torch.from_numpy(p.copy())
                                    for p in planes),
        8, h, w, h, w, overlay=torch.from_numpy(ov)))
    assert got == want
    # interleaved sources are split into planes
    inter = torch.from_numpy(np.stack(planes, -1))
    assert te.encode_gop_finalize(te.encode_gop_dispatch_src(
        lambda ph, pw, start: inter, 8, h, w, h, w,
        overlay=torch.from_numpy(ov))) == want


@pytest.mark.parametrize("segmented,state", [
    (True, dict(seg_words=2)), (True, dict(prefix_window=16)),
    (False, dict(prefix_window=16))])
def test_overflow_redispatch_blends_again(segmented, state):
    """The overlay rides in the redispatch closure."""
    je, te = _pair(segmented, **state)
    frames = _frames("noise", 48, 32, n=2)
    ov = _overlay(32, 48, 13)
    want = je.encode_gop_finalize(je.encode_gop_dispatch(
        jnp.asarray(frames), 32, 48, overlay=jnp.asarray(ov)))
    handle = te.encode_gop_dispatch(torch.from_numpy(frames), 32, 48,
                                    overlay=torch.from_numpy(ov))
    assert te.encode_gop_finalize(handle) == want
    assert (te.scans._seg_words, te.scans._prefix_window) != (
        state.get("seg_words", te.SEG_WORDS0), state.get("prefix_window"))


def test_port_source_with_overlay_decodes_to_the_blend():
    """The port's own source through ``overlay=``: the scan decodes to
    the front end's coefficients of the blended planes."""
    from flutpu_torch.codec.decode import decode_scan_to_coefs, parse_jfif
    te = JpegEncoder(85, device="cpu")
    ov = torch.from_numpy(_overlay(48, 64))
    src = lambda ph, pw, start: gradient_ball_planes(  # noqa: E731
        ph, pw, 2, start, device="cpu")
    out = te.encode_gop_finalize(te.encode_gop_dispatch_src(
        src, 0, 48, 64, 48, 64, overlay=ov))
    blended = t_comp.overlay_on_planes(*src(48, 64, 0), ov)
    coefs = _planes_front_end(*blended, te.scans.qy_dev, te.scans.qc_dev, 48,
                              64)
    for i, data in enumerate(out):
        dec = decode_scan_to_coefs(parse_jfif(data)["scan"], 8, 6, 4, 3, True)
        for a, c in zip(dec, coefs):
            np.testing.assert_array_equal(a, c[i].numpy())


def test_pad_then_blend_differs_from_flutpus_cpu_order():
    """Found in the reference: with source planes that need padding,
    flutpu pads and then blends under alpha 0 on an accelerator, but
    blends and then edge-pads the BLENDED planes on the CPU (where the
    overlay must also have exactly the planes' size). The port pads first
    on every device. An overlay touching the last row then gives other
    bytes: the pad rows repeat the unblended last row in the port, the
    blended one in flutpu's CPU path."""
    je, te = _pair(True)
    h, w, ph = 40, 64, 48
    frames = _frames("gradient", w, h, n=2)

    def encode(ov):
        want = je.encode_gop_finalize(je.encode_gop_dispatch_src(
            lambda ph_, pw_, start: jnp.asarray(frames), 0, h, w, ph, w,
            overlay=jnp.asarray(ov)))
        got = te.encode_gop_finalize(te.encode_gop_dispatch_src(
            lambda ph_, pw_, start: torch.from_numpy(frames), 0, h, w, ph, w,
            overlay=torch.from_numpy(ov)))
        return got, want

    ov = np.zeros((h, w, 4), np.uint8)
    ov[h - 4:, :] = (0, 0, 255, 255)                 # opaque, last rows
    got, want = encode(ov)
    assert got != want
    # the port's order, spelled out: pad, then blend under the zero pad
    padded = np.pad(frames, ((0, 0), (0, ph - h), (0, 0), (0, 0)),
                    mode="edge")
    full = np.zeros((ph, w, 4), np.uint8)
    full[:h] = ov
    blended = t_comp.overlay_on_frames(torch.from_numpy(padded),
                                       torch.from_numpy(full))
    assert got == te.encode_gop_finalize(te.encode_gop_dispatch(blended, h, w))
    # flutpu's CPU order: blend, then pad the blended frames
    pre = np.asarray(j_comp.overlay_on_frames(jnp.asarray(frames),
                                              jnp.asarray(ov)))
    assert want == je.encode_gop(pre)
    # an overlay that stays off the last row gives equal bytes
    ov2 = np.zeros((h, w, 4), np.uint8)
    ov2[4:20, 8:40] = (10, 200, 30, 180)
    got, want = encode(ov2)
    assert got == want
