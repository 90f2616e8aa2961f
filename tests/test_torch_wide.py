"""Width 3840 through flutpu_torch on the CPU, against flutpu: 4K-wide
strips (32 rows) of the front end, the gradient-ball source and the JPEG
GOP encode, where no card runs the 2160x3840 frames of the card-side
checks. Also: the test source's ramp pinned to its closed form, the
burn-in element's prewarm against flutpu's, and the C entries the
ctypes binding names against the kernel sources."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec.jpeg import JpegEncoder as JaxEncoder
from flutpu.codec.jpeg import encode_gop_planes_to_coefs
from flutpu.codec.ops.dct import blockize
from flutpu.codec.ops.frontend_pallas import front_end_pallas
from flutpu.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                    scale_qtable, zigzag_flatten)
from flutpu.codec.ops.testsrc import gradient_ball_planes as j_ball_planes
from flutpu.core import Caps as JCaps
from flutpu.core.elements import make_test_frame
from flutpu.ttml.render.overlay_el import OverlayCompositor as JCompositor
from flutpu_torch import _build
from flutpu_torch.codec.jpeg import JpegEncoder
from flutpu_torch.codec.ops import frontend as F
from flutpu_torch.codec.ops.testsrc import (gradient_ball_frames,
                                            gradient_ball_planes)
from flutpu_torch.core import Caps
from flutpu_torch.ttml.render.overlay_el import OverlayCompositor
from torch_helpers import rand_planes, tie_contract

torch.set_num_threads(1)

QY = scale_qtable(LUMA_QTABLE, 85)
QC = scale_qtable(CHROMA_QTABLE, 85)
WIDE = 3840


def _port_front_end(planes):
    out = F.front_end(*(torch.from_numpy(p.copy()) for p in planes),
                      torch.from_numpy(QY), torch.from_numpy(QC))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("arm", ["xla", "pallas-interpret"])
def test_front_end_4k_wide_strip(arm):
    """K1's plain version on a (2, 32, 3840) strip against flutpu's CPU
    arm and its Pallas kernel in interpret mode: equal except ±1 on
    rounding ties, on at most 1e-3 of the coefficients (the summation
    orders differ)."""
    planes = rand_planes(2, 32, WIDE, seed=21)
    j = [jnp.asarray(p) for p in planes]
    if arm == "xla":
        want = [np.asarray(c) for c in encode_gop_planes_to_coefs(
            *j, jnp.asarray(QY), jnp.asarray(QC), pad_h=32, pad_w=WIDE)]
    else:
        want = [np.asarray(zigzag_flatten(blockize(p)))
                for p in front_end_pallas(*j, jnp.asarray(QY),
                                          jnp.asarray(QC), interpret=True)]
    got = _port_front_end(planes)
    assert got[0].shape == (2, 4, WIDE // 8, 64)
    assert got[1].shape == got[2].shape == (2, 2, WIDE // 16, 64)
    for a, c in zip(got, want):
        assert a.dtype == np.int16 and a.shape == c.shape
        tie_contract(a, c, 1e-3)


def _closed_form_ramps(h, w):
    """The source's red and green ramps as its definition gives them:
    floor(x * 255 / (w - 1)) with both steps in float32 (IEEE)."""
    x = np.arange(w, dtype=np.float32)
    y = np.arange(h, dtype=np.float32)
    red = (x * np.float32(255.0) / np.float32(w - 1)).astype(np.uint8)
    green = (y * np.float32(255.0) / np.float32(h - 1)).astype(np.uint8)
    return red, green


@pytest.mark.parametrize("h,w", [(96, 160), (32, WIDE)])
def test_gradient_ball_ramps_keep_their_closed_form(h, w):
    """The ramps divide by a tensor (so that the card divides as the CPU
    does); on the CPU that is the same IEEE division as before, pinned
    here to the closed form outside the ball."""
    r, g, b = (p.numpy() for p in gradient_ball_planes(h, w, 3, 5,
                                                       device="cpu"))
    red, green = _closed_form_ramps(h, w)
    ball = (r == 255) & (g == 255) & (b == 255)
    assert 0 < ball.sum() < ball.size // 4
    np.testing.assert_array_equal(
        r, np.where(ball, 255, np.broadcast_to(red[None, None, :], r.shape)))
    np.testing.assert_array_equal(
        g, np.where(ball, 255, np.broadcast_to(green[None, :, None],
                                               g.shape)))
    for i in range(3):
        np.testing.assert_array_equal(
            b[i][~ball[i]], np.uint8(((5 + i) * 5) % 256))
    frames = gradient_ball_frames(h, w, 3, 5, device="cpu").numpy()
    np.testing.assert_array_equal(frames, np.stack([r, g, b], -1))


def test_gradient_ball_planes_4k_wide_against_flutpu():
    """Green, blue and the ball agree exactly; flutpu's jitted red ramp
    goes through the reciprocal of w - 1 and may lie one level lower at a
    few columns (as at w = 160), never elsewhere."""
    got = [p.numpy() for p in gradient_ball_planes(32, WIDE, 2, 8,
                                                   device="cpu")]
    want = [np.asarray(p) for p in j_ball_planes(32, WIDE, 2,
                                                 jnp.float32(8))]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    d = got[0].astype(np.int32) - want[0].astype(np.int32)
    assert d.min() >= 0 and d.max() <= 1
    cols = np.nonzero((d != 0).any(axis=(0, 1)))[0]
    assert len(cols) <= WIDE // 50


@pytest.mark.parametrize("pattern", ["gradient", "ball"])
@pytest.mark.parametrize("segmented", [True, False])
def test_jpeg_gop_4k_wide_byte_identical(pattern, segmented):
    """Two 32x3840 frames: the port's JFIF bytes equal flutpu's, in both
    bitstream layouts, through encode_gop and through dispatch_src on
    planes."""
    frames = np.stack([make_test_frame(pattern, WIDE, 32, i)
                       for i in range(2)])
    je = JaxEncoder(quality=85, use_pallas=False)
    te = JpegEncoder.from_numpy_state(je.qy, je.qc, segmented=segmented,
                                      device="cpu")
    want = je.encode_gop(frames)
    assert te.encode_gop(frames) == want
    planes = tuple(torch.from_numpy(np.ascontiguousarray(frames[..., c]))
                   for c in range(3))
    assert te.encode_gop_finalize(te.encode_gop_dispatch_src(
        lambda ph, pw, start: planes, 0, 32, WIDE, 32, WIDE)) == want


@pytest.mark.parametrize("fields,expect", [
    (None, False), ({}, False), ({"width": 64}, False),
    ({"width": 64, "height": 48}, True)])
def test_overlay_compositor_prewarm_matches_flutpu(fields, expect):
    """prewarm runs the blend once at the caps' geometry and says so;
    without caps, or without a width and a height, it declines."""
    j_caps = None if fields is None else JCaps.new("video/x-raw", **fields)
    caps = None if fields is None else Caps.new("video/x-raw", **fields)
    assert JCompositor().prewarm(j_caps) is expect
    assert OverlayCompositor(device="cpu").prewarm(caps) is expect


def test_build_binds_every_c_entry():
    """Every ``extern "C"`` function of csrc/*.cu gets its argument types
    in ``_build._configure``, and nothing else does: a renamed or new
    entry shows here, not first on the card."""
    defined = set()
    for path in _build.source_paths():
        with open(path) as fh:
            text = fh.read()
        assert 'extern "C"' in text, path
        defined |= set(re.findall(r"^int (flu_\w+)\(", text, re.M))

    class Recorder:
        def __init__(self):
            self.names = {}

        def __getattr__(self, name):
            return self.names.setdefault(name, type("Fn", (), {})())

    lib = Recorder()
    _build._configure(lib)
    assert defined and set(lib.names) == defined
    for name, fn in lib.names.items():
        assert fn.restype is not None and len(fn.argtypes) >= 2, name
    assert set(_build.SOURCES) == {
        f for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu")}
