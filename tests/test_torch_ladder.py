"""The ABR ladder in flutpu_torch (``cudafvcladderenc``) against flutpu's
``fvcladderenc`` on the CPU.

Contract: ``parse_rungs`` is flutpu's; each rung's frames (bilinear on
the device, + 0.5, clipped, cast) lie within one level of flutpu's
(``jax.image.resize`` and torch's antialiased bilinear sum the filter
taps in other orders); each rung's chunk equals flutpu's ``FvcEncoder``
of that rung on the port's scaled frames, byte for byte; and with
``adaptive=true`` the rung on ``src_active`` is the one flutpu's element
picks for the same chunks and the same bandwidth readings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flutpu.codec import fvc as jf
from flutpu.codec import ladder as jl
from flutpu.codec.jpeg import encode_gop_planes_to_coefs
from flutpu.codec.ops.colorspace import scale_bilinear as j_scale
from flutpu.codec.ops.quant import CHROMA_QTABLE, LUMA_QTABLE, scale_qtable
from flutpu.core.elements import make_test_frame
from flutpu.fluc.bwmeter import BwMeter as JBwMeter
from flutpu_torch.codec import ladder as tl
from flutpu_torch.codec.ops import frontend as F
from flutpu_torch.core import MSECOND, Buffer, parse_launch
from flutpu_torch.fluc.bwmeter import BwMeter
from torch_helpers import tie_contract

torch.set_num_threads(1)

W, H = 128, 96
RUNGS = "128x96@88,64x48@80,40x24@70"


def _frames(n=8):
    return np.stack([make_test_frame("ball", W, H, i) for i in range(n)])


@pytest.mark.parametrize("spec", ["1920x1080@85, 960x540@80,480x270",
                                  "640x360", "1280x720@80,,640x360@75,",
                                  RUNGS])
def test_parse_rungs_equals_flutpus(spec):
    got, want = tl.parse_rungs(spec), jl.parse_rungs(spec)
    assert [(r.width, r.height, r.quality) for r in got] == \
        [(r.width, r.height, r.quality) for r in want]


@pytest.mark.parametrize("bad", ["", "x", "12x", "@85", "axb@c"])
def test_parse_rungs_refuses_what_flutpu_refuses(bad):
    with pytest.raises(ValueError):
        jl.parse_rungs(bad)
    with pytest.raises(ValueError):
        tl.parse_rungs(bad)


@pytest.mark.parametrize("rung", tl.parse_rungs(RUNGS + ",200x150@60"))
def test_scaled_frames_within_one_level(rung):
    """Same size, halves, a non-integer factor and an enlargement."""
    frames = _frames(3)
    got = tl.scale_rung(torch.from_numpy(frames), rung).numpy()
    want = np.asarray(jnp.clip(j_scale(jnp.asarray(frames), rung.height,
                                       rung.width) + 0.5, 0, 255)
                      .astype(jnp.uint8))
    assert got.shape == want.shape == (3, rung.height, rung.width, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _run_ladder(frames, opts, meter=None):
    """Frames through ``cudafvcladderenc device=cpu`` → ({pad: chunks},
    the src_active buffers)."""
    rungs = tl.parse_rungs(RUNGS)
    sinks = " ".join(f"lad.src_{i} ! appsink name=s{i}"
                     for i in range(len(rungs)))
    active = " lad.src_active ! appsink name=act" if "adaptive" in opts \
        else ""
    p = parse_launch(
        f"appsrc name=src caps='video/x-raw, format=RGB, width={W}, "
        f"height={H}, framerate=30/1' ! cudafvcladderenc name=lad "
        f"rungs='{RUNGS}' device=cpu {opts} {sinks}{active}")
    if meter is not None:
        p.get_by_name("lad")._meter = meter
    src = p.get_by_name("src")
    p.play()
    for i, f in enumerate(frames):
        src.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
    src.end_of_stream()
    out = {}
    for i in range(len(rungs)):
        s = p.get_by_name(f"s{i}")
        out[i] = []
        while (b := s.try_pull_buffer(timeout=30)) is not None:
            out[i].append(bytes(b.data))
    acts = []
    if active:  # one buffer per chunk (EOS is not forwarded there)
        s = p.get_by_name("act")
        acts = [s.try_pull_buffer(timeout=30) for _ in out[0]]
    p.stop()
    return out, acts


def _front_end_tie(scaled, rung):
    """Where a version 1 chunk splits from flutpu's: K1's plain version
    and flutpu's XLA front end give the same coefficients but ±1 at
    rounding ties (another fp32 summation order), on at most 1e-3 of
    them (``test_torch_frontend.py``'s contract)."""
    qy = scale_qtable(LUMA_QTABLE, rung.quality)
    qc = scale_qtable(CHROMA_QTABLE, rung.quality)
    ph, pw = -(-rung.height // 16) * 16, -(-rung.width // 16) * 16
    planes = [np.pad(scaled[..., c], ((0, 0), (0, ph - rung.height),
                                      (0, pw - rung.width)), mode="edge")
              for c in range(3)]
    got = F.front_end(*(torch.from_numpy(p) for p in planes),
                      torch.from_numpy(qy), torch.from_numpy(qc))
    want = encode_gop_planes_to_coefs(*(jnp.asarray(p) for p in planes),
                                      jnp.asarray(qy), jnp.asarray(qc), ph,
                                      pw)
    return sum(tie_contract(g.numpy(), np.asarray(w), 1e-3) > 0
               for g, w in zip(got, want))


@pytest.mark.parametrize("opts", ["gop-size=4", "gop-size=8 motion=true "
                                  "bframes=1"], ids=["v1", "motion-b"])
def test_rung_chunks_equal_flutpus_encoder(opts):
    """Every rung's chunk is flutpu's FvcEncoder's on the port's scaled
    frames (the rung's quality, motion and bframes). Version 1 chunks may
    split only at a front-end rounding tie (on this clip one luma
    coefficient of the 64x48 rung's second chunk)."""
    frames = _frames(8)
    motion = "motion=true" in opts
    gop = 8 if motion else 4
    out, _ = _run_ladder(frames, opts)
    for i, rung in enumerate(tl.parse_rungs(RUNGS)):
        assert len(out[i]) == 8 // gop
        je = jf.FvcEncoder(rung.quality, motion=motion,
                           bframes=1 if motion else 0)
        for k, chunk in enumerate(out[i]):
            scaled = tl.scale_rung(torch.from_numpy(
                frames[k * gop:(k + 1) * gop]), rung).numpy()
            want = je.encode_chunk(scaled)
            if motion or chunk == want:
                assert chunk == want
            else:
                assert len(chunk) == len(want)
                assert _front_end_tie(scaled, rung) > 0


def test_encode_ladder_chunk_reuses_encoders():
    frames = _frames(2)
    encoders = {}
    rungs = tl.parse_rungs(RUNGS)
    a = tl.encode_ladder_chunk(frames, rungs, encoders=encoders,
                               device="cpu")
    assert len(encoders) == 3
    first = dict(encoders)
    b = tl.encode_ladder_chunk(torch.from_numpy(frames), rungs,
                               encoders=encoders, device="cpu")
    assert a == b and all(encoders[k] is first[k] for k in first)


def _meter(cls, rates):
    """A meter fed windows of ``rates`` bytes per 0.2 s, in turn."""
    m = cls()
    m.session_start()
    m.data(0, _now=0.0)
    now = 0.0
    for nbytes in rates:
        now += 0.2
        m.data(nbytes, _now=now)
    return m


@pytest.mark.parametrize("rates", [[], [2000 * 1024], [2000 * 1024, 100],
                                   [100, 2000 * 1024],
                                   [100] + [400 * 1024] * 6, [5000]])
def test_select_rung_equals_flutpus(rates):
    """The same chunks and the same meter readings pick the same rung in
    both elements (no estimate yet, fast, throttled, the slow rise)."""
    chunks = [b"x" * n for n in (9000, 4000, 1500)]
    t = tl.CudaFvcLadderEnc(rungs=RUNGS, adaptive=True, device="cpu")
    j = jl.FvcLadderEnc()   # flutpu's takes its rungs after construction
    j.set_property("rungs", RUNGS)
    j.set_property("adaptive", True)
    t._meter, j._meter = _meter(BwMeter, rates), _meter(JBwMeter, rates)
    assert t._meter.stats() == j._meter.stats()
    for dur in (4 * MSECOND, 133 * MSECOND, None):
        assert t._select_rung(chunks, dur, 4) == \
            j._select_rung(chunks, dur, 4)


def test_adaptive_pad_follows_the_meter():
    """src_active: the top rung on a fast link, a lower one after a slow
    window (the estimate falls at once), every rung pad still carrying
    every chunk."""
    frames = _frames(8)
    meter = BwMeter()
    meter.session_start()
    meter.data(0, _now=0.0)
    meter.data(2000 * 1024, _now=0.2)

    class Throttle:
        """Reads the fast estimate for the first chunk, then throttles."""
        calls = 0

        def stats(self):
            Throttle.calls += 1
            if Throttle.calls == 2:
                meter.data(100, _now=0.9)
            return meter.stats()

    out, acts = _run_ladder(frames, "gop-size=4 adaptive=true", Throttle())
    assert [b.meta["rung"] for b in acts] == [0, 2]
    assert [bytes(b.data) for b in acts] == [out[0][0], out[2][1]]
    assert all(len(c) == 2 for c in out.values())


def test_device_defaults_to_the_card():
    el = tl.CudaFvcLadderEnc()
    assert str(el.get_property("device")) == "cuda"
    assert "device" not in {p.name for p in jl.FvcLadderEnc.PROPERTIES}
