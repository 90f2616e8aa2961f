"""The host entropy engine and the coefficient-level API: flutpu_torch
against flutpu on the CPU.

Contract: the port's host scan coder (``encode_scan``: the native coder,
held to ``encode_scan_python``) gives flutpu's bytes; ``engine="host"``
on ``JpegEncoder``, ``cudajpegenc``, ``FvcEncoder`` and ``cudafvcenc``
gives flutpu's ``engine="host"`` bytes and the port's own device
engine's; ``encode_gop_to_coefs`` / ``encode_gop_planes_to_coefs`` give
flutpu's coefficients but for ±1 at rounding ties; ``rgb_to_ycbcr*``
flutpu's planes within 1e-4; ``encode_gop_scans`` flutpu's words and
bits, fused (K7's plain version) and not (K8a's). ``"auto"`` never
reaches the host coder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flutpu.core
import flutpu_torch.core
from flutpu.codec import fvc as jf
from flutpu.codec import jpeg as jj
from flutpu.codec.ops import colorspace as j_cs
from flutpu.codec.ops import entropy as j_entropy
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec import jpeg as tj
from flutpu_torch.codec import scans as ts
from flutpu_torch.codec.fvc import FvcEncoder
from flutpu_torch.codec.jpeg import JpegEncoder
from flutpu_torch.codec.ops import colorspace as t_cs
from flutpu_torch.codec.ops import entropy as t_entropy
from test_torch_fvc import _subpel_tie_contract
from torch_helpers import pull_all, tie_contract

torch.set_num_threads(1)

SIZES = [(48, 64), (96, 160)]


def _frames(pattern, h, w, n=4, start=0):
    return np.stack([make_test_frame(pattern, w, h, i)
                     for i in range(start, start + n)])


def _j_coefs(frames, subsample):
    je = jj.JpegEncoder(85, subsample=subsample, use_pallas=False)
    mult = 16 if subsample else 8
    h, w = frames.shape[1:3]
    ph, pw = -(-h // mult) * mult, -(-w // mult) * mult
    coefs = jj.encode_gop_to_coefs(jnp.asarray(frames), je._qy_dev,
                                   je._qc_dev, pad_h=ph, pad_w=pw,
                                   subsample=subsample)
    return je, ph, pw, [np.asarray(c) for c in coefs]


# -- the host scan coder ------------------------------------------------------

@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("pattern", ["ball", "noise"])
def test_encode_scan_equals_flutpus(pattern, subsample):
    """Sparse (gradient-ball) and dense (uniform-noise) coefficients: the
    port's scan of every frame equals flutpu's, and its native coder
    equals the Python one."""
    _, _, _, (y, cb, cr) = _j_coefs(_frames(pattern, 48, 64), subsample)
    lib = ts.native.get_lib()
    assert lib is not None
    for i in range(y.shape[0]):
        want = jj.encode_scan(y[i], cb[i], cr[i], subsample)
        assert ts.encode_scan(y[i], cb[i], cr[i], subsample) == want
        assert ts._encode_scan_native(lib, y[i], cb[i], cr[i],
                                      subsample) == want
        assert ts.encode_scan_python(y[i], cb[i], cr[i], subsample) == want


def test_encode_scan_without_the_native_library(monkeypatch):
    """Where the native library is absent, ``encode_scan`` takes the
    Python coder: the same bytes."""
    _, _, _, (y, cb, cr) = _j_coefs(_frames("ball", 48, 64, n=1), True)
    want = ts.encode_scan(y[0], cb[0], cr[0], True)
    monkeypatch.setattr(ts.native, "get_lib", lambda: None)
    assert ts.encode_scan(y[0], cb[0], cr[0], True) == want


def test_native_tables_are_flutpus():
    mine, theirs = ts._native_tables(), jj._native_tables()
    assert mine.keys() == theirs.keys()
    for name in mine:
        for a, b in zip(mine[name], theirs[name]):
            assert a.dtype == b.dtype and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)


# -- JpegEncoder and cudajpegenc ---------------------------------------------

@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("pattern", ["ball", "noise"])
@pytest.mark.parametrize("h,w", SIZES)
def test_jpeg_host_engine_equals_flutpus(pattern, subsample, h, w):
    frames = _frames(pattern, h, w)
    want = jj.JpegEncoder(85, subsample=subsample, engine="host",
                          use_pallas=False).encode_gop(frames)
    host = JpegEncoder(85, subsample=subsample, engine="host", device="cpu")
    assert host.encode_gop(frames) == want
    assert JpegEncoder(85, subsample=subsample, device="cpu").encode_gop(
        frames) == want


def test_jpeg_host_engine_from_numpy_state():
    je = jj.JpegEncoder(70, engine="host", use_pallas=False)
    te = JpegEncoder.from_numpy_state(je.qy, je.qc, engine="host",
                                      device="cpu")
    assert te.engine == "host"
    frames = _frames("ball", 48, 64)
    assert te.encode_gop(frames) == je.encode_gop(frames)


def test_jpeg_host_dispatch_finalize_and_source():
    """Two GOPs in flight, the on-device source and a burned-in overlay:
    the host engine's handles finalize to the device engine's bytes."""
    host = JpegEncoder(85, engine="host", device="cpu")
    dev = JpegEncoder(85, device="cpu")
    frames = torch.from_numpy(_frames("ball", 48, 64, n=6))
    rng = np.random.default_rng(3)
    overlay = torch.from_numpy(rng.integers(0, 256, (32, 48, 4), np.uint8))
    # two GOPs dispatched before either is finalized, on each engine
    handles = [(e.encode_gop_dispatch(frames[:3], 48, 64),
                e.encode_gop_dispatch(frames[3:], 48, 64, overlay=overlay))
               for e in (host, dev)]
    for k in range(2):
        assert host.encode_gop_finalize(handles[0][k]) == \
            dev.encode_gop_finalize(handles[1][k])

    def src(ph, pw, start):
        return tuple(frames[start:start + 3, ..., c].contiguous()
                     for c in range(3))

    got = host.encode_gop_finalize(host.encode_gop_dispatch_src(
        src, 1, 48, 64, 48, 64))
    assert got == dev.encode_gop_finalize(dev.encode_gop_dispatch_src(
        src, 1, 48, 64, 48, 64))


@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
def test_scan_planes_honours_the_engine(subsample):
    je, _, _, coefs = _j_coefs(_frames("noise", 48, 64), subsample)
    want = jj.JpegEncoder(85, subsample=subsample, engine="host",
                          use_pallas=False).scan_planes(coefs)
    for engine in ("host", "device"):
        te = JpegEncoder(85, subsample=subsample, engine=engine,
                         device="cpu")
        assert te.scan_planes([torch.from_numpy(c.copy())
                               for c in coefs]) == want
    host = JpegEncoder(85, subsample=subsample, engine="host", device="cpu")
    assert host.scan_planes(coefs) == want      # host arrays as they are


def test_unknown_engine_is_refused():
    """flutpu would take any other word as the host engine; the port
    names the three it has."""
    with pytest.raises(ValueError, match="auto | device | host"):
        JpegEncoder(engine="gpu", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        FvcEncoder(engine="cpu", device="cpu")


def test_cudajpegenc_host_engine_equals_tpujpegenc():
    line = ("videotestsrc num-buffers=6 pattern=ball width=64 height=48 ! "
            "{} batch-frames=4 engine=host ! appsink name=out")
    want = pull_all(flutpu.core.parse_launch, line.format("tpujpegenc"))
    got = pull_all(flutpu_torch.core.parse_launch,
                   line.format("cudajpegenc device=cpu"))
    assert len(got) == 6
    assert [bytes(b.data) for b in got] == [bytes(b.data) for b in want]
    assert [b.pts for b in got] == [b.pts for b in want]


def test_auto_never_reaches_the_host_coder(monkeypatch):
    """A GOP whose segments and prefix window overflow is redispatched on
    the device, and one past the theoretical bounds raises: neither codes
    on the host (flutpu's ``auto`` would fall back to it)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the host coder ran")

    monkeypatch.setattr(ts.ScanCoder, "_code_on_host", refuse)
    monkeypatch.setattr(ts, "encode_scan", refuse)
    frames = _frames("noise", 48, 64)
    je = jj.JpegEncoder(85, use_pallas=False)
    want = je.encode_gop(frames)
    for engine in ("auto", "device"):
        te = JpegEncoder.from_numpy_state(je.qy, je.qc, seg_words=2,
                                          prefix_window=8, engine=engine,
                                          device="cpu")
        assert te.encode_gop(frames) == want
        te = JpegEncoder(85, engine=engine, device="cpu")
        te.scans.BLOCK_BITS_BOUND = 8   # a bound no real content fits
        with pytest.raises(OverflowError):
            te.encode_gop(frames)
    fe = FvcEncoder(85, motion=True, device="cpu")
    fe.scans.BLOCK_BITS_BOUND = 8
    with pytest.raises(OverflowError):
        fe.encode_chunk(frames)


# -- FvcEncoder and cudafvcenc ------------------------------------------------

FVC_CONFIGS = {
    "v1": {},
    "v1-444": {"subsample": False},
    "P": {"motion": True},
    "P-hier": {"motion": True, "hier": True},
    "B": {"motion": True, "bframes": 1},
    "half-pel": {"motion": True, "subpel": True},
}


#: (config, clip) where a float64-verified near-tie of the half-pel cost
#: splits the packages' vectors (the one ``test_torch_fvc.py`` states)
SUBPEL_TIES = {("half-pel", "ball")}


@pytest.mark.parametrize("clip", ["ball", "noise"])
@pytest.mark.parametrize("config", list(FVC_CONFIGS))
def test_fvc_host_engine_equals_flutpus(config, clip):
    """The port's host engine gives its device engine's chunk byte for
    byte, and flutpu's ``engine="host"`` chunk: byte-identical, or on the
    half-pel ball clip under ``_subpel_tie_contract``."""
    kw = FVC_CONFIGS[config]
    frames = _frames(clip, 96, 160, n=8)
    je = jf.FvcEncoder(85, engine="host", **kw)
    want = je.encode_chunk(frames)
    te = FvcEncoder.from_numpy_state(
        je.qy, je.qc, je.search_range, motion=je.motion, hier=je.hier,
        subpel=je.subpel, subsample=je.subsample, bframes=je.bframes,
        bquality=je.bquality, engine="host", device="cpu")
    assert te.engine == te.scans.engine == "host"
    got = te.encode_chunk(frames)
    assert got == FvcEncoder(85, device="cpu", **kw).encode_chunk(frames)
    if (config, clip) in SUBPEL_TIES:
        assert got != want
        assert _subpel_tie_contract(frames, je, te) == 1
    else:
        assert got == want


def test_fvc_host_dispatch_keeps_chunks_in_flight():
    enc = FvcEncoder(85, motion=True, engine="host", device="cpu")
    frames = _frames("ball", 48, 64, n=8)
    handles = [enc.encode_chunk_dispatch(frames[:4]),
               enc.encode_chunk_dispatch(frames[4:])]
    got = [enc.encode_chunk_finalize(h) for h in handles]
    dev = FvcEncoder(85, motion=True, device="cpu")
    assert got == [dev.encode_chunk(frames[:4]), dev.encode_chunk(frames[4:])]


SRC_CONFIGS = {"v1": {}, "P": {"motion": True}}


@pytest.mark.parametrize("config", list(SRC_CONFIGS))
@pytest.mark.parametrize("entry", ["src", "batch", "counts", "element",
                                   "chunks"])
def test_fvc_host_engine_codes_source_fed_entries_refuses_chunks(entry,
                                                                 config):
    """The source-fed entries, alone and batched, code through the host
    engine: flutpu's ``engine="host"`` bytes on the same entry (flutpu
    codes them on the device) and the port's device engine's, also where
    the batch finalizes through ``encode_chunks_finalize`` with
    ``counts``; so does ``cudafvcenc engine=host`` from ``videotestsrc``
    against ``fvcenc``.
    The multi-chunk dispatch, which flutpu has no engine for, raises
    instead of coding on the device."""
    import jax
    kw = SRC_CONFIGS[config]
    enc = FvcEncoder(85, engine="host", device="cpu", **kw)
    if entry == "chunks":
        with pytest.raises(ValueError, match="engine='host'"):
            enc.encode_chunks_dispatch(np.zeros((2, 4, 48, 64, 3), np.uint8))
        return
    if entry == "element":
        opts = "motion=true" if kw else ""
        line = ("videotestsrc num-buffers=4 pattern=ball width=64 height=48 "
                "! {} gop-size=4 engine=host " + opts + " ! appsink name=out")
        want = pull_all(flutpu.core.parse_launch, line.format("fvcenc"))
        got = pull_all(flutpu_torch.core.parse_launch,
                       line.format("cudafvcenc device=cpu"))
        assert len(got) == 1
        assert [bytes(b.data) for b in got] == [bytes(b.data) for b in want]
        return
    frames = _frames("ball", 48, 64, n=8)
    jframes = jnp.asarray(frames)

    def j_src(ph, pw, n, start):
        # flutpu's batched program hands the start as a float32 scalar
        return jax.lax.dynamic_slice_in_dim(
            jframes, jnp.asarray(start).astype(jnp.int32), n)

    def t_src(ph, pw, n, start):
        return torch.from_numpy(frames[start:start + n])

    je = jf.FvcEncoder(85, engine="host", **kw)
    dev = FvcEncoder(85, device="cpu", **kw)
    if entry == "counts":
        got, same = (e.encode_chunks_finalize(
            e.encode_chunk_batch_dispatch_src(t_src, 0, 4, 48, 64, batch=2),
            counts=[4, 2]) for e in (enc, dev))
        assert got == same and len(got) == 2
        assert got[1] == enc.encode_chunk(frames[4:6])
        return
    if entry == "src":
        want = [je.encode_chunk_finalize(je.encode_chunk_dispatch_src(
            j_src, 4, 4, 48, 64))]
        got = [enc.encode_chunk_finalize(enc.encode_chunk_dispatch_src(
            t_src, 4, 4, 48, 64))]
        same = [dev.encode_chunk_finalize(dev.encode_chunk_dispatch_src(
            t_src, 4, 4, 48, 64))]
    else:
        want = je.encode_chunk_batch_finalize(
            je.encode_chunk_batch_dispatch_src(j_src, 0, 4, 48, 64, batch=2))
        got = enc.encode_chunk_batch_finalize(
            enc.encode_chunk_batch_dispatch_src(t_src, 0, 4, 48, 64,
                                                batch=2))
        same = dev.encode_chunk_batch_finalize(
            dev.encode_chunk_batch_dispatch_src(t_src, 0, 4, 48, 64,
                                                batch=2))
        assert got == [enc.encode_chunk(frames[:4]),
                       enc.encode_chunk(frames[4:])]
    assert len(got) == len(want) and got == want
    assert got == same


@pytest.mark.parametrize("opts", ["", "motion=true", "motion=true bframes=1"])
def test_cudafvcenc_host_engine_equals_fvcenc(opts):
    line = ("videotestsrc num-buffers=8 pattern=ball width=64 height=48 ! "
            "{} gop-size=4 engine=host " + opts + " ! appsink name=out")
    want = pull_all(flutpu.core.parse_launch, line.format("fvcenc"))
    got = pull_all(flutpu_torch.core.parse_launch,
                   line.format("cudafvcenc device=cpu"))
    assert len(got) == 2
    assert [bytes(b.data) for b in got] == [bytes(b.data) for b in want]


# -- the coefficient-level API ------------------------------------------------

@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("pattern", ["ball", "noise"])
@pytest.mark.parametrize("h,w", [(40, 56), (96, 160)])
def test_encode_gop_to_coefs_matches_flutpus(pattern, subsample, h, w):
    """Interleaved and channel-planar entries, frames padded here: equal
    to flutpu's but for ±1 at rounding ties (the front end's contract),
    and to each other exactly."""
    frames = _frames(pattern, h, w)
    je, ph, pw, want = _j_coefs(frames, subsample)
    qy, qc = (torch.from_numpy(np.asarray(t)) for t in (je.qy, je.qc))
    got = tj.encode_gop_to_coefs(torch.from_numpy(frames), qy, qc, ph, pw,
                                 subsample)
    planes = tj.encode_gop_planes_to_coefs(
        *(torch.from_numpy(np.ascontiguousarray(frames[..., c]))
          for c in range(3)), je.qy, je.qc, ph, pw, subsample=subsample)
    j_planes = jj.encode_gop_planes_to_coefs(
        *(jnp.asarray(frames[..., c]) for c in range(3)), je._qy_dev,
        je._qc_dev, pad_h=ph, pad_w=pw, subsample=subsample)
    for g, p, w_, jp in zip(got, planes, want, j_planes):
        assert g.dtype == torch.int16 and g.shape == w_.shape
        assert torch.equal(g, p)
        np.testing.assert_array_equal(w_, np.asarray(jp))
        tie_contract(g.numpy(), w_, 1e-4)


def test_encode_gop_planes_to_coefs_takes_uint8_only():
    p = torch.zeros((1, 16, 16), dtype=torch.float32)
    q = torch.ones((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        tj.encode_gop_planes_to_coefs(p, p, p, q, q, 16, 16)


def test_rgb_to_ycbcr_matches_flutpus():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (2, 24, 40, 3), np.uint8)
    want = [np.asarray(p) for p in j_cs.rgb_to_ycbcr_planes(
        jnp.asarray(rgb))]
    got = t_cs.rgb_to_ycbcr_planes(torch.from_numpy(rgb))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=1e-4)
    stacked = t_cs.rgb_to_ycbcr(torch.from_numpy(rgb))
    assert stacked.shape == rgb.shape
    np.testing.assert_allclose(stacked.numpy(),
                               np.asarray(j_cs.rgb_to_ycbcr(
                                   jnp.asarray(rgb))), rtol=0, atol=1e-4)
    for c in range(3):
        assert torch.equal(stacked[..., c], got[c])


@pytest.mark.parametrize("fused", [True, False], ids=["K7", "K8a"])
@pytest.mark.parametrize("pattern", ["ball", "noise"])
def test_encode_gop_scans_matches_flutpus(pattern, fused):
    """Words and bits per frame equal flutpu's ``encode_gop_scans``, also
    with a window smaller than the noise GOP's scans (bits counted past
    it)."""
    _, ph, pw, coefs = _j_coefs(_frames(pattern, 48, 64), True)
    layout = t_entropy.mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
    j_layout = j_entropy.mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16,
                                    True)
    for out_words in (2048, 64):
        packed, bits = t_entropy.encode_gop_scans(
            *(torch.from_numpy(c.copy()) for c in coefs), layout, out_words,
            fused=fused)
        j_packed, j_bits = j_entropy.encode_gop_scans(
            *(jnp.asarray(c) for c in coefs), layout=j_layout,
            out_words=out_words, fused=fused)
        assert packed.shape == (4, out_words) and bits.dtype == torch.int32
        np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits))
        np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                      np.asarray(j_packed))


def test_encode_gop_scans_resolves_the_variant(monkeypatch):
    """``fused=None`` reads FLUTPU_NO_FUSED_PACK as flutpu does: K8a's
    route under 1, K7's otherwise; the words are the same."""
    _, ph, pw, coefs = _j_coefs(_frames("ball", 48, 64, n=2), True)
    layout = t_entropy.mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
    args = [torch.from_numpy(c.copy()) for c in coefs]
    calls = []
    for name in ("pack_block_bits_fused", "pack_block_bits64"):
        real = getattr(t_entropy, name)
        monkeypatch.setattr(t_entropy, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    outs = []
    for env in ("0", "1"):
        monkeypatch.setenv("FLUTPU_NO_FUSED_PACK", env)
        outs.append(t_entropy.encode_gop_scans(*args, layout, 512))
    assert calls == ["pack_block_bits_fused", "pack_block_bits64"]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
