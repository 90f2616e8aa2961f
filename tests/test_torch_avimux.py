"""The port's ``avimux``/``avidemux`` (a copy of flutpu's on the port's
core) against flutpu's: the same code; ``cudajpegenc device=cpu !
avimux`` gives the same AVI bytes as flutpu's ``tpujpegenc ! avimux`` on
the same frames; and the scenarios of tests/test_avimux.py (structure,
the round trip through ``cudajpegdec device=cpu``, streaming before EOS,
a long stream in bounded memory, fragmentation, an odd LIST pad byte,
corrupt sizes, an audio-first file, flushes) give the same results
through both packages' cores."""

import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

import flutpu.codec.avimux as j_avimux
import flutpu.core
import flutpu.core.events as j_events
import flutpu_torch.codec.avimux as t_avimux
import flutpu_torch.core
import flutpu_torch.core.events as t_events
from flutpu.codec.jpeg import psnr
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec.jpeg import decode_jpeg
from torch_helpers import code_of

torch.set_num_threads(1)

MS = 1_000_000
CORES = [pytest.param(flutpu.core, j_avimux, j_events, id="flutpu"),
         pytest.param(flutpu_torch.core, t_avimux, t_events, id="port")]
#: each package's JPEG encoder and decoder element, as a launch fragment
ENC = {flutpu.core: "tpujpegenc", flutpu_torch.core: "cudajpegenc device=cpu"}
DEC = {flutpu.core: "jpegdec", flutpu_torch.core: "cudajpegdec device=cpu"}


def _chunk(fourcc, payload):
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind, payload):
    body = kind + payload
    pad = b"\x00" if len(body) & 1 else b""
    return b"LIST" + struct.pack("<I", len(body)) + body + pad


def _drain(h, timeout=0.2):
    out = []
    while (b := h.try_pull(timeout=timeout)) is not None:
        out.append(b)
    return out


def _encode_avi(core, w=64, h=48, n=4, rate="30/1"):
    """``<encoder> quality=90 batch-frames=4 ! avimux`` over n gradient
    frames → (AVI bytes, frames)."""
    enc = core.Harness(f"{ENC[core]} quality=90 batch-frames=4 ! avimux")
    enc.set_src_caps(f"video/x-raw, format=RGB, width={w}, height={h}, "
                     f"framerate={rate}")
    frames = []
    for i in range(n):
        f = make_test_frame("gradient", w, h, i)
        frames.append(f)
        enc.push(core.Buffer(f, pts=i * MS, duration=MS, offset=i))
    enc.push_eos()
    avi = bytes(enc.pull(timeout=30).data)
    enc.teardown()
    return avi, frames


def test_copy_holds_the_same_code():
    assert code_of(t_avimux) == code_of(j_avimux)
    for name, cls in (("avimux", t_avimux.AviMux),
                      ("avidemux", t_avimux.AviDemux)):
        assert isinstance(flutpu_torch.core.make(name), cls)


@pytest.mark.parametrize("w,h,rate", [(64, 48, "25/1"), (72, 40, "30/1")])
def test_avi_bytes_equal_flutpus(w, h, rate):
    """The same frames through each package's encoder and avimux: the
    same AVI file, byte for byte."""
    a, frames = _encode_avi(flutpu.core, w, h, rate=rate)
    b, _ = _encode_avi(flutpu_torch.core, w, h, rate=rate)
    assert b == a
    assert b[:4] == b"RIFF" and b[8:12] == b"AVI "
    assert struct.unpack("<I", b[4:8])[0] == len(b) - 8
    assert b"MJPG" in b and b"idx1" in b
    parsed = t_avimux.parse_avi(b)
    assert (parsed["width"], parsed["height"]) == (w, h)
    assert parsed["fps"] == Fraction(rate)
    for f, payload in zip(frames, parsed["frames"]):
        assert psnr(f, decode_jpeg(payload)) > 30


@pytest.mark.parametrize("core", [flutpu.core, flutpu_torch.core],
                         ids=["flutpu", "port"])
def test_roundtrip_demux_decode(core):
    """encoder ! avimux → avidemux ! decoder: each package's decoder gets
    its frames back, and the port's equals flutpu's within one level."""
    avi, frames = _encode_avi(core)
    got = {}
    for dcore in (flutpu.core, flutpu_torch.core):
        dec = dcore.Harness(f"avidemux ! {DEC[dcore]}")
        dec.set_src_caps("video/x-msvideo")
        dec.push(dcore.Buffer(avi, pts=0))
        dec.push_eos()
        got[dcore] = [dec.pull(timeout=30) for _ in range(4)]
        dec.teardown()
    for i, f in enumerate(frames):
        a = np.asarray(got[flutpu.core][i].data)
        b = np.asarray(got[flutpu_torch.core][i].data)
        assert psnr(f, b) > 30
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert got[flutpu_torch.core][i].pts == got[flutpu.core][i].pts


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_parse_avi_rejects_garbage(core, mod, ev):
    for data in (b"", b"RIFFxxxxWAVE", b"\x00" * 64):
        assert mod.parse_avi(data) is None


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avidemux_streams_before_eos(core, mod, ev):
    """Frames leave as their bytes arrive, in slices of 777, with no EOS:
    the index at the tail is never needed."""
    avi, _ = _encode_avi(flutpu_torch.core)
    dec = core.Harness("avidemux")
    dec.set_src_caps("video/x-msvideo")
    got, first_out_at = [], None
    for off in range(0, len(avi), 777):
        dec.push(core.Buffer(avi[off:off + 777], pts=0))
        got += [bytes(b.data) for b in _drain(dec, 0.05)]
        if got and first_out_at is None:
            first_out_at = off
    dec.teardown()
    assert got == mod.parse_avi(avi)["frames"] and len(got) == 4
    assert first_out_at is not None and first_out_at < len(avi) // 2


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avidemux_long_stream_bounded_memory(core, mod, ev):
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    avi = mod.build_avi([frame] * 64, 64, 48, Fraction(30, 1))
    h = core.Harness("avidemux")
    h.set_src_caps("video/x-msvideo")
    n = 0
    for off in range(0, len(avi), 65536):
        h.push(core.Buffer(avi[off:off + 65536], pts=0))
        n += len(_drain(h, 0.05))
    h.push_eos()
    n += len(_drain(h, 0.5))
    demux = [e for e in h.pipeline.iterate_elements()
             if e.FACTORY == "avidemux"][0]
    assert len(demux._buf) < 1.2 * (1 << 20), len(demux._buf)
    h.teardown()
    assert n == 64


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avidemux_odd_sized_list_pad_byte(core, mod, ev):
    strh = b"vids" + b"\x00" * 16 + struct.pack("<II", 1, 30) + b"\x00" * 8
    strf = struct.pack("<I", 40) + struct.pack("<ii", 16, 12) + b"\x00" * 28
    junk_raw = b"JUNK" + struct.pack("<I", 7) + b"x" * 7
    strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf) + junk_raw
    assert len(strl) & 1 == 1
    hdrl = b"hdrl" + _chunk(b"avih", b"\x00" * 56) + _chunk(b"LIST", strl)
    frames = [bytes([i]) * 100 for i in range(3)]
    movi = b"movi" + b"".join(_chunk(b"00dc", f) for f in frames)
    body = b"AVI " + _chunk(b"LIST", hdrl) + _chunk(b"LIST", movi)
    avi = b"RIFF" + struct.pack("<I", len(body)) + body
    h = core.Harness("avidemux")
    h.set_src_caps("video/x-msvideo")
    got = []
    for off in range(0, len(avi), 37):
        h.push(core.Buffer(avi[off:off + 37], pts=0))
        got += [bytes(b.data) for b in _drain(h, 0.05)]
    h.push_eos()
    got += [bytes(b.data) for b in _drain(h)]
    h.teardown()
    assert got == frames


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avidemux_corrupt_size_stops_parsing(core, mod, ev):
    bad = (b"RIFF" + struct.pack("<I", 100) + b"AVI "
           + b"\x01\x02\x03\x04" + struct.pack("<I", 0xFFFFFFF0) + b"junk")
    h = core.Harness("avidemux")
    h.set_src_caps("video/x-msvideo")
    h.push(core.Buffer(bad, pts=0))
    demux = [e for e in h.pipeline.iterate_elements()
             if isinstance(e, mod.AviDemux)][0]
    assert demux._bad
    assert _drain(h) == []
    h.teardown()


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avidemux_huge_movi_list_size_ok(core, mod, ev):
    jpg = b"\xff\xd8\xff\xe0" + b"j" * 40 + b"\xff\xd9"
    movi_body = b"movi" + _chunk(b"00dc", jpg) + _chunk(b"00dc", jpg)
    movi = b"LIST" + struct.pack("<I", (1 << 28) + 64) + movi_body
    riff_body = b"AVI " + movi
    data = b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body
    h = core.Harness("avidemux")
    h.set_src_caps("video/x-msvideo")
    h.push(core.Buffer(data, pts=0))
    got = [bytes(b.data) for b in _drain(h)]
    h.teardown()
    assert got == [jpg, jpg]


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_demux_arbitrary_input_fragmentation(core, mod, ev):
    h = core.Harness("avimux")
    h.set_src_caps("image/jpeg, width=16, height=16, framerate=30/1")
    payloads = [b"\xff\xd8" + bytes([i] * 50) + b"\xff\xd9"
                for i in range(5)]
    for i, p in enumerate(payloads):
        h.push(core.Buffer(p, pts=i * MS, duration=MS, offset=i))
    h.push_eos()
    avi = b"".join(bytes(b.data) for b in _drain(h, 2))
    h.teardown()
    for step in (1, 7, 64):
        h = core.Harness("avidemux")
        h.set_src_caps("video/x-msvideo")
        for off in range(0, len(avi), step):
            h.push(core.Buffer(avi[off:off + step], pts=None))
        h.push_eos()
        got = _drain(h, 2)
        h.teardown()
        assert [bytes(b.data) for b in got] == payloads, step
        assert [b.pts for b in got] == [i * 33_333_333 for i in range(5)]


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avidemux_audio_first_stream_association(core, mod, ev):
    auds_strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"auds", b"\x00" * 4,
                            0, 0, 0, 0, 1, 44100, 0, 0, 0, 0xFFFFFFFF,
                            0, 0, 0, 0, 0)
    auds_strf = struct.pack("<HHIIHH", 1, 1, 44100, 176400, 2, 16)
    vids_strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG",
                            0, 0, 0, 0, 1, 30, 0, 2, 0, 0xFFFFFFFF,
                            0, 0, 0, 64, 48)
    vids_strf = struct.pack("<IiiHH4sIiiII", 40, 64, 48, 1, 24, b"MJPG",
                            64 * 48 * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl",
                 _list(b"strl", _chunk(b"strh", auds_strh)
                       + _chunk(b"strf", auds_strf))
                 + _list(b"strl", _chunk(b"strh", vids_strh)
                         + _chunk(b"strf", vids_strf)))
    jpg = b"\xff\xd8\xff\xe0" + b"v" * 30 + b"\xff\xd9"
    movi = _list(b"movi", _chunk(b"00wb", b"a" * 50)
                 + _chunk(b"01dc", jpg) + _chunk(b"01dc", jpg))
    riff_body = b"AVI " + hdrl + movi
    data = b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body
    parsed = mod.parse_avi(data)
    assert (parsed["width"], parsed["height"]) == (64, 48)
    assert parsed["frames"] == [jpg, jpg]
    h = core.Harness("avidemux")
    h.set_src_caps("video/x-msvideo")
    h.push(core.Buffer(data, pts=0))
    got = [bytes(b.data) for b in _drain(h)]
    caps = h.sinkpad.caps
    h.teardown()
    assert got == [jpg, jpg]
    assert (caps.get("width"), caps.get("height")) == (64, 48)


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avimux_flush_discards_buffered_frames(core, mod, ev):
    h = core.Harness("avimux")
    h.set_src_caps("image/jpeg, width=64, height=48, framerate=30/1")
    old, new = b"\xff\xd8OLD\xff\xd9", b"\xff\xd8NEW\xff\xd9"
    h.push(core.Buffer(old, pts=0))
    h.push_event(ev.FlushStartEvent())
    h.push_event(ev.FlushStopEvent())
    h.push(core.Buffer(new, pts=0))
    h.push_eos()
    avi = bytes(h.pull(timeout=10).data)
    h.teardown()
    assert mod.parse_avi(avi)["frames"] == [new]


@pytest.mark.parametrize("core,mod,ev", CORES)
def test_avidemux_flush_renegotiates_next_stream(core, mod, ev):
    """After FLUSH_STOP a new file of another geometry renegotiates."""
    avis = [_encode_avi(flutpu_torch.core, w, h, n=2)[0]
            for w, h in ((64, 48), (96, 64))]
    d = core.Harness(f"avidemux ! {DEC[core]}")
    d.set_src_caps("video/x-msvideo")
    d.push(core.Buffer(avis[0], pts=0))
    got_a = [np.asarray(b.data) for b in _drain(d, 0.3)]
    d.push_event(ev.FlushStartEvent())
    d.push_event(ev.FlushStopEvent())
    d.push(core.Buffer(avis[1], pts=0))
    got_b = [np.asarray(b.data) for b in _drain(d, 0.3)]
    d.teardown()
    assert [g.shape for g in got_a] == [(48, 64, 3)] * 2
    assert [g.shape for g in got_b] == [(64, 96, 3)] * 2
