"""The decode side of the port on the CPU against flutpu's.

``cudajpegdec device=cpu`` against flutpu's ``jpegdec`` on the same JFIF
bytes (4:2:0 and 4:4:4), and ``cudafvcdec device=cpu`` and
``FvcDecoder(device="cpu")`` against flutpu's ``fvcdec`` and
``FvcDecoder`` on chunks from flutpu's encoder, one per kind the port
now reads: version 1 in 4:2:0 and 4:4:4, version 2 with P frames, hier +
B frames (the batched B pass), half-pel vectors, and a coded-size
extension (header flags bit 4). Contract: frame types and sizes equal,
RGB within one level (the IDCT and colour matrix products round in
another order; the share of pixels that differ is printed and bounded);
``split_stream`` equal, ``decode_stream`` and byte-stream reassembly
within one level, corrupt inputs refused with the same ValueError.
Then the shape of BASELINE config 2: decode → injectbin with a
``cudaoverlaycompositor`` swapped in mid-stream."""

import struct

import numpy as np
import pytest
import torch

import flutpu.core
import flutpu_torch.core
from flutpu.codec import fvc as jf
from flutpu.codec.jpeg import JpegEncoder as JaxJpeg
from flutpu.core.elements import make_test_frame
from flutpu_torch.codec.fvc import FvcDecoder
from flutpu_torch.codec.jpeg import psnr
from flutpu_torch.ttml.render.composite import overlay_on_frames

torch.set_num_threads(1)

W, H = 160, 96
MS = 1_000_000
#: share of RGB values allowed to differ by one level from flutpu's
MAX_OFF_BY_ONE = 1e-3


def _clip(pattern, n, start=0, w=W, h=H):
    return np.stack([make_test_frame(pattern, w, h, i)
                     for i in range(start, start + n)])


#: an 8-frame clip with a cut (ball, then noise): intra mid-chunk
CUT = np.concatenate([_clip("ball", 4), _clip("noise", 4, 4)])


def _with_coded_size(chunk: bytes, h: int) -> bytes:
    """Rewrite a chunk's header to the frame height ``h`` with an explicit
    coded-size extension (pw, the chunk's coded height) after the v2
    search-range byte: header flags bit 4."""
    ver, flags, w, ph = struct.unpack(">BBHH", chunk[4:10])
    off = 13 if ver >= 2 else 12
    head = chunk[:4] + struct.pack(">BBHH", ver, flags | 16, w, h) + \
        chunk[10:off]
    return head + struct.pack(">HH", w, ph) + chunk[off:]


#: (encoder kwargs, frames) of each chunk kind
KINDS = {
    "v1-420": ({}, CUT),
    "v1-444": ({"subsample": False}, CUT),
    "v1-444-odd": ({"subsample": False}, _clip("smpte", 4, w=76, h=44)),
    "v2-P": ({"motion": True}, CUT),
    "v2-hier-B": ({"motion": True, "hier": True, "bframes": 1}, CUT),
    "half-pel": ({"motion": True, "subpel": True}, _clip("ball", 8)),
    "coded-size": ({"motion": True}, _clip("ball", 4)),
}


@pytest.fixture(scope="module")
def chunks():
    """flutpu's chunk of every kind, encoded once; the coded-size kind's
    96-row frames rewritten to 80 rows with the extension."""
    out = {}
    for kind, (kw, frames) in KINDS.items():
        data = jf.FvcEncoder(85, **kw).encode_chunk(frames)
        if kind == "coded-size":
            data = _with_coded_size(data, 80)
        out[kind] = data
    return out


def _close(got, want, label=""):
    """Equal shapes and values within one level on at most
    ``MAX_OFF_BY_ONE`` of them; returns the share that differs."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((d > 0).mean())
    print(f"{label}: {share:.2e} of the RGB values differ by one level")
    assert d.max(initial=0) <= 1 and share <= MAX_OFF_BY_ONE, (d.max(), share)
    return share


# -- JPEG ------------------------------------------------------------------

@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("pattern,w,h", [("ball", 64, 48),
                                         ("smpte", 72, 40),
                                         ("noise", 44, 30)])
def test_cudajpegdec_matches_jpegdec(subsample, pattern, w, h):
    """The same JFIF bytes (flutpu's encoder) through ``jpegdec`` and
    ``cudajpegdec device=cpu``: the same size and pts, RGB within one
    level."""
    frames = _clip(pattern, 3, w=w, h=h)
    payloads = JaxJpeg(85, subsample=subsample,
                       use_pallas=False).encode_gop(frames)
    got = {}
    for core, el in ((flutpu.core, "jpegdec"),
                     (flutpu_torch.core, "cudajpegdec device=cpu")):
        hn = core.Harness(el)
        hn.set_src_caps("image/jpeg")
        for i, p in enumerate(payloads):
            hn.push(core.Buffer(p, pts=i * MS, duration=MS, offset=i))
        hn.push_eos()
        got[core] = [hn.pull(timeout=30) for _ in payloads]
        hn.teardown()
    for i, (a, b) in enumerate(zip(got[flutpu.core], got[flutpu_torch.core])):
        assert (b.pts, b.duration, b.offset) == (a.pts, a.duration, a.offset)
        _close(np.asarray(b.data), np.asarray(a.data), f"frame {i}")
        if pattern == "ball":   # the bars' 4:2:0 edges cost more
            assert psnr(frames[i], np.asarray(b.data)) > 30


def test_cudajpegdec_refuses_corrupt_input():
    """Data that is no JFIF image of the subset, or a scan cut short:
    FlowReturn.ERROR, as jpegdec returns."""
    good = JaxJpeg(85, use_pallas=False).encode_gop(_clip("ball", 1, w=64,
                                                          h=48))[0]
    for core, el in ((flutpu.core, "jpegdec"),
                     (flutpu_torch.core, "cudajpegdec device=cpu")):
        for data in (b"not a jpeg", good[:40]):
            hn = core.Harness(el)
            hn.set_src_caps("image/jpeg")
            assert hn.push(core.Buffer(data, pts=0)).name == "ERROR"
            hn.teardown()


# -- FVC -------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_fvc_decoder_reads_every_flutpu_chunk(chunks, kind):
    """``FvcDecoder(device="cpu")`` against flutpu's on flutpu's chunks:
    the same frame types and size, RGB within one level. The coded-size
    kind decodes to the 80-row crop of the 96-row chunk's frames."""
    data = chunks[kind]
    want, j_info = jf.FvcDecoder().decode_chunk(data)
    got, info = FvcDecoder(device="cpu").decode_chunk(data)
    assert info == j_info
    _close(got, want, kind)
    hdr = FvcDecoder.parse_chunk(data)[0]
    assert hdr["subsample"] == (kind not in ("v1-444", "v1-444-odd"))
    assert hdr["subpel"] == (kind == "half-pel")
    if kind == "v2-hier-B":
        assert 2 in info["types"]
    if kind == "coded-size":
        assert got.shape[1] == 80
        assert (hdr["coded_height"], hdr["coded_width"]) == (96, W)
        full = FvcDecoder(device="cpu").decode_chunk(
            jf.FvcEncoder(85, motion=True).encode_chunk(KINDS[kind][1]))[0]
        np.testing.assert_array_equal(got, full[:, :80])
    else:
        # the first four frames (the cut clip's noise half codes at ~13 dB)
        frames = KINDS[kind][1]
        assert min(psnr(a, b) for a, b in zip(got[:4], frames)) > 30


@pytest.mark.parametrize("kind", list(KINDS))
def test_cudafvcdec_matches_fvcdec(chunks, kind):
    """Each chunk as one buffer through flutpu's ``fvcdec`` and
    ``cudafvcdec device=cpu``: the same frames (±1), pts and durations,
    the pts spread from the buffer's duration."""
    data = chunks[kind]
    n = KINDS[kind][1].shape[0]
    got = {}
    for core, el in ((flutpu.core, "fvcdec"),
                     (flutpu_torch.core, "cudafvcdec device=cpu")):
        hn = core.Harness(el)
        hn.set_src_caps("video/x-fvc, framerate=30/1")
        hn.push(core.Buffer(data, pts=5 * MS, duration=n * MS))
        hn.push_eos()
        got[core] = [hn.pull(timeout=30) for _ in range(n)]
        hn.teardown()
    for a, b in zip(got[flutpu.core], got[flutpu_torch.core]):
        assert (b.pts, b.duration) == (a.pts, a.duration)
        _close(np.asarray(b.data), np.asarray(a.data), kind)


def test_half_pel_and_batched_b_decode_match_flutpus_programs(chunks):
    """The reconstruction programs themselves: ``fvc_mc_decode_chunk`` with
    half-pel vectors and ``fvc_mc_decode_chunk_b`` (all B frames in one
    pass) against flutpu's on the same residuals, in float32 planes
    (equal within 1e-3 of a level: the IDCT's products round in another
    order)."""
    import jax.numpy as jnp
    from flutpu_torch.codec import fvc as tf
    from flutpu_torch.codec.decode import decode_scan_to_coefs
    from flutpu_torch.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                              scale_qtable)
    q = [scale_qtable(t, 85) for t in (LUMA_QTABLE, CHROMA_QTABLE)]
    for kind in ("half-pel", "v2-hier-B"):
        hdr, frames = FvcDecoder.parse_chunk(chunks[kind])
        planes = [decode_scan_to_coefs(p, W // 8, H // 8, W // 16, H // 16,
                                       True) for _, _, p in frames]
        types = [t for t, _, _ in frames]
        a_idx = [i for i, t in enumerate(types) if t != 2]
        b_idx = [i for i, t in enumerate(types) if t == 2]
        mv, it = FvcDecoder._mc_arrays([frames[i][1] for i in a_idx],
                                       H // 16, W // 16)
        ra = [np.stack([planes[i][c] for i in a_idx]) for c in range(3)]
        if kind == "half-pel":
            want = jf.fvc_mc_decode_chunk(
                *map(jnp.asarray, ra), jnp.asarray(mv), jnp.asarray(it),
                *map(jnp.asarray, q), subpel=True, planar=False)
            got = tf.fvc_mc_decode_chunk(
                *map(torch.from_numpy, ra), torch.from_numpy(mv),
                torch.from_numpy(it), *map(torch.from_numpy, q),
                subpel=True)
        else:
            rb = [np.stack([planes[i][c] for i in b_idx]) for c in range(3)]
            side = [np.stack([frames[i][1][c] for i in b_idx])
                    for c in range(3)]
            pm = [max(k for k, a in enumerate(a_idx) if a < j) for j in b_idx]
            nm = [k + 1 for k in pm]
            qb = [scale_qtable(t, hdr["bquality"])
                  for t in (LUMA_QTABLE, CHROMA_QTABLE)]
            (ay, acb, acr), (by, bcb, bcr) = jf.fvc_mc_decode_chunk_b(
                *map(jnp.asarray, ra), jnp.asarray(mv), jnp.asarray(it),
                *map(jnp.asarray, rb + side), jnp.asarray(pm),
                jnp.asarray(nm), *map(jnp.asarray, q), planar=False,
                qy_b=jnp.asarray(qb[0]), qc_b=jnp.asarray(qb[1]))
            want = (by, bcb, bcr)
            got = tf.fvc_mc_decode_chunk_b(
                *map(torch.from_numpy, ra), torch.from_numpy(mv),
                torch.from_numpy(it), *map(torch.from_numpy, rb + side),
                pm, nm, *map(torch.from_numpy, q),
                qy_b=torch.from_numpy(qb[0]), qc_b=torch.from_numpy(qb[1]))[1]
            assert got[0].shape[0] == len(b_idx) > 1
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)


def test_stream_entry_points_match_flutpus(chunks):
    """Every kind concatenated into one stream: ``split_stream`` gives
    flutpu's chunks, ``decode_stream`` (thread pool and serial) flutpu's
    frames within one level, in chunk order; fed to each package's
    decoder element in blocks of 333 bytes, the same frames and pts."""
    data = b"".join(chunks.values())
    j_dec, t_dec = jf.FvcDecoder(), FvcDecoder(device="cpu")
    assert t_dec.split_stream(data) == j_dec.split_stream(data) == \
        list(chunks.values())
    # flutpu's decode_stream concatenates frames of one size
    same = b"".join(v for k, v in chunks.items()
                    if k not in ("v1-444-odd", "coded-size"))
    want = j_dec.decode_stream(same)
    for parallel in (True, False):
        _close(t_dec.decode_stream(same, parallel=parallel), want, "stream")
    got = {}
    for core, el in ((flutpu.core, "fvcdec"),
                     (flutpu_torch.core, "cudafvcdec device=cpu")):
        hn = core.Harness(el)
        hn.set_src_caps("video/x-fvc")
        for off in range(0, len(data), 333):
            hn.push(core.Buffer(data[off:off + 333], pts=0))
        hn.push_eos()
        got[core] = []
        while (b := hn.try_pull(timeout=5)) is not None:
            got[core].append(b)
        hn.teardown()
    assert len(got[flutpu_torch.core]) == len(got[flutpu.core]) == \
        sum(KINDS[k][1].shape[0] for k in chunks)
    for a, b in zip(got[flutpu.core], got[flutpu_torch.core]):
        assert b.pts == a.pts
        _close(np.asarray(b.data), np.asarray(a.data), "byte stream")


def _corruptions(chunks):
    p = chunks["v2-P"]
    v1 = chunks["v1-420"]
    hdr = FvcDecoder.parse_chunk(p)[1]
    mv_at = 13 + 7 + len(hdr[0][2]) + 7    # frame 1's motion block
    yield "bad magic", b"XVC1" + p[4:]
    yield "short header", p[:10]
    yield "short v2 header", p[:12]
    yield "short frame header", p[:16]
    yield "short payload", p[:200]
    yield "zero size", p[:6] + b"\x00\x00\x00\x00" + p[10:]
    yield "bad motion block", p[:mv_at] + b"\x00\x01\x02" + p[mv_at + 3:]
    yield "short coded-size extension", \
        p[:5] + bytes([p[5] | 16]) + p[6:13] + b"\x00"
    yield "coded size below the frame", \
        p[:5] + bytes([p[5] | 16]) + p[6:13] + struct.pack(">HH", W, 80) \
        + p[13:]
    yield "bad bquality", p[:5] + bytes([p[5] | 32]) + p[6:13] + b"\x00" \
        + p[13:]
    yield "short v1 frame header", v1[:14]


def test_corrupt_chunks_raise_the_same_value_error(chunks):
    """Each corruption: both decoders raise ValueError with the same
    message, and both elements return ERROR."""
    for label, data in _corruptions(chunks):
        errs = []
        for dec in (jf.FvcDecoder(), FvcDecoder(device="cpu")):
            with pytest.raises(ValueError) as e:
                dec.decode_chunk(data)
            errs.append(str(e.value))
        assert errs[0] == errs[1], (label, errs)
        if len(data) < 12 or data[:4] != b"FVC1":
            continue
        for core, el in ((flutpu.core, "fvcdec"),
                         (flutpu_torch.core, "cudafvcdec device=cpu")):
            hn = core.Harness(el)
            hn.set_src_caps("video/x-fvc")
            ret = hn.push(core.Buffer(data, pts=0, duration=MS))
            hn.teardown()
            if label.startswith(("short", "zero")):
                continue   # a prefix waits for more bytes
            assert ret.name == "ERROR", (label, core.__name__)
    with pytest.raises(ValueError) as a:
        jf.FvcDecoder().split_stream(chunks["v2-P"] + b"junk")
    with pytest.raises(ValueError) as b:
        FvcDecoder.split_stream(chunks["v2-P"] + b"junk")
    assert str(a.value) == str(b.value)


def test_decoder_elements_default_to_the_card_and_prewarm():
    for name in ("cudajpegdec", "cudafvcdec"):
        el = flutpu_torch.core.make(name)
        assert el.get_property("device") == "cuda"
        cpu = flutpu_torch.core.make(name, device="cpu")
        caps = flutpu_torch.core.Caps.from_string(
            "video/x-raw, format=RGB, width=72, height=40")
        assert cpu.prewarm(caps) is True
        assert cpu.prewarm(None) is False
    assert FvcDecoder().device == torch.device("cuda")


def test_fvc_element_round_trip_matches_flutpus():
    """``cudafvcenc ! cudafvcdec`` against ``fvcenc ! fvcdec`` (motion,
    two chunks): the same pts, frames within one level, > 30 dB."""
    from torch_helpers import pull_all
    src = f"videotestsrc num-buffers=8 pattern=ball width={W} height={H}"
    a = pull_all(flutpu.core.parse_launch, f"{src} ! fvcenc gop-size=4 "
                 "motion=true ! fvcdec ! appsink name=out")
    b = pull_all(flutpu_torch.core.parse_launch, f"{src} ! cudafvcenc "
                 "gop-size=4 motion=true device=cpu ! cudafvcdec device=cpu "
                 "! appsink name=out")
    assert [x.pts for x in b] == [x.pts for x in a] and len(b) == 8
    for i, (x, y) in enumerate(zip(a, b)):
        _close(np.asarray(y.data), np.asarray(x.data), "round trip")
        assert psnr(make_test_frame("ball", W, H, i), np.asarray(y.data)) > 30


def _seeded_overlay(h, w, seed=3):
    """A seeded (h, w, 4) BGRA overlay: an opaque band, a half-transparent
    band, alpha 0 elsewhere."""
    rng = np.random.default_rng(seed)
    ov = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    ov[..., 3] = 0
    ov[: h // 3, :, 3] = 255
    ov[h // 3: 2 * h // 3, :, 3] = 128
    return ov


def test_config2_decode_overlay_swap():
    """BASELINE config 2's shape on the port's core (tests/test_decoders.py
    :49 with the processing element a compositor): ``appsrc !
    cudajpegenc ! cudajpegdec ! injectbin ! appsink``, a
    ``cudaoverlaycompositor device=cpu`` whose ``overlay`` pad already
    holds a window swapped in mid-stream. No frame is lost or reordered;
    the frames before the swap are the decoder's, the frames from it on
    its frames blended on the CPU; the decode equals flutpu's jpegdec's
    within one level."""
    n, w, h = 8, 64, 48
    caps = f"video/x-raw, format=RGB, width={w}, height={h}, framerate=30/1"
    core = flutpu_torch.core
    p = core.parse_launch(
        f"appsrc name=src caps='{caps}' ! cudajpegenc quality=90 "
        "batch-frames=2 device=cpu ! cudajpegdec device=cpu "
        "! injectbin name=ib ! appsink name=out")
    src, ib, sink = (p.get_by_name(k) for k in ("src", "ib", "out"))
    comp = core.make("cudaoverlaycompositor", device="cpu")
    ov = _seeded_overlay(h, w)
    assert comp.overlay_pad.chain(core.Buffer(ov, pts=0)).name == "OK"
    assert p.play().name == "SUCCESS"
    frames = [make_test_frame("gradient", w, h, i) for i in range(n)]
    for i, f in enumerate(frames):
        if i == n // 2:
            ib.set_property("element", comp)
        src.push(core.Buffer(f, pts=i * MS, duration=MS, offset=i))
    src.end_of_stream()
    got = [sink.try_pull_buffer(timeout=30) for _ in range(n)]
    p.stop()
    assert all(b is not None for b in got)
    assert [b.pts for b in got] == [i * MS for i in range(n)]
    payloads = JaxJpeg(90, use_pallas=False).encode_gop(np.stack(frames))
    dec = flutpu.core.Harness("jpegdec")
    dec.set_src_caps("image/jpeg")
    for i, pl in enumerate(payloads):
        dec.push(flutpu.core.Buffer(pl, pts=i * MS))
    plain = [np.asarray(dec.pull(timeout=30).data) for _ in payloads]
    dec.teardown()
    cd = core.Harness("cudajpegdec device=cpu")
    cd.set_src_caps("image/jpeg")
    for i, pl in enumerate(payloads):
        cd.push(core.Buffer(pl, pts=i * MS))
    mine = [np.asarray(cd.pull(timeout=30).data) for _ in payloads]
    cd.teardown()
    blended = [overlay_on_frames(torch.from_numpy(f)[None],
                                 torch.from_numpy(ov))[0].numpy()
               for f in mine]
    swapped = [not np.array_equal(np.asarray(b.data), m)
               for b, m in zip(got, mine)]
    first = swapped.index(True)
    assert 0 < first <= n // 2 + 2 and all(swapped[first:])
    for i, b in enumerate(got):
        _close(mine[i], plain[i], f"decode {i}")
        want = blended[i] if i >= first else mine[i]
        np.testing.assert_array_equal(np.asarray(b.data), want)
