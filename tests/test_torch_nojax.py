"""flutpu_torch stands without jax and without the JAX package flutpu:
it imports neither, its carried copies of jax-free host code still equal
their originals in flutpu, its kernel build composes the Hopper nvcc
commands without needing nvcc, and its native-library loader builds the
repository's C++ sources with the Makefile's flags."""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from flutpu.codec import base as j_base
from flutpu.codec import fvc as j_fvc
from flutpu.codec import jpeg as j_jpeg
from flutpu.codec import jpeg_tables as j_tables
from flutpu.codec.ops import colorspace as j_cs
from flutpu.codec.ops import dct as j_dct
from flutpu.codec.ops import entropy as j_entropy
from flutpu.codec.ops import quant as j_quant
from flutpu.hype import events as j_events
from flutpu_torch import _build, native
from flutpu_torch.codec import base as t_base
from flutpu_torch.codec import encoder as t_encoder
from flutpu_torch.codec import fvc as t_fvc
from flutpu_torch.codec import jpeg as t_jpeg
from flutpu_torch.codec import jpeg_tables as t_tables
from flutpu_torch.codec.ops import colorspace as t_cs
from flutpu_torch.codec.ops import dct as t_dct
from flutpu_torch.codec.ops import entropy as t_entropy
from flutpu_torch.codec.ops import quant as t_quant

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_PIPELINE = """
import sys
sys.modules["jax"] = None
sys.modules["flutpu"] = None
import flutpu_torch
from flutpu_torch.core import parse_launch
outs = []
for seg in ("true", "false"):
    p = parse_launch("videotestsrc num-buffers=2 width=64 height=32 "
                     "pattern=gradient ! cudajpegenc device=cpu "
                     f"segmented={seg} ! appsink name=out")
    sink = p.get_by_name("out")
    p.play()
    out = []
    while (buf := sink.try_pull_buffer(timeout=60)) is not None:
        out.append(bytes(buf.data))
    p.stop()
    assert len(out) == 2, len(out)
    assert all(o[:2] == b"\\xff\\xd8" and o[-2:] == b"\\xff\\xd9"
               for o in out)
    outs.append(out)
assert outs[0] == outs[1]
p = parse_launch("videotestsrc num-buffers=3 width=64 height=32 pattern=ball "
                 "! cudafvcenc device=cpu motion=true gop-size=3 "
                 "! appsink name=out")
sink = p.get_by_name("out")
p.play()
chunks = []
while (buf := sink.try_pull_buffer(timeout=60)) is not None:
    chunks.append(bytes(buf.data))
p.stop()
from flutpu_torch.codec.fvc import FvcDecoder
frames, info = FvcDecoder(device="cpu").decode_chunk(chunks[0])
assert len(chunks) == 1 and frames.shape == (3, 32, 64, 3), frames.shape
import numpy as np
from flutpu_torch.codec.fvc import FvcEncoder
clip = np.stack([np.roll(np.arange(32 * 64 * 3, dtype=np.uint8)
                         .reshape(32, 64, 3), i, axis=1) for i in range(3)])
b = FvcEncoder(motion=True, hier=True, bframes=1, device="cpu")
dec = FvcDecoder(device="cpu")
assert 2 in dec.decode_chunk(b.encode_chunk(clip))[1]["types"]
assert sys.modules["jax"] is None and sys.modules["flutpu"] is None
print("encoded", len(out), "chunks", len(chunks))
"""

_NO_JAX_BURNIN = """
import sys
sys.modules["jax"] = None
sys.modules["flutpu"] = None
import numpy as np
import flutpu_torch.ttml
from flutpu_torch.core import Buffer, Harness, parse_launch
from flutpu_torch.codec.jpeg import JpegEncoder
doc = (b"<?xml version='1.0'?><tt xmlns='http://www.w3.org/ns/ttml'>"
       b"<body><div><p begin='0s' end='60s'>Burn-in subtitle</p></div>"
       b"</body></tt>")
h = Harness("cudattmlrender window-width=96 window-height=64 device=cpu")
h.set_src_caps("application/ttml+xml")
h.push(Buffer(doc, pts=0))
h.push_eos()
window = np.asarray(h.pull(timeout=30).data)
h.teardown()
assert window.shape == (64, 96, 4) and (window[..., 3] > 0).any()
enc = JpegEncoder(85, device="cpu")
frames = np.full((2, 64, 96, 3), 30, np.uint8)
import torch
plain = enc.encode_gop(frames)
burnt = enc.encode_gop_finalize(enc.encode_gop_dispatch(
    torch.from_numpy(frames), 64, 96, overlay=window))
assert len(burnt) == 2 and burnt != plain
p = parse_launch(
    "videotestsrc num-buffers=3 width=96 height=64 pattern=gradient "
    "! comp.video appsrc name=ssrc caps='application/ttml+xml' "
    "! cudattmlrender window-width=96 window-height=64 device=cpu "
    "device-out=true ! comp.overlay cudaoverlaycompositor name=comp "
    "device=cpu ! cudajpegenc device=cpu batch-frames=2 ! appsink name=out")
ssrc, sink = p.get_by_name("ssrc"), p.get_by_name("out")
ssrc.push(Buffer(doc, pts=0))
ssrc.end_of_stream()
p.play()
n = 0
while (buf := sink.try_pull_buffer(timeout=60)) is not None:
    assert bytes(buf.data)[:2] == b"\\xff\\xd8"
    n += 1
p.stop()
assert sys.modules["jax"] is None and sys.modules["flutpu"] is None
print("rendered", int((window[..., 3] > 0).sum()) > 0, "frames", n)
"""

_NO_JAX_HYPE = """
import sys
sys.modules["jax"] = None
sys.modules["flutpu"] = None
import numpy as np
from flutpu_torch.core import Buffer, Harness, parse_launch
out = []
p = parse_launch("videotestsrc num-buffers=6 width=48 height=32 "
                 "pattern=ball ! hype gop-size=2 "
                 "encoder-0='cudajpegenc device=cpu' "
                 "encoder-1='cudajpegenc device=cpu' ! appsink name=out")
sink = p.get_by_name("out")
p.play()
while (buf := sink.try_pull_buffer(timeout=60)) is not None:
    out.append(buf.pts)
p.stop()
assert out == sorted(out) and len(out) == 6, out
for codec in ("jpeg", "fvc-motion search=hier bframes=1"):
    h = Harness(f"cudahype device=cpu gop-size=2 chunks=2 codec={codec}")
    h.set_src_caps("video/x-raw, format=RGB, width=48, height=32")
    for i in range(5):
        h.push(Buffer(np.full((32, 48, 3), 9 * i, np.uint8), pts=i))
    h.push_eos()
    n = 0
    while h.pull(timeout=60) is not None:
        n += 1
    h.teardown()
    assert n == (5 if codec == "jpeg" else 3), n
from flutpu_torch.core import make
p = parse_launch("videotestsrc num-buffers=4 width=48 height=32 "
                 "! injectbin name=ib ! appsink name=out")
p.get_by_name("ib").set_property("element", make(
    "cudajpegenc", device="cpu", batch_frames=1))
sink = p.get_by_name("out")
p.play()
jpegs = []
while (buf := sink.try_pull_buffer(timeout=60)) is not None:
    jpegs.append(bytes(buf.data)[:2] == b"\\xff\\xd8")
p.stop()
assert jpegs == [True] * 4, jpegs
from flutpu_torch.parallel import gop, mesh, multihost
assert sys.modules["jax"] is None and sys.modules["flutpu"] is None
bad = sorted(m for m in sys.modules if m.startswith(("jax.", "flutpu.")))
assert not bad, bad
print("hype", len(out), "cudahype ok", "parallel", gop.__name__)
"""

_NO_JAX_DECODE = """
import sys
sys.modules["jax"] = None
sys.modules["flutpu"] = None
import numpy as np
from flutpu_torch.codec.avimux import parse_avi
from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.jpeg import psnr
from flutpu_torch.core import Buffer, Harness, parse_launch
from flutpu_torch.core.elements import make_test_frame
p = parse_launch("videotestsrc num-buffers=4 width=48 height=32 "
                 "pattern=ball ! cudajpegenc device=cpu subsample=false "
                 "! avimux ! appsink name=out")
sink = p.get_by_name("out")
p.play()
avi = b""
while (buf := sink.try_pull_buffer(timeout=60)) is not None:
    avi += bytes(buf.data)
p.stop()
assert len(parse_avi(avi)["frames"]) == 4
h = Harness("avidemux ! cudajpegdec device=cpu")
h.set_src_caps("video/x-msvideo")
h.push(Buffer(avi, pts=0))
h.push_eos()
frames = [np.asarray(h.pull(timeout=60).data) for _ in range(4)]
h.teardown()
assert min(psnr(make_test_frame("ball", 48, 32, i), f)
           for i, f in enumerate(frames)) > 30
clip = np.stack([make_test_frame("ball", 48, 32, i) for i in range(4)])
data = (FvcEncoder(device="cpu", motion=True, subpel=True).encode_chunk(clip)
        + FvcEncoder(device="cpu", subsample=False).encode_chunk(clip))
out = FvcDecoder(device="cpu").decode_stream(data)
h = Harness("cudafvcdec device=cpu")
h.set_src_caps("video/x-fvc")
for off in range(0, len(data), 100):
    h.push(Buffer(data[off:off + 100], pts=0))
h.push_eos()
n = 0
while h.pull(timeout=60) is not None:
    n += 1
h.teardown()
assert sys.modules["jax"] is None and sys.modules["flutpu"] is None
bad = sorted(m for m in sys.modules if m.startswith(("jax.", "flutpu.")))
assert not bad, bad
print("decoded", out.shape[0], n)
"""

_NO_JAX_IMPORTS = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flutpu"] = None
import flutpu_torch
for m in pkgutil.walk_packages(flutpu_torch.__path__, "flutpu_torch."):
    importlib.import_module(m.name)
flutpu_torch.core.make("cudajpegenc", device="cpu")   # loads the plugins
bad = sorted(m for m in sys.modules if m.startswith(("jax.", "flutpu.")))
assert not bad, bad
for m in ("codec.avimux", "codec.decoders", "codec.ladder", "fluc.bwmeter",
          "fluc.threads", "hype.cuda", "inject.injectbin", "io.downloader",
          "io.helper", "parallel.gop"):
    assert "flutpu_torch." + m in sys.modules, m
print("modules", sum(m.startswith("flutpu_torch") for m in sys.modules),
      "ttml", sum(m.startswith("flutpu_torch.ttml.") for m in sys.modules))
"""


_NO_JAX_SLICE = """
import sys, tempfile, os
sys.modules["jax"] = None
sys.modules["flutpu"] = None
import numpy as np
from flutpu_torch.core import Buffer, Harness, MSECOND, parse_launch
from flutpu_torch.core.elements import make_test_frame
from flutpu_torch.codec.fvc import FvcEncoder
from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
from flutpu_torch.io import download_sync
from flutpu_torch.fluc import bwmeter
# the harness pulls the first rung's pad: one chunk per 2 frames
h = Harness("cudafvcladderenc device=cpu rungs=48x32@85,24x16@70 "
            "gop-size=2 motion=true")
h.set_src_caps("video/x-raw, format=RGB, width=48, height=32, "
               "framerate=30/1")
for i in range(4):
    h.push(Buffer(make_test_frame("ball", 48, 32, i), pts=i * MSECOND,
                  duration=MSECOND))
h.push_eos()
n = 0
while h.pull(timeout=60) is not None:
    n += 1
h.teardown()
h = Harness("cudafvcenc device=cpu gop-size=2 bitrate=20000 "
            "search-range=40 motion=true")
h.set_src_caps("video/x-raw, format=RGB, width=48, height=32, "
               "framerate=30/1")
for i in range(4):
    h.push(Buffer(make_test_frame("ball", 48, 32, i), pts=i * MSECOND,
                  duration=33 * MSECOND))
h.push_eos()
q = []
while (b := h.pull(timeout=60)) is not None:
    q.append(bytes(b.data)[10])
h.teardown()
enc = FvcEncoder(device="cpu", motion=True)
src = lambda ph, pw, k, s: gradient_ball_planes(ph, pw, k, s, device="cpu")
chunks = enc.encode_chunk_batch_finalize(
    enc.encode_chunk_batch_dispatch_src(src, 0, 2, 32, 48, batch=2))
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "x.bin")
    with open(path, "wb") as fh:
        fh.write(b"y" * 5000)
    total = bwmeter.stats()[2]
    assert download_sync("file://" + path) == b"y" * 5000
    assert bwmeter.stats()[2] - total >= 5000
assert sys.modules["jax"] is None and sys.modules["flutpu"] is None
bad = sorted(m for m in sys.modules if m.startswith(("jax.", "flutpu.")))
assert not bad, bad
print("ladder", n, "rc", len(q), "batch", len(chunks))
"""


def _read(path):
    with open(path) as fh:
        return fh.read()


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_pipeline_encodes_with_jax_blocked():
    assert "encoded 2 chunks 1" in _run(_NO_JAX_PIPELINE)


def test_ttml_renders_and_burns_in_with_jax_blocked():
    assert "rendered True frames 3" in _run(_NO_JAX_BURNIN)


def test_hype_cudahype_and_injectbin_run_with_jax_blocked():
    """The hype bin with the port's encoders, cudahype (JPEG and FVC) and
    injectbin, and flutpu_torch.parallel, with jax and flutpu blocked."""
    assert "hype 6 cudahype ok parallel flutpu_torch.parallel.gop" in \
        _run(_NO_JAX_HYPE)


def test_decode_side_runs_with_jax_blocked():
    """AVI mux and demux, ``cudajpegdec`` on 4:4:4 frames, a half-pel and
    a 4:4:4 FVC chunk through ``decode_stream`` and ``cudafvcdec`` in
    100-byte blocks, with jax and flutpu blocked."""
    assert "decoded 8 8" in _run(_NO_JAX_DECODE)


def test_ladder_rate_control_batch_and_io_run_with_jax_blocked():
    """``cudafvcladderenc``, ``cudafvcenc bitrate=`` at range 40, the
    batched on-device source and a ``file://`` download, with jax and
    flutpu blocked."""
    assert "ladder 2 rc 2 batch 2" in _run(_NO_JAX_SLICE)


def test_every_module_imports_without_jax_or_the_jax_package():
    out = _run(_NO_JAX_IMPORTS)
    assert "modules" in out and "ttml 19" in out


# -- carried copies ----------------------------------------------------------

@pytest.mark.parametrize("name", [
    "DC_LUMA_BITS", "DC_LUMA_VALS", "DC_CHROMA_BITS", "DC_CHROMA_VALS",
    "AC_LUMA_BITS", "AC_LUMA_VALS", "AC_CHROMA_BITS", "AC_CHROMA_VALS"])
def test_jpeg_table_constants_equal(name):
    assert getattr(t_tables, name) == getattr(j_tables, name)


def test_jpeg_code_tables_equal():
    assert t_tables.code_tables() == j_tables.code_tables()
    for k, (codes, lens) in j_tables.code_arrays().items():
        np.testing.assert_array_equal(t_tables.code_arrays()[k][0], codes)
        np.testing.assert_array_equal(t_tables.code_arrays()[k][1], lens)


def test_quant_copies_equal():
    np.testing.assert_array_equal(t_quant.LUMA_QTABLE, j_quant.LUMA_QTABLE)
    np.testing.assert_array_equal(t_quant.CHROMA_QTABLE,
                                  j_quant.CHROMA_QTABLE)
    np.testing.assert_array_equal(t_quant.zigzag_order(8),
                                  j_quant.zigzag_order(8))
    np.testing.assert_array_equal(t_quant.inverse_zigzag_order(8),
                                  j_quant.inverse_zigzag_order(8))
    for q in range(0, 102):
        np.testing.assert_array_equal(
            t_quant.scale_qtable(t_quant.LUMA_QTABLE, q),
            j_quant.scale_qtable(j_quant.LUMA_QTABLE, q))


def test_dct_and_colour_matrices_equal():
    for n in (4, 8):
        np.testing.assert_array_equal(t_dct.dct_matrix(n), j_dct.dct_matrix(n))
    np.testing.assert_array_equal(t_cs._RGB2YCBCR, j_cs._RGB2YCBCR)
    np.testing.assert_array_equal(t_cs._YCBCR2RGB, j_cs._YCBCR2RGB)


@pytest.mark.parametrize("geom", [(240, 136, 120, 68, True),
                                  (8, 6, 4, 3, True), (6, 4, 6, 4, False),
                                  (10, 6, 5, 3, True)])
def test_mcu_layout_arrays_equal(geom):
    a, b = t_entropy.mcu_layout(*geom), j_entropy.mcu_layout(*geom)
    for field in ("block_sel", "comp_is_chroma", "prev_same_comp"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.n_blocks, a.max_span, a._key) == (b.n_blocks, b.max_span,
                                                b._key)


def test_entropy_tables_equal():
    for a, b in zip(t_entropy._device_tables(), j_entropy._device_tables()):
        np.testing.assert_array_equal(a, b)
    assert t_entropy._min_block_bits() == j_entropy._min_block_bits()


@pytest.mark.parametrize("h,w,q", [(1080, 1920, 85), (48, 64, 30),
                                   (40, 72, 100)])
def test_header_bytes_equal(h, w, q):
    qy = j_quant.scale_qtable(j_quant.LUMA_QTABLE, q)
    qc = j_quant.scale_qtable(j_quant.CHROMA_QTABLE, q)
    for sub in (True, False):
        assert (t_jpeg.jpeg_headers(h, w, qy, qc, sub)
                == j_jpeg.jpeg_headers(h, w, qy, qc, sub))


def test_video_encoder_base_copy_equal():
    """Same methods with the same bodies (up to the import of the core,
    the port's own copy); the port has no WARM_DEVICE."""
    a, b = t_base.VideoEncoder, j_base.VideoEncoder
    names = sorted(n for n, v in vars(b).items() if inspect.isfunction(v))
    assert names == sorted(n for n, v in vars(a).items()
                           if inspect.isfunction(v))
    for n in names:
        src = inspect.getsource(getattr(a, n)).replace(
            "from flutpu.core import", "from ..core import")
        assert src == inspect.getsource(getattr(b, n)), n
    assert (a.SINK_CAPS, a.SRC_CAPS) == (b.SINK_CAPS, b.SRC_CAPS)
    assert not hasattr(a, "WARM_DEVICE") and b.WARM_DEVICE is True


def test_scene_event_name_equal():
    assert t_encoder.SCENE_NEW_EVENT_NAME == j_events.SCENE_NEW_EVENT_NAME


def test_scene_event_parse_copy():
    ev = j_events.SceneNewEvent(3, 12)
    assert t_fvc._scene_gop_size(ev) == j_events.SceneNewEvent.parse(ev) \
        .gop_size == 12
    other = j_events.SceneNewEvent(0, 8)
    other.name = "something-else"
    assert t_fvc._scene_gop_size(other) is None
    assert j_events.SceneNewEvent.parse(other) is None


def test_fvc_constants_equal():
    assert (t_fvc.MAGIC, t_fvc.VERSION, t_fvc._CLAMP) == \
        (j_fvc.MAGIC, j_fvc.VERSION, j_fvc._CLAMP)
    for dim in (8, 96, 160):
        np.testing.assert_array_equal(t_fvc._bd_dct_matrix(dim),
                                      j_dct._bd_dct_matrix(dim))


@pytest.mark.parametrize("motion,bframes,bquality", [
    pytest.param(False, 0, None, id="False"),
    pytest.param(True, 0, None, id="True"),
    pytest.param(True, 1, None, id="True-bframes"),
    pytest.param(True, 1, 41, id="True-bframes-bquality")])
def test_fvc_chunk_layout_equal(motion, bframes, bquality):
    """The container writer is flutpu's, byte for byte: header (with the
    bquality byte when B frames are on), per-frame records, zlib'd
    vectors (fwd | bwd | modes for B frames, fwd alone for P anchors),
    intra frames without vectors."""
    rng = np.random.default_rng(1)
    payloads = [rng.integers(0, 256, n, np.uint8).tobytes()
                for n in (40, 7, 0, 300, 12)]

    def vec():
        return rng.integers(-7, 8, (6, 10, 2)).astype(np.int8)

    if bframes:
        mvs = [(vec(), vec(), rng.integers(0, 4, (6, 10)).astype(np.int8))
               for _ in range(5)]
        itypes = np.array([1, 2, 0, 2, 1])
    else:
        mvs = [vec() for _ in range(5)]
        itypes = np.array([1, 0, 1, 0, 0])
    te = t_fvc.FvcEncoder(60, motion=motion, search_range=5, device="cpu",
                          bframes=bframes, bquality=bquality)
    je = j_fvc.FvcEncoder.__new__(j_fvc.FvcEncoder)
    je.quality, je.subsample, je.motion, je.search_range = 60, True, motion, 5
    je.subpel = je.planar = False
    je.bframes, je.bquality = te.bframes, te.bquality
    args = (payloads, mvs if motion else None, itypes if motion else None,
            5, 90, 160)
    assert te._build_chunk(*args) == je._build_chunk(*args)
    if bframes:
        assert te.bquality == (bquality or 52)


@pytest.mark.parametrize("kw", [{"motion": True, "subpel": True},
                                {"subsample": False}],
                         ids=["subpel", "444"])
def test_fvc_header_flags_equal(kw):
    """Half-pel (flags bit 2) and 4:4:4 (bit 0 clear) headers and records
    as flutpu's writer gives them."""
    rng = np.random.default_rng(2)
    payloads = [rng.integers(0, 256, n, np.uint8).tobytes()
                for n in (40, 7, 30)]
    mvs = [rng.integers(-15, 16, (6, 10, 2)).astype(np.int8)
           for _ in range(3)]
    te = t_fvc.FvcEncoder(60, search_range=5, device="cpu", **kw)
    je = j_fvc.FvcEncoder.__new__(j_fvc.FvcEncoder)
    je.quality, je.search_range = 60, 5
    je.subsample = kw.get("subsample", True)
    je.motion = je.subpel = kw.get("motion", False)
    je.planar, je.bframes, je.bquality = False, 0, None
    motion = je.motion
    args = (payloads, mvs if motion else None,
            np.array([1, 0, 0]) if motion else None, 3, 90, 160)
    assert te._build_chunk(*args) == je._build_chunk(*args)


@pytest.mark.parametrize("path", ["fluc/__init__.py", "fluc/threads.py",
                                  "fluc/bwmeter.py", "io/__init__.py",
                                  "io/downloader.py", "io/helper.py"])
def test_fluc_and_io_are_copies(path):
    """The port's fluc and io are flutpu's files as they are: their
    relative imports (``from .. import native``) reach the port's native
    loader and meter."""
    assert _read(os.path.join(ROOT, "flutpu_torch", path)) == \
        _read(os.path.join(ROOT, "flutpu", path))


def test_native_bindings_copy_flutpus():
    """The fluc and downloader bindings of the port's native loader are
    flutpu's, text for text, and so are its callback types."""
    mine, theirs = (_read(os.path.join(ROOT, pkg, "native.py"))
                    for pkg in ("flutpu_torch", "flutpu"))
    mark = "    # fluc primitives\n"
    assert mine[mine.index(mark):] == theirs[theirs.index(mark):]
    for name in ("DATA_CB", "DONE_CB"):
        start = theirs.index(f"{name} = ")
        text = theirs[start:theirs.index(")\n", start) + 2]
        assert text in mine


def _method_sources(a, b, names):
    for n in names:
        assert inspect.getsource(getattr(a, n)) == \
            inspect.getsource(getattr(b, n)), n


def test_rate_controller_copies_flutpus():
    from flutpu_torch.codec.fvc import CudaFvcEnc
    _method_sources(CudaFvcEnc, j_fvc.FvcEnc,
                    ["_chunk_target_bytes", "_flush_chunk"])
    assert (CudaFvcEnc._RC_MIN_Q, CudaFvcEnc._RC_MAX_Q) == \
        (j_fvc.FvcEnc._RC_MIN_Q, j_fvc.FvcEnc._RC_MAX_Q)


def test_ladder_copies_flutpus():
    from flutpu.codec import ladder as j_ladder
    from flutpu_torch.codec import ladder as t_ladder
    for name in ("Rung", "parse_rungs"):
        assert inspect.getsource(getattr(t_ladder, name)) == \
            inspect.getsource(getattr(j_ladder, name))
    _method_sources(t_ladder.CudaFvcLadderEnc, j_ladder.FvcLadderEnc,
                    ["_rebuild_pads", "_emit_caps", "_chain",
                     "_select_rung", "_sink_event"])


def test_url_image_fetch_copies_flutpus():
    from flutpu.ttml.render import render_el as j_render
    from flutpu_torch.ttml.render import render_el as t_render
    _method_sources(t_render.TTMLRender, j_render.TTMLRender,
                    ["_fetch_image"])


@pytest.mark.parametrize("bframes", range(1, 8))
def test_bframe_structure_equal(bframes):
    for f in range(1, 13):
        assert t_fvc._bframe_structure(f, bframes) == \
            j_fvc._bframe_structure(f, bframes)


# -- the kernel build, composed but not run ------------------------------------

def test_build_finds_sources_and_composes_sm90a_command():
    """One nvcc per source (they run side by side), each to an object,
    then one link into the shared library."""
    paths = _build.source_paths()
    assert [os.path.basename(p) for p in paths] == [
        "frontend.cu", "entropy_pack.cu", "motion.cu"]
    assert all(os.path.isfile(p) for p in paths)
    out = _build.library_path()
    assert os.path.dirname(out) == _build.BUILD_DIR
    assert _build.source_hash() in os.path.basename(out)
    jobs = _build.compile_commands("/objs", nvcc="nvcc")
    assert [cmd[-1] for cmd, _ in jobs] == paths
    for (cmd, obj), src in zip(jobs, paths):
        assert cmd[0] == "nvcc"
        assert cmd[cmd.index("-gencode") + 1] == \
            "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-c", "-fPIC", "-Xptxas=-v"):
            assert flag in cmd
        assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
        assert cmd[cmd.index("-o") + 1] == obj
        assert obj == os.path.join("/objs", os.path.basename(src) + ".o")
    link = _build.link_command(out, [o for _, o in jobs], nvcc="nvcc")
    assert link[:4] == ["nvcc", "-shared", "-o", out]
    assert link[4:] == [o for _, o in jobs]


def test_build_hash_covers_every_included_header():
    """Each header the sources include is hashed with them, so a change to
    it rebuilds the library."""
    text = "".join(_read(p) for p in _build.source_paths())
    assert set(re.findall(r'^#include "([^"]+)"', text, re.M)) == \
        set(_build.HEADERS)
    for name in _build.HEADERS:
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, name))


def test_c_entries_match_the_sources():
    """Every entry _configure binds is an extern "C" function of the
    sources, returning int (a cudaError_t)."""
    text = "".join(_read(p) for p in _build.source_paths())
    defined = set(re.findall(r"^int (flu_\w+)\(", text, re.M))
    assert defined == {"flu_front_end_init", "flu_front_end",
                       "flu_front_end_quotient_check", "flu_pack_init", "flu_pack_segments",
                       "flu_pack_blocks", "flu_pack_slots64",
                       "flu_pack_slots32",
                       "flu_motion_search_mc", "flu_motion_search_mc_blocks",
                       "flu_motion_search_hier", "flu_chroma_mc"}

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = Lib()
    _build._configure(lib)
    assert set(vars(lib)) == defined


def test_build_output_is_ignored_by_git():
    lines = _read(os.path.join(ROOT, ".gitignore")).split()
    assert "flutpu_torch/_build/" in lines


# -- the native library ---------------------------------------------------------

def _makefile_var(text, name):
    return re.search(rf"^{name} \?= (.*)$", text, re.M).group(1).split()


def test_native_build_follows_the_makefile():
    """Every source the Makefile builds, compiled with its flags (less its
    warnings and dependency files), one object each in the port's build
    directory, linked with -lz; the Makefile itself writes into flutpu."""
    mk = _read(os.path.join(ROOT, "native", "Makefile"))
    flags = [f for f in _makefile_var(mk, "CXXFLAGS")
             if not f.startswith("-W")]
    assert list(native.CXX_FLAGS) == flags
    assert list(native.LD_FLAGS) == _makefile_var(mk, "LDFLAGS")
    srcs = native.source_paths()
    assert sorted(os.path.relpath(p, native.NATIVE_DIR) for p in srcs) == \
        sorted(f"{d}/{n}" for d in ("bitstream", "fluc", "downloader")
               for n in os.listdir(os.path.join(native.NATIVE_DIR, d))
               if n.endswith(".cpp"))
    jobs = native.compile_commands("/objs", cxx="g++")
    for (cmd, obj), src in zip(jobs, srcs):
        assert cmd == ["g++", *flags, "-c", "-o", obj, src]
        assert os.path.dirname(obj) == "/objs"
    assert len({o for _, o in jobs}) == len(jobs)
    out = native.library_path()
    assert os.path.dirname(out) == _build.BUILD_DIR
    assert native.source_hash() in os.path.basename(out)
    assert native.link_command(out, ["a.o"], cxx="g++") == \
        ["g++", "-shared", "-pthread", "-o", out, "a.o", "-lz"]


def test_native_library_equals_flutpus():
    """The port's build of the sources and flutpu's give the same scan
    and the same compacted segments."""
    from flutpu import native as j_native
    from flutpu.codec.ops.entropy import compact_segments_finalize as j_comp
    lib = native.get_lib()
    assert lib is not None and j_native.get_lib() is not None
    for name in ("flu_jpeg_encode_scan", "flu_jpeg_decode_scan",
                 "flu_compact_segments_finalize"):
        assert getattr(lib, name).restype is not None
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 200, 12).astype(np.uint32)
    words = rng.integers(0, 2 ** 32, int((bits + 31).sum() // 32) + 4,
                         dtype=np.uint64).astype(np.uint32)
    aligned = np.zeros_like(words)
    pos = 0
    for n in bits:
        k = (int(n) + 31) // 32
        aligned[pos:pos + k] = words[pos:pos + k]
        if n % 32:
            aligned[pos + k - 1] &= np.uint32((0xFFFFFFFF << (32 - n % 32))
                                              & 0xFFFFFFFF)
        pos += k
    assert t_entropy.compact_segments_finalize(bits, aligned) == \
        j_comp(bits, aligned)


def test_native_build_is_ignored_by_git():
    lines = _read(os.path.join(ROOT, ".gitignore")).split()
    assert os.path.relpath(os.path.dirname(native.library_path()),
                           ROOT) + "/" in lines


def test_no_port_source_names_jax_or_the_jax_package():
    """The import scan, file by file: no module under flutpu_torch/ (the
    ttml tree included) has an import statement of jax or of flutpu."""
    import ast
    pkg = os.path.join(ROOT, "flutpu_torch")
    seen = set()
    for d, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            seen.add(os.path.relpath(path, pkg))
            for n in ast.walk(ast.parse(_read(path))):
                names = []
                if isinstance(n, ast.Import):
                    names = [a.name for a in n.names]
                elif isinstance(n, ast.ImportFrom) and not n.level:
                    names = [n.module or ""]
                elif isinstance(n, ast.Call) and getattr(
                        n.func, "id", "") == "__import__" and n.args:
                    names = [getattr(n.args[0], "value", "")]
                for name in names:
                    assert name.split(".")[0] not in ("jax", "jaxlib",
                                                      "flutpu"), (path, name)
    for must in ("codec/avimux.py", "codec/decoders.py", "codec/ladder.py",
                 "fluc/__init__.py", "fluc/threads.py", "fluc/bwmeter.py",
                 "io/__init__.py", "io/downloader.py", "io/helper.py",
                 "hype/cuda.py", "hype/hypebin.py", "parallel/gop.py",
                 "parallel/mesh.py", "parallel/multihost.py",
                 "inject/injectbin.py", "ttml/base.py", "ttml/render/device.py",
                 "ttml/render/atlas.py", "ttml/render/render_el.py",
                 "ttml/render/overlay_el.py", "ttml/render/fonts.py"):
        assert must in seen


def test_chip_smoke_imports_only_the_port():
    """Every import in chip_smoke.py, at any depth, is the standard
    library, numpy, torch or flutpu_torch (phase 15f serves loopback HTTP
    and writes a PNG with the standard library; phase 16d loads the
    two-process worker of ``tests/`` by its path)."""
    import ast
    tree = ast.parse(_read(os.path.join(ROOT, "chip_smoke.py")))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    tops = {n.split(".")[0] for n in names}
    assert "flutpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flutpu"}
    assert tops <= {"flutpu_torch", "numpy", "torch", "__future__", "ctypes",
                    "hashlib", "json", "os", "struct", "subprocess", "sys",
                    "threading", "time", "base64", "http", "tempfile",
                    "zlib", "importlib"}, tops


def test_chip_smoke_fails_without_a_card():
    """Where torch sees no CUDA device the script exits nonzero and prints
    no result line."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
