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
frames, info = FvcDecoder().decode_chunk(chunks[0])
assert len(chunks) == 1 and frames.shape == (3, 32, 64, 3), frames.shape
import numpy as np
from flutpu_torch.codec.fvc import FvcEncoder
clip = np.stack([np.roll(np.arange(32 * 64 * 3, dtype=np.uint8)
                         .reshape(32, 64, 3), i, axis=1) for i in range(3)])
b = FvcEncoder(motion=True, hier=True, bframes=1, device="cpu")
assert 2 in FvcDecoder().decode_chunk(b.encode_chunk(clip))[1]["types"]
assert sys.modules["jax"] is None and sys.modules["flutpu"] is None
print("encoded", len(out), "chunks", len(chunks))
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
print("modules", sum(m.startswith("flutpu_torch") for m in sys.modules))
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


def test_every_module_imports_without_jax_or_the_jax_package():
    assert "modules" in _run(_NO_JAX_IMPORTS)


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


def test_c_entries_match_the_sources():
    """Every entry _configure binds is an extern "C" function of the
    sources, returning int (a cudaError_t)."""
    text = "".join(_read(p) for p in _build.source_paths())
    defined = set(re.findall(r"^int (flu_\w+)\(", text, re.M))
    assert defined == {"flu_front_end_init", "flu_front_end",
                       "flu_pack_init", "flu_pack_segments",
                       "flu_pack_blocks", "flu_pack_slots64", "flu_pack_slots32",
                       "flu_motion_search_mc", "flu_motion_search_mc_blocks",
                       "flu_motion_refine_mc", "flu_chroma_mc"}

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


def test_chip_smoke_imports_only_the_port():
    """Every import in chip_smoke.py, at any depth, is the standard
    library, numpy, torch or flutpu_torch."""
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
                    "json", "os", "subprocess", "sys", "time"}, tops


def test_chip_smoke_fails_without_a_card():
    """Where torch sees no CUDA device the script exits nonzero and prints
    no result line."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
