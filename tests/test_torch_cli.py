"""The port's command-line tools and examples on the CPU:
``python -m flutpu_torch.launch`` against flutpu's ``launch`` (same
JFIF, same FVC chunks or a stated tie), its exit on the first ERROR,
``python -m flutpu_torch.inspect`` and the element reference it
generates, the scan that every public name and element property of
flutpu has its counterpart in the port, and the seven
``examples/torch/*.py`` at small sizes with ``--device cpu``, each beside
flutpu's example logic where the two can run side by side."""

import ast
import importlib.util
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from flutpu import launch as j_launch
from flutpu.codec.fvc import FvcDecoder as JFvcDecoder
from flutpu.codec.jpeg import psnr as j_psnr
from flutpu.core.elements import make_test_frame
from flutpu_torch import inspect as t_inspect
from flutpu_torch import launch as t_launch
from flutpu_torch.core import factories
from chip_smoke import Loopback, png_rgb, split_jfif

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch")
ELEMENTS_MD = os.path.join(ROOT, "docs", "ELEMENTS_TORCH.md")

#: flutpu's factory → the port's (the rest keep their names)
RENAMED = {"tpujpegenc": "cudajpegenc", "fvcenc": "cudafvcenc",
           "fvcladderenc": "cudafvcladderenc", "tpuhype": "cudahype",
           "jpegdec": "cudajpegdec", "fvcdec": "cudafvcdec",
           "ttmlrender": "cudattmlrender",
           "overlaycompositor": "cudaoverlaycompositor"}


def _subprocess(args, env=None, timeout=120):
    env = dict(os.environ if env is None else env, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


# -- launch ------------------------------------------------------------------

def test_launch_writes_flutpus_jfif(tmp_path):
    """The same launch line through flutpu's ``tpujpegenc`` and the port's
    ``cudajpegenc device=cpu`` writes byte-identical files: 16 JFIF."""
    line = ("videotestsrc num-buffers=16 pattern=ball width=64 height=48 "
            "! {enc} batch-frames=8 ! filesink location={out}")
    a, b = tmp_path / "flutpu.mjpeg", tmp_path / "port.mjpeg"
    assert j_launch.main([line.format(enc="tpujpegenc", out=a)]) == 0
    assert t_launch.main([line.format(enc="cudajpegenc device=cpu",
                                      out=b)]) == 0
    data = b.read_bytes()
    assert data == a.read_bytes()
    frames = split_jfif(data)
    assert len(frames) == 16 and all(f.endswith(b"\xff\xd9")
                                     for f in frames)


def test_launch_writes_flutpus_fvc_chunks(tmp_path):
    """``fvcenc motion=true gop-size=8`` against ``cudafvcenc device=cpu
    motion=true gop-size=8`` on 16 frames: byte-identical chunks, or,
    where a rounding tie splits them, flutpu's FvcDecoder reads both
    within 0.05 dB (test_torch_fvc.py's contract)."""
    line = ("videotestsrc num-buffers=16 pattern=ball width=64 height=48 "
            "! {enc} motion=true gop-size=8 ! filesink location={out}")
    a, b = tmp_path / "flutpu.fvc", tmp_path / "port.fvc"
    assert j_launch.main([line.format(enc="fvcenc", out=a)]) == 0
    assert t_launch.main([line.format(enc="cudafvcenc device=cpu",
                                      out=b)]) == 0
    if a.read_bytes() == b.read_bytes():
        return
    dec = JFvcDecoder()
    src = [make_test_frame("ball", 64, 48, i) for i in range(16)]
    ps = [np.mean([j_psnr(s, f) for s, f in zip(src, dec.decode_stream(
        p.read_bytes()))]) for p in (a, b)]
    assert abs(ps[0] - ps[1]) <= 0.05, ps


@pytest.mark.parametrize("frames,where", [
    (8, "element cudajpegenc"),      # the 8th frame's flush, in its chain
    (2, "thread videotestsrc")])     # the flush at EOS, in its event
def test_launch_returns_1_on_the_first_error(frames, where, monkeypatch,
                                             capsys):
    """At its default ``device=cuda`` and without a card, ``cudajpegenc``
    fails: in a pad's chain it posts an ERROR, in its EOS flush the
    source's streaming thread ends on the exception. Either way launch
    stops the pipeline, prints the error and returns 1 at once (flutpu's
    loop waits for an EOS that never comes). ``FLUTPU_CPU`` is not read:
    nothing falls back to the CPU."""
    monkeypatch.setenv("FLUTPU_CPU", "1")
    t0 = time.monotonic()
    rc = t_launch.main([f"videotestsrc num-buffers={frames} width=64 "
                        "height=48 ! cudajpegenc batch-frames=8 ! fakesink"])
    assert rc == 1
    assert time.monotonic() - t0 < 20
    err = capsys.readouterr().err
    assert f"ERROR from {where}" in err
    assert "CUDA" in err


def test_launch_refusals_return_1(capsys, tmp_path):
    """A line that does not parse, and a pipeline that refuses to start
    (a hype bin whose encoders agree on no caps), return 1."""
    assert t_launch.main(["videotestsrc ! nosuchelement"]) == 1
    assert t_launch.main(["videotestsrc ! fakesink nosuchprop=1"]) == 1
    assert t_launch.main([
        "videotestsrc num-buffers=2 ! hype encoder-0='cudajpegenc "
        "device=cpu' encoder-1='cudafvcenc device=cpu' ! fakesink"]) == 1
    err = capsys.readouterr().err
    assert "could not build pipeline" in err
    assert "refused to start" in err


def test_watch_errors_counts_only_its_own_threads():
    """A thread alive before the block that dies in it is not the
    pipeline's error; one started in the block is. The hook in place at
    entry gets every exception, and is back in place after the block, as
    is the bus without the block's watch."""
    from flutpu_torch.core import parse_launch
    seen = []
    prev = threading.excepthook
    threading.excepthook = lambda hook: seen.append(hook.thread.name)
    try:
        go = threading.Event()

        def fail():
            go.wait()
            raise RuntimeError("boom")

        old = threading.Thread(target=fail, name="older", daemon=True)
        old.start()
        p = parse_launch("videotestsrc ! fakesink")
        watches = list(p.bus._watchers)
        with t_launch.watch_errors(p) as errors:
            go.set()
            old.join()
            new = threading.Thread(target=fail, name="newer", daemon=True)
            new.start()
            new.join()
        assert errors == ["thread newer: RuntimeError: boom"]
        assert seen == ["older", "newer"]
        assert p.bus._watchers == watches
        assert threading.excepthook is not t_launch._thread_died
    finally:
        threading.excepthook = prev


def test_watch_errors_blocks_that_overlap():
    """Two blocks that overlap, left in either order: each sees the
    errors of the threads started while it is open, and the hook found
    before the first is back after the last."""
    from flutpu_torch.core import parse_launch
    prev = threading.excepthook
    threading.excepthook = quiet = (lambda hook: None)

    def die(name):
        t = threading.Thread(target=lambda: 1 / 0, name=name, daemon=True)
        t.start()
        t.join()

    try:
        for a_leaves_first in (True, False):
            a_cm = t_launch.watch_errors(parse_launch("videotestsrc ! "
                                                      "fakesink"))
            b_cm = t_launch.watch_errors(parse_launch("videotestsrc ! "
                                                      "fakesink"))
            a = a_cm.__enter__()
            die("one")
            b = b_cm.__enter__()
            die("two")
            first, second = (a_cm, b_cm) if a_leaves_first else (b_cm, a_cm)
            first.__exit__(None, None, None)
            die("three")
            second.__exit__(None, None, None)
            assert threading.excepthook is quiet
            named = [[e.split(":")[0][len("thread "):] for e in x]
                     for x in (a, b)]
            assert named == ([["one", "two"], ["two", "three"]]
                             if a_leaves_first else
                             [["one", "two", "three"], ["two"]])
    finally:
        threading.excepthook = prev


def test_appsink_interrupt_ends_a_waiting_pull():
    """What the examples call on an error, after which no EOS comes."""
    from flutpu_torch.core import make
    sink = make("appsink")
    threading.Timer(0.1, sink.interrupt).start()
    t0 = time.monotonic()
    assert sink.try_pull_buffer(timeout=30) is None
    assert time.monotonic() - t0 < 10


def test_launch_verbose_names_each_factory(capsys):
    assert t_launch.main(["-v", "videotestsrc num-buffers=2 width=32 "
                          "height=16 ! fakesink"]) == 0
    err = capsys.readouterr().err
    assert "(videotestsrc)" in err and "(fakesink)" in err
    assert "bus: Message(eos" in err


def test_launch_module_runs_in_a_subprocess(tmp_path):
    """``python -m flutpu_torch.launch`` with jax and flutpu blocked:
    exit 0 and the file, as in process."""
    out = tmp_path / "a.mjpeg"
    line = (f"videotestsrc num-buffers=4 pattern=ball width=64 height=48 "
            f"! cudajpegenc device=cpu batch-frames=4 ! filesink "
            f"location={out}")
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['flutpu'] = None; sys.argv = sys.argv[:1] + "
            f"[{line!r}]; runpy.run_module('flutpu_torch.launch', "
            "run_name='__main__')")
    res = _subprocess(["-c", code])
    assert res.returncode == 0, res.stderr[-2000:]
    assert len(split_jfif(out.read_bytes())) == 4
    res = _subprocess(["-m", "flutpu_torch.launch",
                       "videotestsrc num-buffers=2 ! cudajpegenc ! fakesink"],
                      env=dict(os.environ, FLUTPU_CPU="1"))
    assert res.returncode == 1
    assert "CUDA" in res.stderr


# -- inspect -----------------------------------------------------------------

def test_every_factory_is_in_the_reference():
    """Every factory of the port's registry has its section, and each
    constructs (its pad table is listed) without a card."""
    regs = factories()
    assert len(regs) == 28
    md = t_inspect._markdown(regs)
    for name, cls in regs.items():
        assert f"## `{name}`" in md
        cls()
    assert md.count("| pad | direction | template caps |") == 28


def test_reference_file_is_current():
    """docs/ELEMENTS_TORCH.md is ``python -m flutpu_torch.inspect
    --markdown`` as it stands: a stale reference fails here."""
    with open(ELEMENTS_MD) as fh:
        assert fh.read() == t_inspect._markdown(factories())


def test_every_flutpu_factory_has_a_counterpart():
    from flutpu.core import factories as j_factories
    mine = set(factories())
    assert {RENAMED.get(n, n) for n in j_factories()} == mine


#: public top-level names of flutpu that are TPU tooling, with the reason
#: the port has none
TPU_ONLY = {
    "CPU_BUSY_PATH": "benchlock.py: lock files of the TPU bench host",
    "LOCK_PATH": "benchlock.py: lock files of the TPU bench host",
    "hold_cpu_busy": "benchlock.py: lock files of the TPU bench host",
    "hold_tpu_lock": "benchlock.py: lock files of the TPU bench host",
    "warm_device": "core/devwarm.py: the TPU's first execution on the main "
                   "thread",
    "skip_warmup": "core/devwarm.py: the TPU's first execution on the main "
                   "thread",
    "TILE_N": "entropy_pallas.py: lanes per Pallas grid step",
    "TILE_SEG": "entropy_pallas.py: lanes per Pallas grid step",
    "front_end_fits": "frontend_pallas.py: the kernel's VMEM-fit gate; K1 "
                      "takes every size",
    "chroma_mc_fits": "motion_pallas.py: the kernel's VMEM-fit gate; K4 "
                      "takes every size",
    "motion_search_ssd_mxu": "motion.py: an MXU (systolic array) form of "
                             "the search that no encoder path runs",
    "chunk_sharding": "parallel/mesh.py: a JAX NamedSharding",
}

#: flutpu's public names → the port's names for the same thing
RENAMED_NAMES = {
    "TpuJpegEnc": "CudaJpegEnc", "FvcEnc": "CudaFvcEnc",
    "FvcLadderEnc": "CudaFvcLadderEnc", "TpuHype": "CudaHype",
    "JpegDec": "CudaJpegDec", "FvcDec": "CudaFvcDec",
    "front_end_pallas": "front_end", "front_end_reference": "front_end_plain",
    "pack_segments_fused": "pack_segments",
    "pack_block_bits_pallas64": "pack_block_bits64",
    "pack_block_bits_pallas": "pack_block_bits",
    "motion_search_mc_dxmajor_pallas": "motion_search_mc",
    "motion_search_mc_pallas": "motion_search_mc_blocks",
    "motion_search_mc_dygrid_pallas": "motion_search_mc_dygrid",
    "motion_search_mc_hier_pallas": "motion_search_mc_hier",
    "chroma_mc_pallas": "chroma_mc",
    "encode_chunks_sharded": "encode_chunks",
    "fvc_chunks_sharded": "fvc_chunks",
}


def _public_names(package: str) -> set:
    """Public (no leading underscore) top-level functions, classes and
    assigned names of every module under ``package``."""
    names = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, package)):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    names.add(node.name)
                elif isinstance(node, ast.Assign):
                    names.update(t.id for t in node.targets
                                 if isinstance(t, ast.Name))
                elif isinstance(node, ast.AnnAssign) and \
                        isinstance(node.target, ast.Name):
                    names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_flutpu_has_a_counterpart():
    """The port does all that flutpu does but its TPU tooling: every
    public top-level name of ``flutpu/**.py`` is one of the port's, or a
    rename of it, or on the reasoned TPU-only list; neither list holds a
    name it need not."""
    flutpu, port = _public_names("flutpu"), _public_names("flutpu_torch")
    missing = flutpu - port - set(TPU_ONLY) - set(RENAMED_NAMES)
    assert not missing, sorted(missing)
    assert set(TPU_ONLY) <= flutpu - port
    assert set(RENAMED_NAMES) <= flutpu - port
    assert set(RENAMED_NAMES.values()) <= port


def test_every_element_property_has_its_counterpart():
    """Each flutpu element's properties are its counterpart's, in order,
    less the port's ``device``."""
    from flutpu.core import factories as j_factories
    mine = factories()
    for name, cls in j_factories().items():
        theirs = [p.name for p in cls._all_prop_specs()]
        port = [p.name for p in mine[RENAMED.get(name, name)]
                ._all_prop_specs() if p.name != "device"]
        assert port == theirs, name


def test_inspect_details_and_listing(capsys):
    assert t_inspect.main(["cudajpegenc"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^  device +default='cuda'", out, re.M)
    assert "Class:   flutpu_torch.codec.encoder.CudaJpegEnc" in out
    assert "sink  sink" in out and "src   src" in out
    assert t_inspect.main(["hype"]) == 0
    assert "(has request pads)" not in capsys.readouterr().out
    assert t_inspect.main(["outputselector"]) == 0
    assert "(has request pads)" in capsys.readouterr().out
    assert t_inspect.main([]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert names == sorted(factories())
    assert t_inspect.main(["tpujpegenc"]) == 1
    assert "no such element factory 'tpujpegenc'" in capsys.readouterr().err


def test_reference_states_what_the_port_does():
    """The repaired property docs: cudajpegenc encodes 4:4:4, cudahype
    deals its chunks round the cards, both encoders take the host entropy
    engine; every device property defaults to the card."""
    md = t_inspect._markdown(factories())
    assert "only 4:2:0 is ported" not in md
    assert "false encodes 4:4:4" in md
    assert "visible cards // spatial" in md
    assert "always runs on the device" not in md
    assert md.count(r"auto \| device \| host entropy coding; auto never "
                    "leaves the device here") == 2
    devices = re.findall(r"^\| `device` \| `([^`]*)` \|", md, re.M)
    assert devices == ["'cuda'"] * 8


# -- the examples ------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv, capsys):
    assert _example(name).main(argv) == 0
    return capsys.readouterr().out


def test_example_encode_parallel(capsys):
    """Three ``cudafvcenc device=cpu`` branches of the hype bin: the
    stream decodes at >= 30 dB; the chunks and bytes are those of
    flutpu's example pipeline (``fvcenc`` branches) at the same size."""
    from flutpu.core import parse_launch
    out = _run("encode_parallel", ["10", "--size", "64x48", "--device",
                                   "cpu"], capsys)
    m = re.search(r"10 frames -> (\d+) chunks, (\d+) bytes", out)
    low = float(re.search(r"PSNR min/mean = ([\d.]+)/", out).group(1))
    assert low >= 30
    p = parse_launch("videotestsrc num-buffers=10 pattern=ball width=64 "
                     "height=48 ! hype gop-size=5 encoder-1=fvcenc "
                     "encoder-2=fvcenc encoder-3=fvcenc ! appsink name=out")
    sink = p.get_by_name("out")
    p.play()
    chunks = []
    while (b := sink.try_pull_buffer(timeout=60)) is not None:
        chunks.append(bytes(b.data))
    p.stop()
    assert (int(m.group(1)), int(m.group(2))) == \
        (len(chunks), len(b"".join(chunks)))


def test_example_fvc_motion(capsys):
    """v1 and v2 sizes equal flutpu's encoders' on the same frames; v2 is
    smaller than v1 on the moving ball; every decode >= 30 dB."""
    from flutpu.codec.fvc import FvcEncoder as JFvcEncoder
    out = _run("fvc_motion", ["6", "--size", "64x48", "--device", "cpu"],
               capsys)
    sizes = [int(v) for v in re.findall(r":\s+(\d+) bytes", out)]
    frames = np.stack([make_test_frame("ball", 64, 48, i) for i in range(6)])
    assert sizes[:2] == [
        len(JFvcEncoder(quality=85).encode_chunk(frames)),
        len(JFvcEncoder(quality=85, motion=True,
                        search_range=7).encode_chunk(frames))]
    assert sizes[1] < sizes[0]
    lows = [float(v) for v in re.findall(r"psnr min/mean ([\d.]+)/", out)]
    assert len(lows) == 3 and min(lows) >= 30


def test_example_fvc_batched_is_equal_on_the_cpu(capsys):
    out = _run("fvc_batched", ["--size", "80x48", "--frames", "3",
                               "--device", "cpu"], capsys)
    assert "byte-identical to separate dispatches: True" in out
    assert "differs" not in out
    assert "decoded chunk shapes: (3, 48, 80, 3) (3, 48, 80, 3)" in out


def test_example_inject_swap(capsys):
    out = _run("inject_swap", ["--device", "cpu"], capsys)
    m = re.search(r"(\d+) buffers out: (\d+) raw passthrough, (\d+) JPEG "
                  r"after the swap", out)
    assert m and int(m.group(3)) > 0
    assert int(m.group(1)) == int(m.group(2)) + int(m.group(3))


@pytest.mark.parametrize("args,label", [
    (["jpeg"], "demuxed 2 frames"),
    (["fvc"], "decoded (2, 96, 160, 3)"),
    (["fvc-motion", "2"], "decoded (2, 96, 160, 3)")])
def test_example_mesh_encode(args, label, capsys, tmp_path):
    """One shard on the CPU: at least one chunk, also with 2 stripes
    (flutpu's arithmetic would give 0 chunks there)."""
    out = _run("mesh_encode", [*args, "--device", "cpu", "--out",
                               str(tmp_path / "out.bin")], capsys)
    assert "1-chunk encode of 2 frames" in out and label in out
    assert float(re.search(r"last-frame psnr ([\d.]+)", out).group(1)) >= 30


def test_example_multidl(capsys, tmp_path):
    """A ``file://`` URL, a loopback HTTP URL and a missing file on one
    downloader; the meter counts the bytes."""
    path = tmp_path / "f.bin"
    path.write_bytes(b"z" * 3000)
    with Loopback({"/a.bin": b"q" * 5000}) as srv:
        out = _run("multidl", ["file://" + str(path), srv.url("/a.bin"),
                               srv.url("/missing")], capsys)
    assert f"file://{path}: OK http=0 3000 bytes" in out
    assert f"{srv.url('/a.bin')}: OK http=200 5000 bytes" in out
    assert "/missing: " in out and "bytes" in out
    assert int(re.search(r"total=(\d+) B", out).group(1)) >= 8000
    assert _example("multidl").main([]) == 2


def test_example_subtitle_burnin(capsys, tmp_path):
    """The PNG (written without Pillow) holds frame 0 with the subtitle
    burnt in: pixel for pixel flutpu's example logic (``ttmlrender`` and
    ``overlay_on_frames``) at the same size, and unlike the source frame
    in the subtitle region."""
    import jax.numpy as jnp
    from flutpu.core import Buffer, Harness
    from flutpu.ttml.render import overlay_on_frames
    png = tmp_path / "burnin.png"
    _run("subtitle_burnin", [str(png), "--size", "160x96", "--device",
                             "cpu"], capsys)
    got = png_rgb(png.read_bytes())
    src = make_test_frame("gradient", 160, 96, 0)
    region = (slice(int(96 * 0.78), int(96 * 0.96)),
              slice(int(160 * 0.1), int(160 * 0.9)))
    assert (got[region] != src[region]).any()
    h = Harness("ttmlrender window-width=160 window-height=96")
    h.set_src_caps("application/ttml+xml")
    h.push(Buffer(_example("subtitle_burnin").TTML.encode(), pts=0))
    h.push_eos()
    overlay = np.asarray(h.pull(timeout=20).data)
    h.teardown()
    want = np.asarray(overlay_on_frames(jnp.asarray(src[None]),
                                        jnp.asarray(overlay)))[0]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,argv", [
    ("fvc_motion", ["2", "--size", "32x16"]),
    ("mesh_encode", ["jpeg"]),
    ("encode_parallel", ["5", "--size", "32x16"]),
    ("subtitle_burnin", []),
    ("inject_swap", [])])
def test_example_without_device_fails_on_the_cuda_error(name, argv, capsys,
                                                         monkeypatch,
                                                         tmp_path):
    """Without ``--device`` an example runs on the card; here, without
    one, it fails on torch's CUDA error (``cudahype``: on finding no card
    to deal its chunks to) instead of running on the CPU (``FLUTPU_CPU``
    set, and not read)."""
    monkeypatch.setenv("FLUTPU_CPU", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    try:
        rc = _example(name).main(argv)
    except (AssertionError, RuntimeError) as e:
        assert "CUDA" in str(e)
        return
    assert rc == 1
    err = capsys.readouterr().err
    assert "CUDA" in err or "no device to deal the mesh's slots" in err
