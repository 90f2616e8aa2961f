"""The port's copy of the dataflow core (``flutpu_torch.core``) against
flutpu's (``flutpu.core``): the same behaviour through the same public
API, each package with its own registry."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import flutpu.core
import flutpu_torch.core
from flutpu_torch.core import log as t_log

torch.set_num_threads(1)

PKGS = [pytest.param(flutpu.core, id="flutpu"),
        pytest.param(flutpu_torch.core, id="port")]


@pytest.mark.parametrize("core", PKGS)
def test_caps_parse_and_intersect(core):
    c = core.Caps.from_string(
        "video/x-raw, format=RGB, width=320, height=240, framerate=30/1")
    assert (c.media_type, c["format"], c["width"]) == ("video/x-raw", "RGB",
                                                       320)
    assert c["framerate"].numerator == 30
    assert c.intersect(core.Caps.from_string("video/x-raw, format=RGB")) \
        ["width"] == 320
    assert c.intersect(core.Caps.from_string(
        "video/x-raw, format=I420")) is None
    ranged = core.Caps.from_string(
        "video/x-raw, width=[ 16, 4096 ], format={ RGB, I420 }")
    assert ranged.intersect(c)["width"] == 320


@pytest.mark.parametrize("core", PKGS)
def test_parse_launch_chain_props_and_unknown_factory(core):
    p = core.parse_launch("identity name=a sleep-time=42 silent=false "
                          "! identity name=b")
    a, b = p.get_by_name("a"), p.get_by_name("b")
    assert a.srcpad.peer is b.sinkpad
    assert a.get_property("sleep-time") == 42
    assert a.get_property("silent") is False
    with pytest.raises(ValueError):
        core.parse_launch("nosuchelement ! identity")


@pytest.mark.parametrize("core", PKGS)
def test_harness_push_pull_and_eos(core):
    h = core.Harness("identity")
    h.set_src_caps("video/x-raw, format=RGB, width=1, height=1")
    h.push(core.Buffer(b"a", pts=0))
    h.push(core.Buffer(b"b", pts=1))
    h.push_eos()
    assert h.pull().data == b"a"
    assert h.pull().data == b"b"
    assert h.pull(timeout=2) is None
    assert h.wait_for_eos(2)
    h.teardown()


@pytest.mark.parametrize("core", PKGS)
def test_queue_decouples_thread_and_passes_eos(core):
    q = core.make("queue")
    q.set_state(core.State.PLAYING)
    out, threads, eos = [], [], threading.Event()
    sink = core.Pad("sink", core.PadDirection.SINK)
    sink.chain_function = lambda p, b: (
        out.append(b.data), threads.append(threading.current_thread()),
        core.FlowReturn.OK)[2]
    sink.event_function = lambda p, e: (
        eos.set() if e.type == core.EventType.EOS else None, True)[1]
    q.srcpad.link(sink)
    for i in range(5):
        assert q.sinkpad.chain(core.Buffer(i)) == core.FlowReturn.OK
    q.sinkpad.send_event(core.EosEvent())
    assert eos.wait(5)
    deadline = time.monotonic() + 5
    while len(out) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert out == [0, 1, 2, 3, 4]
    assert all(t is not threading.main_thread() for t in threads)
    q.set_state(core.State.NULL)


def _convert(core, in_fmt, out_fmt, data):
    p = core.parse_launch(
        f"appsrc name=src caps='video/x-raw, format={in_fmt}, width=16, "
        f"height=8' ! videoconvert ! capsfilter caps='video/x-raw, "
        f"format={out_fmt}' ! appsink name=out")
    src, sink = p.get_by_name("src"), p.get_by_name("out")
    p.play()
    src.push(core.Buffer(data, pts=0))
    src.end_of_stream()
    buf = sink.try_pull_buffer(timeout=10)
    p.stop()
    return buf.data


def test_videoconvert_i420_equal_to_flutpu():
    """RGB → I420 and back: the port converts with its colorspace ops in
    torch where flutpu uses jax, to the same u8 planes and pixels."""
    rgb = np.random.default_rng(4).integers(0, 256, (8, 16, 3), np.uint8)
    want = _convert(flutpu.core, "RGB", "I420", rgb)
    got = _convert(flutpu_torch.core, "RGB", "I420", rgb)
    for k in ("y", "u", "v"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(_convert(flutpu_torch.core, "I420", "RGB",
                                           got),
                                  _convert(flutpu.core, "I420", "RGB", want))


def test_registries_are_separate():
    """A launch string holds one package's elements: the port's registry
    has the core elements and its own encoders, flutpu's has its own."""
    port, ref = flutpu_torch.core.factories(), flutpu.core.factories()
    assert {"cudajpegenc", "cudafvcenc", "queue", "videotestsrc",
            "appsink"} <= set(port)
    assert not {"tpujpegenc", "fvcenc"} & set(port)
    assert not {"cudajpegenc", "cudafvcenc"} & set(ref)
    assert all(c.__module__.startswith("flutpu_torch.")
               for c in port.values())
    with pytest.raises(ValueError):
        flutpu_torch.core.parse_launch("videotestsrc ! fvcenc ! fakesink")


def test_public_api_and_modules_match_flutpu():
    """Same names in ``__all__`` and the same modules, less devwarm (the
    TPU backend's warm-up), and no WARM_DEVICE on the element base."""
    assert flutpu_torch.core.__all__ == flutpu.core.__all__

    def modules(pkg):
        return sorted(n for n in os.listdir(os.path.dirname(pkg.__file__))
                      if n.endswith(".py"))
    assert modules(flutpu_torch.core) == [
        n for n in modules(flutpu.core) if n != "devwarm.py"]
    assert not hasattr(flutpu_torch.core.Element, "WARM_DEVICE")


def test_trace_span_records_under_the_torch_profiler():
    with t_log.trace_span("outside-any-profiler"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t_log.trace_span("flutpu-span"):
            torch.ones(4).sum()
    assert "flutpu-span" in {e.name for e in prof.events()}
