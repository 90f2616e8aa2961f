"""The port's ``injectbin`` (a copy of flutpu's on the port's core)
against flutpu's: the same code, and the scenarios of
tests/test_injectbin.py giving the same results through both packages'
cores; then a ``cudajpegenc`` (on the CPU) swapped into a running stream,
prewarmed before the blocking probe, with no buffer lost or reordered."""

import gc
import importlib
import weakref

import numpy as np
import pytest
import torch

import flutpu.core
import flutpu.inject
import flutpu.inject.injectbin as j_injectbin
import flutpu_torch.core
import flutpu_torch.inject
import flutpu_torch.inject.injectbin as t_injectbin
from flutpu_torch.codec.jpeg import JpegEncoder
from torch_helpers import code_of

torch.set_num_threads(1)

CORES = [pytest.param(flutpu.core, id="flutpu"),
         pytest.param(flutpu_torch.core, id="port")]


def test_copy_holds_the_same_code():
    assert code_of(t_injectbin) == code_of(j_injectbin)
    assert code_of(flutpu_torch.inject) == code_of(flutpu.inject)
    assert flutpu_torch.core.make("injectbin").FACTORY == "injectbin"


def _identity(core):
    return importlib.import_module(core.__name__ + ".elements").Identity


def tagger(core, tag):
    el = _identity(core)()
    el.set_property("handoff", lambda e, b: b.meta.setdefault(
        "tags", []).append(tag))
    return el


@pytest.mark.parametrize("core", CORES)
def test_passthrough_injection_and_null(core):
    h = core.Harness("injectbin")
    bin_el = h.pipeline.iterate_elements()[0]
    h.set_src_caps("video/x-raw, format=RGB, width=2, height=2")
    h.push(core.Buffer(b"0", pts=0))
    assert h.pull().meta.get("tags") is None
    bin_el.set_property("element", tagger(core, "A"))
    h.push(core.Buffer(b"1", pts=core.MSECOND))
    assert h.pull().meta.get("tags") == ["A"]
    bin_el.set_property("element", None)
    h.push(core.Buffer(b"2", pts=2 * core.MSECOND))
    assert h.pull().meta.get("tags") is None
    h.teardown()


@pytest.mark.parametrize("core", CORES)
def test_switch_from_streaming_thread(core):
    h = core.Harness("injectbin")
    bin_el = h.pipeline.iterate_elements()[0]
    h.set_src_caps("video/x-raw, format=RGB")
    first = _identity(core)()
    first.set_property("handoff", lambda el, buf: bin_el.set_property(
        "element", tagger(core, "B")))
    bin_el.set_property("element", first)
    h.push(core.Buffer(b"1", pts=0))
    h.push(core.Buffer(b"2", pts=core.MSECOND))
    out1, out2 = h.pull(), h.pull()
    assert out1.meta.get("tags") is None and out2.meta.get("tags") == ["B"]
    h.teardown()


@pytest.mark.parametrize("core", CORES)
def test_queued_switches_single_notify(core):
    h = core.Harness("injectbin")
    bin_el = h.pipeline.iterate_elements()[0]
    h.set_src_caps("video/x-raw, format=RGB")
    h.push(core.Buffer(b"0", pts=0))
    h.pull()
    notifies = []
    bin_el.connect_notify("element", lambda e, p: notifies.append(
        e.get_property("element")))
    el1, el2 = tagger(core, "X"), tagger(core, "Y")
    bin_el.set_property("element", el1)
    bin_el.set_property("element", el2)
    assert notifies == []
    h.push(core.Buffer(b"1", pts=core.MSECOND))
    assert h.pull().meta.get("tags") == ["Y"]
    assert len(notifies) == 1 and notifies[0] is el2
    h.teardown()


@pytest.mark.parametrize("core", CORES)
def test_switch_inside_caps_probe_new_element_sees_event(core):
    h = core.Harness("injectbin")
    bin_el = h.pipeline.iterate_elements()[0]
    seen = []
    new_el = _identity(core)()
    forward = importlib.import_module(core.__name__ + ".pad")._forward_event

    def watch(pad, ev):
        if ev.type == core.EventType.CAPS:
            seen.append(ev.caps)
        return forward(pad, ev)
    new_el.sinkpad.event_function = watch

    def caps_probe(pad, data):
        if isinstance(data, core.CapsEvent):
            bin_el.set_property("element", new_el)
        return core.ProbeReturn.OK
    bin_el.sinkpad.add_probe(core.ProbeType.EVENT_DOWNSTREAM, caps_probe)
    h.set_src_caps("video/x-raw, format=RGB, width=7, height=7")
    h.push(core.Buffer(b"1", pts=0))
    assert h.pull().data == b"1"
    assert seen and seen[-1]["width"] == 7
    h.teardown()


@pytest.mark.parametrize("core", CORES)
def test_swap_in_live_pipeline_and_collect_the_old(core):
    """Mid-stream swaps in a running pipeline (BASELINE config 2's shape):
    exactly frames 10-24 tagged, all in order; the swapped-out element is
    garbage-collectable."""
    p = core.parse_launch("appsrc name=src caps='video/x-raw, format=RGB, "
                          "width=8, height=8' ! injectbin name=ib "
                          "! appsink name=out")
    src, ib, sink = (p.get_by_name(x) for x in ("src", "ib", "out"))
    assert p.play().name == "SUCCESS"
    frame = np.zeros((8, 8, 3), np.uint8)
    old = tagger(core, "mid")
    ref = weakref.ref(old)
    for i in range(30):
        if i == 10:
            ib.set_property("element", old)
        if i == 25:
            ib.set_property("element", None)
        src.push(core.Buffer(frame, pts=i * core.MSECOND, offset=i))
    src.end_of_stream()
    got = [sink.try_pull_buffer(timeout=10) for _ in range(30)]
    p.stop()
    assert all(b is not None for b in got)
    assert [i for i, b in enumerate(got)
            if b.meta.get("tags") == ["mid"]] == list(range(10, 25))
    assert [b.pts for b in got] == sorted(b.pts for b in got)
    del old, got
    gc.collect()
    assert ref() is None, "swapped-out element leaked"


def test_cuda_encoder_swap_prewarmed_before_block():
    """A ``cudajpegenc`` (its plain versions, ``device=cpu``) swapped into
    a flowing stream: prewarm builds the encoder and encodes one batch
    BEFORE the blocking probe exists; pre-swap frames pass through raw,
    post-swap frames come out as JPEG equal to a plain encode, none lost
    or reordered."""
    core = flutpu_torch.core
    p = core.parse_launch("appsrc name=src caps='video/x-raw, format=RGB, "
                          "width=32, height=16' ! injectbin name=ib "
                          "! appsink name=out")
    src, ib, sink = (p.get_by_name(x) for x in ("src", "ib", "out"))
    assert p.play().name == "SUCCESS"
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (8, 16, 32, 3), np.uint8)
    for i in range(4):
        src.push(core.Buffer(frames[i], pts=i * core.MSECOND, offset=i))
    enc = core.make("cudajpegenc", batch_frames=4, device="cpu")
    order = []
    orig_prewarm = enc.prewarm
    enc.prewarm = lambda caps=None: (order.append("prewarm"),
                                     orig_prewarm(caps))[1]
    orig_add = ib._identity.sinkpad.add_probe

    def add_probe(*a, **kw):
        order.append("probe")
        return orig_add(*a, **kw)
    ib._identity.sinkpad.add_probe = add_probe
    ib.set_property("element", enc)
    assert order == ["prewarm", "probe"], order
    assert enc._encoder is not None
    for i in range(4, 8):
        src.push(core.Buffer(frames[i], pts=i * core.MSECOND, offset=i))
    src.end_of_stream()
    got = []
    while (b := sink.try_pull_buffer(timeout=10)) is not None:
        got.append(b)
    p.stop()
    assert [b.pts for b in got] == [i * core.MSECOND for i in range(8)]
    assert all(np.array_equal(b.data, frames[i])
               for i, b in enumerate(got[:4]))
    assert [bytes(b.data) for b in got[4:]] == \
        JpegEncoder(85, device="cpu").encode_gop(frames[4:])
