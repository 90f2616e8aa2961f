"""The port's hype elements against flutpu's: the copies (events,
scenedetector, outputselector, scenecollector, the ``hype`` bin) hold
the same code, the scenarios of tests/test_hype_order.py give the same
output order and pts through both packages' cores, and ``cudahype``
(the port's ``tpuhype``) encodes C GOP chunks in one dispatch: JPEG
byte-identical to flutpu's ``tpuhype`` and to a plain ``JpegEncoder``,
FVC chunks byte-identical to the port's per-chunk ``FvcEncoder``. All on
the CPU (``device=cpu``: the kernels' plain versions), at small sizes."""

import importlib
import time

import numpy as np
import pytest
import torch

import flutpu.core
import flutpu.hype.events as j_events
import flutpu_torch.core
import flutpu_torch.hype.events as t_events
from flutpu.hype import (hypebin as j_hypebin,
                         outputselector as j_outputselector,
                         scenecollector as j_scenecollector,
                         scenedetector as j_scenedetector)
from flutpu_torch.codec.fvc import FvcEncoder
from flutpu_torch.codec.jpeg import JpegEncoder
from flutpu_torch.core.elements import make_test_frame
from flutpu_torch.hype import (cuda as t_cuda, hypebin as t_hypebin,
                               outputselector as t_outputselector,
                               scenecollector as t_scenecollector,
                               scenedetector as t_scenedetector)
from torch_helpers import code_of, pull_all, tie_contract

torch.set_num_threads(1)

CORES = [pytest.param((flutpu.core, j_events), id="flutpu"),
         pytest.param((flutpu_torch.core, t_events), id="port")]
CAPS = "video/x-raw, format=RGB, width=1, height=1, framerate=30/1"
MS = flutpu_torch.core.MSECOND


@pytest.mark.parametrize("port,orig", [
    (t_events, j_events), (t_scenedetector, j_scenedetector),
    (t_outputselector, j_outputselector),
    (t_scenecollector, j_scenecollector), (t_hypebin, j_hypebin)],
    ids=["events", "scenedetector", "outputselector", "scenecollector",
         "hypebin"])
def test_copies_hold_the_same_code(port, orig):
    """Statement for statement flutpu's module: its relative imports
    (``..core``, ``..codec.base``) reach the port's core and the port's
    VideoEncoder."""
    assert code_of(port) == code_of(orig)


def test_hype_bin_checks_the_ports_encoder_class():
    from flutpu_torch.codec.base import VideoEncoder
    from flutpu_torch.codec.encoder import CudaJpegEnc
    assert t_hypebin._is_video_encoder(CudaJpegEnc(device="cpu"))
    assert issubclass(t_cuda.CudaHype, VideoEncoder)
    with pytest.raises(ValueError):
        flutpu_torch.core.make("hype").set_property("encoder-0",
                                                    "videotestsrc")


def test_registry_loads_the_hype_and_inject_elements():
    names = set(flutpu_torch.core.factories())
    assert {"hype", "scenedetector", "outputselector", "scenecollector",
            "cudahype", "injectbin"} <= names
    assert "tpuhype" not in names


# -- the ordering scenarios, on both cores -------------------------------------

def run_order(core, pipeline, num_buffers=20):
    """tests/test_hype_order.py's run_order_test on ``core``: the output
    pts in order of arrival."""
    h = core.Harness.new_parse(pipeline)
    h.set_src_caps(CAPS)
    h.set_sink_caps(CAPS)
    for i in range(num_buffers):
        assert h.push(core.Buffer(bytes(27), pts=i * MS, duration=MS,
                                  offset=i)).value == "ok"
    assert h.push_eos()
    out = [h.pull(timeout=30).pts for _ in range(num_buffers)]
    h.teardown()
    return out


ORDER_CASES = {
    "one identity": "scenedetector gop-size=2 ! outputselector name=os "
                    "! identity ! scenecollector name=col",
    "two branches": "scenedetector gop-size=2 ! outputselector name=os "
                    "os.src_0 ! identity ! col. os.src_1 ! identity ! col. "
                    "scenecollector name=col",
    "sleep skew": "scenedetector gop-size=5 ! outputselector name=os "
                  "os.src_0 ! identity sleep-time=10000 silent=false ! col. "
                  "os.src_1 ! identity sleep-time=100 silent=false ! col. "
                  "scenecollector name=col",
    "hype one encoder": "hype gop-size=5 encoder-1=identity",
    "hype three encoders skewed": "hype gop-size=3 "
                                  "encoder-1='identity sleep-time=5000' "
                                  "encoder-2='identity sleep-time=50' "
                                  "encoder-3='identity sleep-time=500'"}


@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_order_scenarios_equal_flutpus(case):
    """Input pts order out, through any scatter/encode/gather topology and
    under branch latency skew, on the port's core as on flutpu's."""
    want = [i * MS for i in range(20)]
    for core in (flutpu.core, flutpu_torch.core):
        assert run_order(core, ORDER_CASES[case]) == want


def _branch_probe(core, events, p, seen, fku):
    """Record scene events per collector pad and ForceKeyUnits on i0."""
    col = p.get_by_name("col")
    for idx in (0, 1):
        pad = col.get_pad(f"sink_{idx}")
        orig = pad.event_function

        def wrap(pad_, ev, _idx=idx, _orig=orig):
            s = events.SceneNewEvent.parse(ev)
            if s is not None:
                seen[_idx].append(s.gop_index)
            return _orig(pad_, ev)
        pad.event_function = wrap
    i0 = p.get_by_name("i0")
    orig0 = i0.sinkpad.event_function or importlib.import_module(
        core.__name__ + ".pad")._forward_event

    def wrap0(pad_, ev):
        if ev.name == "GstForceKeyUnit":
            fku.append(ev.name)
        return orig0(pad_, ev)
    i0.sinkpad.event_function = wrap0


@pytest.mark.parametrize("pkg", CORES)
def test_scene_events_and_forced_keyframes(pkg):
    """Scene events land only on the branch owning the chunk
    (round-robin), and a branch gets a ForceKeyUnit before a chunk."""
    core, events = pkg
    p = core.parse_launch(
        "scenedetector gop-size=2 ! outputselector name=os "
        "os.src_0 ! identity name=i0 ! col. "
        "os.src_1 ! identity name=i1 ! col. "
        "scenecollector name=col")
    seen, fku = {0: [], 1: []}, []
    _branch_probe(core, events, p, seen, fku)
    h = core.Harness(p)
    h.set_src_caps(CAPS)
    for i in range(8):
        h.push(core.Buffer(bytes(3), pts=i * MS, duration=MS, offset=i))
    h.push_eos()
    assert [h.pull(timeout=10).pts for _ in range(8)] == \
        [i * MS for i in range(8)]
    h.teardown()
    assert seen == {0: [0, 2], 1: [1, 3]}
    assert len(fku) >= 1


@pytest.mark.parametrize("pkg", CORES)
def test_dead_branch_timeout_skips_scene(pkg):
    core, events = pkg
    col = core.make("scenecollector")
    col.set_property("branch-timeout-ms", 150)
    p0, p1 = col.request_pad("sink_%u"), col.request_pad("sink_%u")
    out = []
    sink = core.Pad("t", core.PadDirection.SINK)
    sink.chain_function = lambda pad, b: (out.append(b.pts),
                                          core.FlowReturn.OK)[1]
    col.srcpad.link(sink)
    p0.send_event(events.SceneNewEvent(0, 4))   # its buffers never arrive
    p1.send_event(events.SceneNewEvent(1, 4))
    for i in range(4):
        p1.chain(core.Buffer(bytes(1), pts=(4 + i) * MS))
    p1.send_event(events.SceneNewEvent(3, 4))
    assert out == []
    time.sleep(0.2)
    p1.chain(core.Buffer(bytes(1), pts=12 * MS))
    assert out == [(4 + i) * MS for i in range(4)]


@pytest.mark.parametrize("pkg", CORES)
def test_adaptive_scene_detection(pkg):
    core, events = pkg
    det = core.make("scenedetector")
    det.set_property("gop-size", 100)
    det.set_property("scene-threshold", 10.0)
    seen = []
    sink = core.Pad("t", core.PadDirection.SINK)
    sink.chain_function = lambda p, b: core.FlowReturn.OK

    def ev(p, e):
        s = events.SceneNewEvent.parse(e)
        if s is not None:
            seen.append(s.gop_index)
        return True
    sink.event_function = ev
    det.srcpad.link(sink)
    dark = np.zeros((64, 64, 3), np.uint8)
    bright = np.full((64, 64, 3), 200, np.uint8)
    for i, f in enumerate([dark] * 5 + [bright] * 5 + [dark] * 5):
        det.sinkpad.chain(core.Buffer(f, offset=i))
    assert seen == [0, 1, 2]


def test_incompatible_encoders_fail_the_state_change():
    from flutpu_torch.codec.base import VideoEncoder
    core = flutpu_torch.core

    class EncA(VideoEncoder):
        FACTORY = "porttestenc-a"
        SRC_CAPS = "video/x-codec-a"

        def encode_frame(self, buf, keyframe):
            return buf

    class EncB(EncA):
        FACTORY = "porttestenc-b"
        SRC_CAPS = "video/x-codec-b"

    hype = core.make("hype")
    hype.set_property("encoder-0", EncA())
    hype.set_property("encoder-1", EncB())
    assert hype.set_state(core.State.PLAYING).name == "FAILURE"


# -- encoders in a hype on the port's core --------------------------------------

@pytest.mark.parametrize("enc", ["cudajpegenc", "cudafvcenc motion=true"])
def test_hype_with_two_port_encoders_on_the_cpu(enc):
    """Two port encoder branches, each on its own streaming thread: every
    frame (JPEG) or chunk (FVC, 3 frames per scene) in order, each
    byte-identical to one plain encode of the same frames."""
    bufs = pull_all(flutpu_torch.core.parse_launch, (
        "videotestsrc num-buffers=14 pattern=ball width=48 height=32 "
        f"! hype gop-size=3 encoder-0='{enc} device=cpu' "
        f"encoder-1='{enc} device=cpu' ! appsink name=out"))
    frames = np.stack([make_test_frame("ball", 48, 32, i) for i in range(14)])
    assert [b.pts for b in bufs] == sorted(b.pts for b in bufs)
    if enc == "cudajpegenc":
        want = JpegEncoder(85, device="cpu").encode_gop(frames)
    else:
        fvc = FvcEncoder(85, motion=True, device="cpu")
        want = [fvc.encode_chunk(frames[i:i + 3]) for i in range(0, 14, 3)]
    assert [bytes(b.data) for b in bufs] == want


# -- cudahype ----------------------------------------------------------------

def _push_frames(core, desc, frames, caps=None):
    h = core.Harness(desc)
    ht, wd = frames[0].shape[:2]
    h.set_src_caps(caps or f"video/x-raw, format=RGB, width={wd}, "
                   f"height={ht}, framerate=30/1")
    for i, f in enumerate(frames):
        h.push(core.Buffer(f, pts=i * MS, duration=MS, offset=i))
    h.push_eos()
    out = []
    while (o := h.pull(timeout=30)) is not None:
        out.append(o)
    h.teardown()
    return out


def test_cudahype_jpeg_equals_flutpus_tpuhype():
    """``cudahype device=cpu codec=jpeg`` and flutpu's ``tpuhype`` (4
    chunks of 2 frames per dispatch; 10 frames: a truncated second
    batch): byte-identical JFIF, in order, with the same pts."""
    frames = [make_test_frame("gradient", 64, 48, i) for i in range(10)]
    want = _push_frames(flutpu.core, "tpuhype gop-size=2 chunks=4 quality=90",
                        frames)
    got = _push_frames(flutpu_torch.core, "cudahype gop-size=2 chunks=4 "
                       "quality=90 device=cpu", frames)
    assert [o.pts for o in got] == [o.pts for o in want] == \
        [i * MS for i in range(10)]
    assert [bytes(o.data) for o in got] == [bytes(o.data) for o in want]
    assert [bytes(o.data) for o in got] == \
        JpegEncoder(90, device="cpu").encode_gop(np.stack(frames))


def _unlike_clip(n, w=48, h=32):
    """Frames of unlike chunks: a static stretch, a ball, then a scene
    cut to noise."""
    still = make_test_frame("gradient", w, h, 0)
    return [still if i < 4 else make_test_frame(
        "ball" if i < 7 else "noise", w, h, i) for i in range(n)]


@pytest.mark.parametrize("props,kw", [
    ("codec=fvc", dict(motion=False)),
    ("codec=fvc-motion", dict(motion=True)),
    ("codec=fvc-motion search=hier", dict(motion=True, hier=True)),
    ("codec=fvc-motion bframes=1", dict(motion=True, bframes=1)),
    ("codec=fvc-motion search=hier bframes=1",
     dict(motion=True, hier=True, bframes=1, segmented=False)),
    ("codec=fvc-motion subpel=true", dict(motion=True, subpel=True)),
    ("codec=fvc-motion search=hier subpel=true",
     dict(motion=True, hier=True, subpel=True))],
    ids=["fvc", "full", "hier", "full-B", "hier-B-blocks", "subpel",
         "hier-subpel"])
def test_cudahype_fvc_equals_per_chunk_encodes(props, kw, monkeypatch):
    """C = 3 chunks of 4 frames per dispatch, 14 frames (a static chunk,
    a chunk with a scene cut, and a truncated last batch: with B frames
    its 2-frame chunk is re-encoded with its own structure): every chunk
    byte-identical to the port's per-chunk ``FvcEncoder`` of the same
    frames, pushed in chunk order with flutpu's pts and duration. The
    last case runs the non-segment layout (``FLUTPU_SEGMENTED=0``)."""
    if kw.get("segmented") is False:
        monkeypatch.setenv("FLUTPU_SEGMENTED", "0")
    frames = _unlike_clip(14)
    got = _push_frames(flutpu_torch.core, f"cudahype gop-size=4 chunks=3 "
                       f"device=cpu {props}", frames)
    enc = FvcEncoder(85, device="cpu", **kw)
    want = [enc.encode_chunk(np.stack(frames[i:i + 4]))
            for i in range(0, 14, 4)]
    assert [bytes(o.data) for o in got] == want
    assert [o.pts for o in got] == [i * MS for i in range(0, 14, 4)]
    assert [o.duration for o in got] == [4 * MS, 4 * MS, 4 * MS, 2 * MS]
    assert all(o.data[:4] == b"FVC1" for o in got)


def test_cudahype_raises_on_what_is_not_ported():
    """flutpu's refusals: the hier search or half-pel with stripes
    (``tpu.py``'s ValueError, at the first flush), half-pel with B
    frames, an unknown codec, fewer than one stripe."""
    core = flutpu_torch.core
    frames = [make_test_frame("ball", 48, 32, i) for i in range(2)]
    for props in ("search=hier", "subpel=true"):
        with pytest.raises(ValueError, match="full-search integer-pel"):
            core.parse_launch(
                f"cudahype codec=fvc-motion spatial=2 {props} device=cpu "
                "name=h ! fakesink").get_by_name("h")._fvc()
    assert core.make("cudahype", spatial=2, device="cpu").mesh().shape == \
        (1, 2)
    # flutpu reads spatial as max(1, spatial)
    assert core.make("cudahype", spatial=0, device="cpu").mesh().shape == \
        (1, 1)
    el = core.parse_launch("cudahype codec=fvc-motion subpel=true device=cpu "
                           "name=h ! fakesink").get_by_name("h")
    assert el._fvc().subpel is True
    el.set_property("bframes", 1)
    with pytest.raises(ValueError, match="subpel"):
        el._fvc()
    with pytest.raises(ValueError):
        core.make("cudahype", codec="h264")
    el = core.make("cudahype", device="cpu")
    assert el.n_chunks == 1 and el.get_property("device") == "cpu"
    assert core.make("cudahype").get_property("device") == "cuda"
    assert core.make("cudahype", codec="fvc").srcpad.template_caps \
        .media_type == "video/x-fvc"


# -- cudahype over several shards and row stripes ----------------------------

def _striped_pair(props, frames, n_chunks=2):
    """The same frames through flutpu's ``tpuhype chunks=2 spatial=2`` (a
    2 x 2 mesh of CPU devices) and the port's ``cudahype device=cpu
    spatial=2`` (one shard, two stripes on the CPU)."""
    want = _push_frames(flutpu.core, f"tpuhype chunks={n_chunks} spatial=2 "
                        f"{props}", frames)
    got = _push_frames(flutpu_torch.core, f"cudahype chunks={n_chunks} "
                       f"spatial=2 device=cpu {props}", frames)
    return want, got


def test_striped_cudahype_jpeg_equals_tpuhype_and_unstriped():
    """h = 80 (``test_parallel.py``'s crop case): two stripes pad the
    frames to 96 rows, the coefficient planes are cropped back to the
    80 standard MCU rows before the pack: byte-identical to flutpu's
    striped ``tpuhype`` and to the port's unstriped ``cudahype``."""
    frames = [make_test_frame("gradient", 64, 80, i) for i in range(4)]
    want, got = _striped_pair("gop-size=2 quality=90", frames)
    flat = _push_frames(flutpu_torch.core, "cudahype gop-size=2 chunks=2 "
                        "quality=90 device=cpu", frames)
    assert [bytes(o.data) for o in got] == [bytes(o.data) for o in want] \
        == [bytes(o.data) for o in flat]
    assert [o.pts for o in got] == [o.pts for o in want]


def _v1_coefficients(data: bytes):
    """A version-1 chunk → its frames' absolute (y, cb, cr) coefficients
    (the decoded residuals accumulated) and its header."""
    from flutpu_torch.codec.decode import decode_scan_to_coefs
    from flutpu_torch.codec.fvc import FvcDecoder
    hdr, frames = FvcDecoder.parse_chunk(data)
    ph, pw = hdr["coded_height"], hdr["coded_width"]
    scans = [decode_scan_to_coefs(p, pw // 8, ph // 8, pw // 16, ph // 16,
                                  True) for _, _, p in frames]
    return hdr, [np.cumsum(np.stack([s[k] for s in scans]).astype(np.int64),
                           axis=0) for k in range(3)]


@pytest.mark.parametrize("props", [
    "codec=fvc", "codec=fvc-motion search-range=3",
    "codec=fvc-motion search-range=3 bframes=1"],
    ids=["fvc", "fvc-motion", "fvc-motion-B"])
def test_striped_cudahype_fvc_equals_tpuhype(props):
    """``cudahype spatial=2`` on 64 x 80 frames (padded to 96 rows: FVC
    header flags bit 4 and the coded size (64, 96)) = flutpu's striped
    ``tpuhype``, chunk for chunk, with the same pts and durations; 10
    frames in chunks of 4, so the last chunk is cut short (with B frames
    re-encoded unstriped, as flutpu does). Motion chunks are
    byte-identical; version 1 codes K1's coefficients, which may move by
    ±1 at a rounding tie (the front end's contract: here 1 luma
    coefficient of 24,576 in two chunks, ROADMAP queue 3)."""
    from flutpu_torch.codec.fvc import FvcDecoder
    frames = [make_test_frame("ball", 64, 80, i) for i in range(10)]
    want, got = _striped_pair(f"gop-size=4 {props}", frames)
    assert [(o.pts, o.duration) for o in got] == \
        [(o.pts, o.duration) for o in want]
    for a, b in zip(got, want):
        a, b = bytes(a.data), bytes(b.data)
        if "motion" in props:
            assert a == b
            continue
        (ha, ca), (hb, cb) = _v1_coefficients(a), _v1_coefficients(b)
        assert ha == hb
        for x, y in zip(ca, cb):
            tie_contract(x, y, 1e-4)
    hdr, _ = FvcDecoder.parse_chunk(bytes(got[0].data))
    assert hdr["flags"] & 16
    assert (hdr["coded_height"], hdr["coded_width"]) == (96, 64)


@pytest.mark.parametrize("cards,spatial", [(2, 1), (4, 2), (4, 1)])
def test_cudahype_over_visible_cards(monkeypatch, cards, spatial):
    """``device=cuda`` deals its mesh round the visible cards (two and
    four "cpu" devices stand in): M chunk shards x ``spatial`` stripes,
    one dispatch per shard; the output equals one shard on the CPU, for
    JPEG and FVC with motion."""
    monkeypatch.setattr(t_cuda, "visible_devices",
                        lambda: (torch.device("cpu"),) * cards)
    frames = _unlike_clip(16)
    for props in ("codec=jpeg", "codec=fvc-motion bframes=1"):
        desc = f"cudahype gop-size=4 chunks=4 spatial={spatial} {props}"
        el = flutpu_torch.core.make("cudahype", chunks=4, spatial=spatial)
        assert el.mesh().shape == (cards // spatial, spatial)
        got = _push_frames(flutpu_torch.core, desc, frames)
        one = _push_frames(flutpu_torch.core, f"cudahype gop-size=4 "
                           f"chunks=4 device=cpu {props}", frames)
        assert [bytes(o.data) for o in got] == [bytes(o.data) for o in one]
