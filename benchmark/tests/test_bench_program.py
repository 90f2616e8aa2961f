"""The program's spans in a traced run (``benchlib/program.py``,
``trace.profiled``, ``program_spans.py``): each reduction on hand-made
spans, the collector on hand-made events and around an encode on the
CPU, tiny traced runs on the CPU and the span metrics they read, and on
the card the harness's own device record holding no program span."""

from types import SimpleNamespace

import pytest

import program_spans
from bench_helpers import CELLS, tiny_manifest
from benchlib import program, trace
from benchlib.runner import Run, run_cell

MS = 1_000_000
#: a window of 100 ms holding two dispatches of two chunks: the first
#: overflows and is redispatched, the second is not; one program span
#: before the window and one after it, which no reduction reads
PROGRAM = [
    ("fvc.codec", -9 * MS, -8 * MS),
    ("fvc.codec", 1 * MS, 5 * MS), ("jpeg.pack", 5 * MS, 6 * MS),
    ("jpeg.copy", 6 * MS, 7 * MS),
    ("fvc.codec", 10 * MS, 14 * MS), ("jpeg.pack", 14 * MS, 15 * MS),
    ("jpeg.copy", 15 * MS, 16 * MS),
    ("jpeg.fetch_wait", 30 * MS, 32 * MS),
    ("jpeg.redispatch", 32 * MS, 38 * MS),
    ("fvc.codec", 32 * MS, 36 * MS), ("jpeg.pack", 36 * MS, 37 * MS),
    ("jpeg.copy", 37 * MS, 38 * MS),
    ("jpeg.fetch_wait", 38 * MS, 50 * MS),
    ("jpeg.compact", 50 * MS, 53 * MS), ("fvc.vectors", 53 * MS, 54 * MS),
    ("fvc.container", 54 * MS, 56 * MS),
    ("jpeg.fetch_wait", 60 * MS, 61 * MS),
    ("jpeg.compact", 61 * MS, 64 * MS), ("fvc.vectors", 64 * MS, 65 * MS),
    ("fvc.container", 65 * MS, 67 * MS),
    ("jpeg.fetch_wait", 101 * MS, 102 * MS),
]
BENCH = [("window", 0, 100 * MS),
         ("dispatch", 0, 8 * MS), ("dispatch", 9 * MS, 17 * MS),
         ("finalize", 30 * MS, 57 * MS), ("finalize", 60 * MS, 68 * MS)]
#: busy 0-2, 20-40 and 55-99 ms; idle 2-20 (the first dispatch from its
#: codec on, the second whole), 40-55 (the second wait, then finalize's
#: host work) and 99-100 (no span)
DEVICE = [("k", 0, 2 * MS, 0), ("k", 20 * MS, 40 * MS, 0),
          ("k", 55 * MS, 99 * MS, 0)]


def _run(spans=PROGRAM, traced=True):
    run = Run({"name": "c"}, {}, {}, 2)
    run.records = {"dispatches": [{}, {}], "chunks": 4}
    if traced:
        run.trace = {"device": DEVICE, "spans": BENCH, "other": {}}
        if spans is not None:
            run.trace["program"] = spans
        run.window_ns = (0, 100 * MS)
    return run


def test_reductions_on_hand_made_spans():
    run = _run()
    assert program.redispatches_per_dispatch(run) == 0.5
    assert program.fetch_wait_ms_per_chunk(run) == 15 / 4
    assert program.redispatch_ms_per_chunk(run) == 6 / 4
    assert program.finalize_host_ms_per_chunk(run) == 12 / 4
    assert program.codec_enqueue_ms_per_chunk(run) == 8 / 4
    assert program.ms_per_dispatch(run) == {
        "fvc.codec": 4.0, "jpeg.pack": 1.0, "jpeg.copy": 1.0,
        "jpeg.fetch_wait": 7.5, "jpeg.redispatch": 3.0,
        "redispatch/fvc.codec": 2.0, "redispatch/jpeg.pack": 0.5,
        "redispatch/jpeg.copy": 0.5, "jpeg.compact": 3.0,
        "fvc.vectors": 1.0, "fvc.container": 2.0}
    assert program.coverage(run) == {"dispatch": 12 / 16,
                                     "finalize": 33 / 35}


def test_idle_by_the_innermost_span_open():
    assert program.idle_by_span(_run()) == {
        "fvc.codec": 7 * MS, "jpeg.pack": 2 * MS, "jpeg.copy": 2 * MS,
        program.OUTSIDE: 8 * MS, "jpeg.fetch_wait": 10 * MS,
        "jpeg.compact": 3 * MS, "fvc.vectors": 1 * MS,
        "fvc.container": 1 * MS}
    # a gap inside the redispatch: its codec, not the redispatch
    run = _run()
    run.trace["device"] = [("k", 0, 33 * MS, 0), ("k", 35 * MS, 100 * MS, 0)]
    assert program.idle_by_span(run) == {"redispatch/fvc.codec": 2 * MS}


def test_a_dispatch_without_a_redispatch_reads_zero():
    run = _run([s for s in PROGRAM if s[1] >= 60 * MS or s[1] < 17 * MS])
    assert program.redispatches_per_dispatch(run) == 0
    assert program.redispatch_ms_per_chunk(run) == 0
    assert program.codec_enqueue_ms_per_chunk(run) == 8 / 4


@pytest.mark.parametrize("spans,traced", [
    (None, True), ([], True), (PROGRAM[:1], True), (PROGRAM, False)],
    ids=["no-key", "none", "outside-the-window", "untraced"])
def test_nothing_to_read_reads_none(spans, traced):
    """A parent's trace (no ``program`` key, or no span in the window)
    and an untraced run."""
    run = _run(spans, traced)
    for name in program_spans.REDUCTIONS + (
            "ms_per_dispatch", "coverage", "idle_by_span"):
        assert getattr(program, name)(run) is None, name


def _event(name, on_card, a, b):
    from torch.autograd import DeviceType
    kind = DeviceType.CUDA if on_card else DeviceType.CPU
    return SimpleNamespace(name=lambda: name, device_type=lambda: kind,
                           start_ns=lambda: a, end_ns=lambda: b,
                           device_index=lambda: 0 if on_card else -1)


def replayed(monkeypatch, events) -> dict:
    """``trace.profiled``'s record of ``events``: a profiler that hands
    them back in its kineto results."""
    import torch.profiler

    class Replay:
        profiler = SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: list(events)))

        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "profile", Replay)
    got = {}
    with trace.profiled(got):
        pass
    return got


def test_collect_keeps_program_spans_off_the_device(monkeypatch):
    """``trace.profiled``, the one collector, on hand-made events."""
    got = replayed(monkeypatch, [
        _event("flu.fvc.codec", False, 1, 5),
        _event("flu.fvc.codec", True, 2, 4),
        _event("bench.dispatch", False, 0, 6),
        _event("bench.dispatch", True, 2, 4), _event("kernel", True, 2, 3),
        _event("Stream Sync", True, 3, 4), _event("aten::add", False, 1, 2)])
    assert got == {"device": [("kernel", 2, 3, 0)],
                   "spans": [("dispatch", 0, 6)],
                   "program": [("fvc.codec", 1, 5)],
                   "other": {"flu.fvc.codec": 1, "bench.dispatch": 1,
                             "Stream Sync": 1}}


def test_profiled_holds_the_programs_spans_on_the_cpu():
    """A small encode on the CPU under ``trace.profiled``: the program's
    ``flu.*`` spans of the dispatch and the finalize, none of them
    counted as device work."""
    import torch
    from flutpu_torch.codec.fvc import FvcEncoder
    frames = torch.randint(0, 256, (3, 32, 48, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    enc = FvcEncoder(85, motion=True, search_range=4, device="cpu")
    got = {}
    with trace.profiled(got):
        enc.encode_chunk(frames)
    names = {n for n, _, _ in got["program"]}
    assert {"fvc.codec", "jpeg.fetch_wait", "fvc.container"} <= names
    assert all(a <= b for _, a, b in got["program"])
    assert not [e for e in got["device"] if e[0].startswith("flu.")]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_on_the_cpu(tmp_path, cell):
    m = tiny_manifest(tmp_path)
    run, correct = program_spans.traced_run(m, cell, 2 ** 31 + 23, 0.3,
                                            "cpu")
    assert correct
    out = program_spans.report(m, run, correct)
    assert out["program"]["redispatches_per_dispatch"] >= 0
    for k in program_spans.REDUCTIONS[1:]:
        assert out["program"][k] >= 0, k
    assert out["program"]["codec_enqueue_ms_per_chunk"] > 0
    for share in out["coverage"].values():
        assert 0 < share <= 1
    assert {"fvc.codec", "jpeg.pack", "jpeg.copy", "jpeg.fetch_wait",
            "jpeg.compact", "fvc.vectors", "fvc.container"} \
        <= set(out["ms_per_dispatch"])


#: the per-layer metrics that read the program's spans
SPAN_METRICS = ("codec_enqueue_ms_per_chunk.vod",
                "codec_enqueue_ms_per_chunk.stream",
                "finalize_host_ms_per_chunk.vod",
                "finalize_host_ms_per_chunk.stream")


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_read_in_every_cell_they_list(tmp_path, cell):
    """A tiny traced run of each cell: every span metric that lists the
    cell reads a number above 0 from ``trace.profiled``'s ``program``."""
    m = tiny_manifest(tmp_path)
    mine = [e["name"] for e in m.metrics(cell, True)
            if e["name"] in SPAN_METRICS]
    assert len(mine) == 2
    r = run_cell(m, cell, 2 ** 31 + 29, 0.3, True, "cpu")
    assert r["correct"] is True
    for name in mine:
        assert r["metrics"][name]["value"] > 0, name
        assert r["metrics"][name]["unit"] == "ms"


@pytest.mark.cuda
def test_the_harness_trace_holds_no_program_span_on_the_card(card):
    """``trace.profiled``, as ``run.py --trace 1`` uses it, around a
    small encode on the card: the program's spans stay off the device's
    record."""
    import torch
    from flutpu_torch.codec.fvc import FvcEncoder
    frames = torch.randint(0, 256, (4, 48, 80, 3), dtype=torch.uint8,
                           device=card)
    enc = FvcEncoder(85, motion=True, search_range=6, device=card)
    enc.encode_chunk(frames)
    got = {}
    with trace.profiled(got):
        enc.encode_chunk(frames)
    assert got["device"]
    assert not [e for e in got["device"] if e[0].startswith("flu.")]
    assert {e[3] for e in got["device"]} == {card.index}
    assert not [n for n in got["other"] if n.startswith("flu.")]
