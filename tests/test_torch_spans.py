"""The program's spans (``core/log.py:trace_span``) in the FVC encoder's
dispatch and finalize on the CPU: which spans an encode records under
torch's profiler, in what order and nesting, that the chunks' bytes are
the same with the profiler on and off, and that with no profiler
recording no span opens. The card's half (the spans and the kernels on
one clock) is in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flutpu_torch.codec.fvc import FvcEncoder
from flutpu_torch.core import log
from flutpu_torch.core.elements import make_test_frame

torch.set_num_threads(1)

FRAMES = np.stack([make_test_frame("ball", 160, 96, i) for i in range(8)])
DISPATCH = ["fvc.codec", "jpeg.pack", "jpeg.copy"]
FINALIZE = ["jpeg.compact", "fvc.vectors", "fvc.container"]
#: adaptive sizes below what the clip needs: the first dispatch overflows
SMALL = {"prefix_window": {"prefix_window": 16},
         "seg_words": {"seg_words": 2}}

ENTRIES = {
    "chunk": lambda enc: [enc.encode_chunk(FRAMES)],
    "chunks": lambda enc: enc.encode_chunks_finalize(
        enc.encode_chunks_dispatch(np.stack([FRAMES, FRAMES[::-1]]))),
}


def _encoder(**state):
    enc = FvcEncoder(85, motion=True, device="cpu")
    if not state:
        return enc
    sc = enc._scan_coder
    return FvcEncoder.from_numpy_state(sc.qy, sc.qc, enc.search_range,
                                       motion=True, device="cpu", **state)


def _profiled(fn):
    """``fn()`` under a CPU profiler → (its result, [(span name less the
    prefix, start ns, end ns)] by start, an enclosing span first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name()[len(log.SPAN_PREFIX):], e.start_ns(),
                     e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(log.SPAN_PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_dispatch_and_its_finalize_record_their_phases(entry):
    """At adapted sizes: one span per phase, in order, none inside
    another."""
    enc = _encoder()
    ENTRIES[entry](enc)   # the sizes adapt to the clip
    _, spans = _profiled(lambda: ENTRIES[entry](enc))
    assert [s[0] for s in spans] == DISPATCH + ["jpeg.fetch_wait"] + FINALIZE
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


@pytest.mark.parametrize("small", SMALL)
def test_an_overflow_records_one_redispatch(small):
    """The redispatch holds its own codec, pack and copy (not the second
    wait), and finalize waits twice."""
    _, spans = _profiled(lambda: ENTRIES["chunk"](_encoder(**SMALL[small])))
    wait = ["jpeg.fetch_wait"]
    assert [s[0] for s in spans] == (DISPATCH + wait + ["jpeg.redispatch"]
                                     + DISPATCH + wait + FINALIZE)
    _, lo, hi = spans[4]
    inside = [s[0] for s in spans if lo <= s[1] and s[2] <= hi]
    assert inside == ["jpeg.redispatch"] + DISPATCH


@pytest.mark.parametrize("small", [None, *SMALL])
@pytest.mark.parametrize("entry", ENTRIES)
def test_chunk_bytes_alike_with_the_profiler_on_and_off(entry, small):
    state = SMALL.get(small, {})
    traced, spans = _profiled(lambda: ENTRIES[entry](_encoder(**state)))
    assert spans
    assert traced == ENTRIES[entry](_encoder(**state))


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_span_opens_without_a_profiler(monkeypatch, entry):
    """A dispatch, its overflow redispatch and its finalize enter no
    record function while no profiler records."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span opened with no profiler recording")
    monkeypatch.setattr(log, "_record", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert ENTRIES[entry](_encoder(**SMALL["prefix_window"]))

