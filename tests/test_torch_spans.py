"""The program's spans (``core/log.py:trace_span``) in the FVC encoder's
dispatch and finalize on the CPU: which spans an encode records under
torch's profiler, in what order and nesting, that the chunks' bytes are
the same with the profiler on and off, and that with no profiler
recording no span opens. The card's half (the spans and the kernels on
one clock) is in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from flutpu_torch.codec.fvc import FvcEncoder
from flutpu_torch.core import log
from flutpu_torch.core.elements import make_test_frame
from torch_helpers import capped_prefix, profiled_spans

torch.set_num_threads(1)

FRAMES = np.stack([make_test_frame("ball", 160, 96, i) for i in range(8)])
#: the clip at another frame size (another block count)
OTHER = np.stack([make_test_frame("ball", 96, 64, i) for i in range(8)])
DISPATCH = ["fvc.codec", "jpeg.pack", "jpeg.copy"]
FINALIZE = ["jpeg.compact", "fvc.vectors", "fvc.container"]
#: adaptive sizes below what the clip needs: the first dispatch overflows
SMALL = {"prefix_window": {"prefix_window": 16},
         "seg_words": {"seg_words": 2}}
#: a prefix cap (words a frame) below the I frames' usage at both sizes
CAP = 64

ENTRIES = {
    "chunk": lambda enc: [enc.encode_chunk(FRAMES)],
    "chunks": lambda enc: enc.encode_chunks_finalize(
        enc.encode_chunks_dispatch(np.stack([FRAMES, FRAMES[::-1]]))),
}


def _encoder(**state):
    enc = FvcEncoder(85, motion=True, device="cpu")
    if not state:
        return enc
    sc = enc.scans
    return FvcEncoder.from_numpy_state(sc.qy, sc.qc, enc.search_range,
                                       motion=True, device="cpu", **state)


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_dispatch_and_its_finalize_record_their_phases(entry):
    """At adapted sizes: one span per phase, in order, none inside
    another."""
    enc = _encoder()
    ENTRIES[entry](enc)   # the sizes adapt to the clip
    _, spans = profiled_spans(lambda: ENTRIES[entry](enc))
    assert [s[0] for s in spans] == DISPATCH + ["jpeg.fetch_wait"] + FINALIZE
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


@pytest.mark.parametrize("small", SMALL)
def test_an_overflow_records_one_redispatch(small):
    """The redispatch holds its own codec, pack and copy (not the second
    wait), and finalize waits twice."""
    _, spans = profiled_spans(lambda: ENTRIES["chunk"](_encoder(**SMALL[small])))
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
    traced, spans = profiled_spans(lambda: ENTRIES[entry](_encoder(**state)))
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



def _redispatches(spans) -> int:
    return [s[0] for s in spans].count("jpeg.redispatch")


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_dispatch_starts_at_the_learned_window(monkeypatch, entry):
    """With the cap below the clip's usage only the first dispatch
    overflows: the next starts at the window learned from it, above the
    cap, and codes once, with the bytes of an encoder whose cap never
    binds."""
    enc = _encoder()
    starts = capped_prefix(monkeypatch, enc.scans, CAP)
    first, spans = profiled_spans(lambda: ENTRIES[entry](enc))
    assert _redispatches(spans) == 1
    again, spans = profiled_spans(lambda: ENTRIES[entry](enc))
    assert [s[0] for s in spans] == DISPATCH + ["jpeg.fetch_wait"] + FINALIZE
    assert starts[0] == CAP < starts[1]
    assert first == again == ENTRIES[entry](_encoder())


def test_another_frame_size_starts_at_the_cap(monkeypatch):
    """A window learned above the cap at one frame size is not carried to
    another: its first dispatch starts at the cap and overflows once, the
    next at that size starts at the window learned there, and both give
    a fresh encoder's bytes."""
    enc = _encoder()
    starts = capped_prefix(monkeypatch, enc.scans, CAP)
    enc.encode_chunk(FRAMES)
    enc.encode_chunk(FRAMES)
    assert starts[1] > CAP
    other, spans = profiled_spans(lambda: enc.encode_chunk(OTHER))
    assert _redispatches(spans) == 1 and starts[2] == CAP
    again, spans = profiled_spans(lambda: enc.encode_chunk(OTHER))
    assert _redispatches(spans) == 0 and starts[3] > CAP
    assert other == again == _encoder().encode_chunk(OTHER)
