"""Host ms of the dispatch call (FvcEncoder._dispatch and the codec's
enqueue) per chunk."""

from benchlib import readers


def read(run):
    return readers.span_ms_per_chunk(run, "dispatch")
