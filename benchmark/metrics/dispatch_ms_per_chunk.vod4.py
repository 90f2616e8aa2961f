"""dispatch_ms_per_chunk.stream's reading in the four-card VOD cell: host
ms of the dispatch call per chunk, which enqueues every card's block in
turn from the one host thread."""

from benchlib import readers


def read(run):
    return readers.span_ms_per_chunk(run, "dispatch")
