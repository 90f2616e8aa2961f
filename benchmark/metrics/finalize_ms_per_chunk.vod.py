"""finalize_ms_per_chunk.stream's reading in the batched (VOD) cells, per
chunk of a dispatch."""

from benchlib import readers


def read(run):
    return readers.span_ms_per_chunk(run, "finalize")
