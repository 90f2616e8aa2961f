"""Host ms of the finalize call per chunk, its dispatch's device work and
copy already complete: compaction, zlib, the container."""

from benchlib import readers


def read(run):
    return readers.span_ms_per_chunk(run, "finalize")
