"""The 95th percentile over every chunk of the window of the ms from the
call that dispatches it to the return of its finalize."""

from benchlib import readers


def read(run):
    return readers.chunk_p95_ms(run)
