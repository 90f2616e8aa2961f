"""Device operations (kernels, copies, sets) in the traced window per
chunk."""

from benchlib import readers


def read(run):
    return readers.launches_per_chunk(run)
