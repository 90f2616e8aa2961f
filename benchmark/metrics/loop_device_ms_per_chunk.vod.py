"""Device ms per chunk of the chunk loop without the search: the union of
every other kernel's and copy's traced intervals."""

from benchlib import readers


def read(run):
    return readers.loop_device_ms_per_chunk(run)
