"""Host ms per chunk of the program's own work in finalize once its copy
is in: compaction, the vectors' zlib and the container (its
``flu.jpeg.compact``, ``flu.fvc.vectors`` and ``flu.fvc.container``
spans in the traced window), in the batched (VOD) cells."""

from benchlib import program


def read(run):
    return program.finalize_host_ms_per_chunk(run)
