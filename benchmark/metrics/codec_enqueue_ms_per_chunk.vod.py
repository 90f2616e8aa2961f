"""Host ms per chunk of the program's enqueue of its chunk loop inside
the dispatch call (its ``flu.fvc.codec`` spans in the traced window, a
redispatch's left out), in the batched (VOD) cells."""

from benchlib import program


def read(run):
    return program.codec_enqueue_ms_per_chunk(run)
