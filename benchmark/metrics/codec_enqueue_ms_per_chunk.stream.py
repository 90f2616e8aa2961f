"""codec_enqueue_ms_per_chunk.vod's reading in the one-chunk (stream)
cells."""

from benchlib import program


def read(run):
    return program.codec_enqueue_ms_per_chunk(run)
