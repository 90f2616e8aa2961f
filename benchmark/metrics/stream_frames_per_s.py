"""vod_frames_per_s's count in the one-chunk (stream) cells."""

from benchlib import readers


def read(run):
    return readers.frames_per_s(run)
