"""Frames of every chunk finalized in the window over the window (the first
dispatch call to the last finalize's return)."""

from benchlib import readers


def read(run):
    return readers.frames_per_s(run)
