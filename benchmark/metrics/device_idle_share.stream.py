"""device_idle_share.vod's reading in the one-chunk (stream) cells."""

from benchlib import readers


def read(run):
    return readers.idle_share_pct(run)
