"""Share of the traced window in which no kernel or copy ran on the card,
%."""

from benchlib import readers


def read(run):
    return readers.idle_share_pct(run)
