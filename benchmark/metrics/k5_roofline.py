"""K5's (the hierarchical search's) share of its roofline, %: the
benchmark's count over the traced kernel time."""

from benchlib import readers


def read(run):
    return readers.search_roofline_pct(run, "k5")
