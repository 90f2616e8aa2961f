"""How many cards work at once: the sum of each card's busy time (the
union of its kernels' and copies' traced intervals) over the time in
which at least one card is busy, inside the window; 1 to the cell's
cards."""

from benchlib import readers


def read(run):
    return readers.cards_busy_at_once(run)
