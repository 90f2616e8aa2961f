"""Reductions that the metric readers (``metrics/<metric>.py``) share.
Each returns None where the run holds nothing to read."""

from __future__ import annotations

import numpy as np

from . import roofline, trace

#: profiler names of the search kernels (K3: the full search, K5: the
#: hierarchical one), by substring
SEARCH_KERNELS = {"k3": ("motion_search_mc_kernel",
                         "motion_search_banded_kernel"),
                  "k5": ("motion_search_hier_kernel",
                         "motion_search_hier_wide_kernel")}


def frames_per_s(run):
    return run.records["frames"] / run.window_s


def chunk_p95_ms(run):
    lat = run.records["latency_ns"]
    return float(np.percentile(np.asarray(lat, np.float64), 95)) / 1e6 \
        if lat else None


def span_ms_per_chunk(run, name: str):
    """Mean host ms of span ``name`` per dispatch, over its chunks."""
    recs = [d[name] for d in run.records["dispatches"] if name in d]
    if not recs:
        return None
    return float(np.mean(recs)) / 1e6 / run.batch


def window_device(run):
    """The traced device intervals clipped to the window: [(name, start,
    end, card)] ns, or None in an untraced run."""
    if run.trace is None or run.window_ns is None:
        return None
    lo, hi = run.window_ns
    return [(n, max(a, lo), min(b, hi), c)
            for n, a, b, c in run.trace["device"] if b > lo and a < hi]


def card_busy_ns(run, keep=lambda name: True):
    """Per card of the run (``run.cards``, and any other that the window
    traced), the union of its intervals whose operation ``keep`` takes →
    [ns], or None in an untraced run or one whose window ran nothing."""
    dev = window_device(run)
    if not dev:
        return None
    return [trace.union_ns(iv) for iv in trace.by_card(
        [e for e in dev if keep(e[0])], run.cards).values()]


def _is_search(name: str) -> bool:
    return any(k in name for ks in SEARCH_KERNELS.values() for k in ks)


def launches_per_chunk(run):
    dev = window_device(run)
    if not dev or not run.records["chunks"]:
        return None
    return len(dev) / run.records["chunks"]


def loop_device_ms_per_chunk(run):
    """Device busy ms per chunk with the search kernels left out: each
    card's union of every other kernel's and copy's intervals, summed
    over the cards."""
    busy = card_busy_ns(run, lambda n: not _is_search(n))
    if busy is None or not run.records["chunks"]:
        return None
    return sum(busy) / 1e6 / run.records["chunks"]


def idle_share_pct(run):
    """The mean over the cards of the share of the window in which a card
    ran no kernel or copy, %."""
    busy = card_busy_ns(run)
    if busy is None:
        return None
    lo, hi = run.window_ns
    shares = [(1.0 - b / (hi - lo)) * 100.0 for b in busy]
    return sum(shares) / len(shares)


def cards_busy_at_once(run):
    """The sum of each card's busy time over the time in which at least
    one card is busy, in the window: 1 (the cards take turns) to the
    number of cards (all busy together)."""
    busy = card_busy_ns(run)
    at_all = busy and trace.union_ns([(a, b) for _, a, b, _
                                      in window_device(run)])
    return sum(busy) / at_all if at_all else None


def search_roofline_pct(run, kernel: str):
    """The search launches' bound (the benchmark's count at the cell's
    coded size, range and chunks per launch: a dispatch's C chunks over
    its shards) over their traced time, in %; None where the window ran
    no such launch."""
    dev = window_device(run)
    if not dev:
        return None
    names = SEARCH_KERNELS[kernel]
    spans = [(a, b) for n, a, b, _ in dev if any(k in n for k in names)]
    if not spans:
        return None
    h, w = run.coded
    per_launch = roofline.search_bound_ms(run.config["search"], h, w,
                                          run.config["search_range"],
                                          run.batch // run.shards)
    return len(spans) * per_launch / (sum(b - a for a, b in spans) / 1e6) \
        * 100.0
