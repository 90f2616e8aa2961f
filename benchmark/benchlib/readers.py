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
    end)] ns, or None in an untraced run."""
    if run.trace is None or run.window_ns is None:
        return None
    lo, hi = run.window_ns
    return [(n, max(a, lo), min(b, hi)) for n, a, b in run.trace["device"]
            if b > lo and a < hi]


def _is_search(name: str) -> bool:
    return any(k in name for ks in SEARCH_KERNELS.values() for k in ks)


def launches_per_chunk(run):
    dev = window_device(run)
    if not dev or not run.records["chunks"]:
        return None
    return len(dev) / run.records["chunks"]


def loop_device_ms_per_chunk(run):
    """Device busy ms per chunk with the search kernels left out: the
    union of every other kernel's and copy's intervals."""
    dev = window_device(run)
    if not dev or not run.records["chunks"]:
        return None
    rest = [(a, b) for n, a, b in dev if not _is_search(n)]
    return trace.union_ns(rest) / 1e6 / run.records["chunks"]


def idle_share_pct(run):
    dev = window_device(run)
    if not dev:
        return None
    lo, hi = run.window_ns
    return (1.0 - trace.union_ns([(a, b) for _, a, b in dev])
            / (hi - lo)) * 100.0


def search_roofline_pct(run, kernel: str):
    """The search launches' bound (the benchmark's count at the cell's
    coded size, range and chunks per launch) over their traced time, in
    %; None where the window ran no such launch."""
    dev = window_device(run)
    if not dev:
        return None
    names = SEARCH_KERNELS[kernel]
    spans = [(a, b) for n, a, b in dev if any(k in n for k in names)]
    if not spans:
        return None
    h, w = run.coded
    per_launch = roofline.search_bound_ms(run.config["search"], h, w,
                                          run.config["search_range"],
                                          run.batch)
    return len(spans) * per_launch / (sum(b - a for a, b in spans) / 1e6) \
        * 100.0
