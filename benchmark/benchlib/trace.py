"""The traced run: torch.profiler over the window, read into device
intervals, the benchmark's host spans and the program's, and the
reductions the per-layer readers and the breakdown share (interval
union, idle gaps by the host span that was open)."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

#: prefix of the benchmark's own host spans (torch.profiler annotations)
SPAN = "bench."
#: prefix of the program's own host spans (``flutpu_torch/core/log.py``:
#: ``trace_span``)
PROGRAM = "flu."
#: CUDA-typed profiler activities that are no device work: the
#: synchronizations (a host's wait, Kineto's names) and the annotations'
#: shadows on the device (named as the host span)
NOT_WORK = ("Event Sync", "Stream Sync", "Context Sync", "Stream Wait Event",
            "Unknown Sync")


@contextlib.contextmanager
def profiled(out: dict):
    """Trace CPU and CUDA activity in the block; on exit ``out`` holds
    ``device`` [(name, start_ns, end_ns, card)] (kernels, copies, sets;
    ``card`` the CUDA device index),
    ``spans`` [(name, start_ns, end_ns)] of the ``bench.*`` annotations
    and ``program`` [(name, start_ns, end_ns)] of the program's
    ``flu.*`` spans, each name less its prefix, on the profiler's one
    clock, and ``other`` {name: count} of the CUDA-typed activities left
    out (a span of either kind mirrored onto the device among them,
    never device work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    device, spans, program = [], [], []
    other = defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        name, on_card = e.name(), e.device_type() == DeviceType.CUDA
        if on_card and (name.startswith((SPAN, PROGRAM))
                        or name in NOT_WORK):
            other[name] += 1
        elif on_card:
            device.append((name, e.start_ns(), e.end_ns(), e.device_index()))
        elif name.startswith(SPAN):
            spans.append((name[len(SPAN):], e.start_ns(), e.end_ns()))
        elif name.startswith(PROGRAM):
            program.append((name[len(PROGRAM):], e.start_ns(), e.end_ns()))
    out.update(device=device, spans=spans, program=program,
               other=dict(other))


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


def merged(intervals):
    """The union as sorted disjoint (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def by_card(device, cards):
    """Device intervals by card → {card: [(start, end)]}, with an empty
    list for each of ``cards`` that ran nothing."""
    out = {c: [] for c in cards}
    for _, a, b, c in device:
        out.setdefault(c, []).append((a, b))
    return out


def idle_gaps(device, spans, window, cards):
    """Idle time of each card inside ``window`` (start, end), summed over
    the cards (card-ns) by the benchmark's host span open at each gap's
    middle (the host's spans follow one another) → {span name: ns}."""
    lo, hi = window
    inner = sorted((s for s in spans if s[0] != "window"),
                   key=lambda s: s[1])
    starts = [s[1] for s in inner]
    out = defaultdict(int)
    for card in by_card(device, cards).values():
        busy = [(max(a, lo), min(b, hi)) for a, b in card
                if b > lo and a < hi]
        t = lo
        for a, b in merged(busy) + [[hi, hi]]:
            if a > t:
                mid = (t + a) // 2
                k = bisect.bisect_right(starts, mid) - 1
                name = inner[k][0] if k >= 0 and inner[k][2] >= mid \
                    else "no span"
                out[name] += a - t
            t = max(t, b)
    return dict(out)


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.removeprefix("void ")[:120]


def device_ops(device):
    """Device time by operation (short) name, summed over the cards →
    {name: ns}."""
    out = defaultdict(int)
    for name, a, b, _ in device:
        out[short_name(name)] += b - a
    return dict(out)
