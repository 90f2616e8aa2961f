"""The program's own spans in a traced run (``flutpu_torch/core/log.py``:
``flu.*``, recorded by the same profiler as the device's operations, so
on one clock with them; ``trace.profiled`` keeps them), and the
reductions over them: the phases of the FVC encoder's dispatch and
finalize per chunk, redispatches per dispatch, how much of the
benchmark's ``bench.dispatch`` and ``bench.finalize`` the phases account
for, and the device's idle time by the innermost span open. A
reduction reads ``run.trace["program"]`` ([(span name less the prefix,
start ns, end ns)]) in the window and returns None where the run holds
no program span there: an untraced run, or a program that records
none."""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import readers, trace

#: the phases inside the program's dispatch call, and inside its finalize
DISPATCH = ("fvc.codec", "jpeg.pack", "jpeg.copy")
FINALIZE = ("jpeg.fetch_wait", "jpeg.redispatch", "jpeg.compact",
            "fvc.vectors", "fvc.container")
#: finalize's work on the host: compaction, side words, zlib and container
FINALIZE_HOST = ("jpeg.compact", "fvc.vectors", "fvc.container")
REDISPATCH = "jpeg.redispatch"
OUTSIDE = "outside the program"


def window_spans(run):
    """The program's spans that start in the window, by start (an
    enclosing span before the spans it holds), or None."""
    if run.trace is None or run.window_ns is None:
        return None
    lo, hi = run.window_ns
    spans = sorted((s for s in run.trace.get("program", ())
                    if lo <= s[1] < hi), key=lambda s: (s[1], -s[2]))
    return spans or None


def _in_redispatch(spans):
    """Per span, whether a redispatch holds it (a redispatch itself:
    False). A redispatch is a leaf of finalize, so they never nest."""
    outer = [(a, b) for n, a, b in spans if n == REDISPATCH]
    starts = [a for a, _ in outer]
    out = []
    for n, a, b in spans:
        k = bisect.bisect_right(starts, a) - 1
        out.append(n != REDISPATCH and k >= 0 and outer[k][1] >= b)
    return out


def ms_per_chunk(run, names, outside_redispatch: bool = False):
    """Summed host ms of the spans ``names`` in the window per chunk;
    with ``outside_redispatch``, of those no redispatch holds."""
    spans = window_spans(run)
    if spans is None or not run.records["chunks"]:
        return None
    held = _in_redispatch(spans) if outside_redispatch \
        else [False] * len(spans)
    ns = sum(b - a for (n, a, b), h in zip(spans, held)
             if n in names and not h)
    return ns / 1e6 / run.records["chunks"]


def redispatches_per_dispatch(run):
    """Redispatch spans in the window per dispatch finalized there."""
    spans = window_spans(run)
    if spans is None or not run.records["dispatches"]:
        return None
    return sum(n == REDISPATCH for n, _, _ in spans) \
        / len(run.records["dispatches"])


def fetch_wait_ms_per_chunk(run):
    return ms_per_chunk(run, ("jpeg.fetch_wait",))


def redispatch_ms_per_chunk(run):
    """The re-enqueue of the overflowed dispatches (its codec, pack and
    copy), without the wait that follows it."""
    return ms_per_chunk(run, (REDISPATCH,))


def finalize_host_ms_per_chunk(run):
    return ms_per_chunk(run, FINALIZE_HOST)


def codec_enqueue_ms_per_chunk(run):
    """Enqueuing the anchor loop in the dispatch call (a redispatch's
    codec left out)."""
    return ms_per_chunk(run, ("fvc.codec",), outside_redispatch=True)


def _labels(spans):
    """Each span's name, ``redispatch/<phase>`` where a redispatch holds
    it."""
    return ["redispatch/" + n if held else n
            for (n, _, _), held in zip(spans, _in_redispatch(spans))]


def ms_per_dispatch(run):
    """{span: summed host ms per dispatch}; a phase that a redispatch
    holds is named ``redispatch/<phase>``."""
    spans = window_spans(run)
    if spans is None or not run.records["dispatches"]:
        return None
    out = defaultdict(int)
    for (_, a, b), name in zip(spans, _labels(spans)):
        out[name] += b - a
    d = len(run.records["dispatches"])
    return {k: v / 1e6 / d for k, v in out.items()}


def coverage(run):
    """{"dispatch": share, "finalize": share}: the program's phases over
    the benchmark's span around the call, each summed over the window
    (dispatch: codec, pack and copy outside a redispatch; finalize: the
    waits, the redispatches, compaction, side words and container)."""
    spans = window_spans(run)
    if spans is None:
        return None
    lo, hi = run.window_ns
    calls = defaultdict(int)
    for n, a, b in run.trace["spans"]:
        if lo <= a < hi:
            calls[n] += b - a
    held = _in_redispatch(spans)
    phases = defaultdict(int)
    for (n, a, b), h in zip(spans, held):
        if n in DISPATCH and not h:
            phases["dispatch"] += b - a
        elif n in FINALIZE:
            phases["finalize"] += b - a
    return {k: phases[k] / calls[k] if calls[k] else None
            for k in ("dispatch", "finalize")}


def _innermost(spans, labels, lo: int, hi: int):
    """[lo, hi] cut into (start, end, label) pieces by the innermost
    program span open (``OUTSIDE`` where none is); the program's spans
    nest on its one thread."""
    out, stack, t = [], [], lo

    def advance(to):
        nonlocal t
        while stack and stack[-1][1] <= to:
            label, end = stack.pop()
            if end > t:
                out.append((t, end, label))
                t = end
        if to > t:
            out.append((t, to, stack[-1][0] if stack else OUTSIDE))
            t = to

    for (_, a, b), label in zip(spans, labels):
        advance(a)
        stack.append((label, min(b, hi)))
    advance(hi)
    return out


def idle_by_span(run):
    """The device's idle ns in the window (no card busy), each cut by the
    innermost program span open at that time (``OUTSIDE`` where none is;
    a phase that a redispatch holds as ``redispatch/<phase>``) → {name:
    ns}."""
    dev, spans = readers.window_device(run), window_spans(run)
    if not dev or spans is None:
        return None
    lo, hi = run.window_ns
    idle, t = [], lo
    for a, b in trace.merged([(a, b) for _, a, b, _ in dev]) + [[hi, hi]]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    out, i = defaultdict(int), 0
    for a, b, label in _innermost(spans, _labels(spans), lo, hi):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            out[label] += min(b, idle[j][1]) - max(a, idle[j][0])
            j += 1
    return dict(out)
