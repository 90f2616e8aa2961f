"""The trace's reductions per card: on one card they give, bit for bit,
what the harness read before it kept each event's card (the union of
every interval); on hand-made traces of two cards they read each card
alone and then take the mean or the sum."""

import bisect
import random
from collections import defaultdict

import pytest

from benchlib import readers, roofline, trace
from benchlib.runner import Run

MS = 1_000_000
K3 = "void motion_search_banded_kernel<16>(int const*, int)"
CONFIG = {"height": 1080, "width": 1920, "search": "full",
          "search_range": 64}


def _run(device, spans=(), cards=(0,), shards=1, batch=8, chunks=16,
         window=(0, 100 * MS)):
    run = Run({"name": "c", "chips": len(cards)}, CONFIG, {}, batch, shards,
              cards)
    run.records = {"chunks": chunks, "dispatches": [{}]}
    run.trace = {"device": list(device), "spans": [("window", *window)]
                 + list(spans), "other": {}}
    run.window_ns = window
    return run


def _one_card(seed):
    """A long irregular trace on card 0: overlapping kernels and copies,
    searches among them, some outside the window; host spans in turn."""
    rng = random.Random(seed)
    dev, t = [], -5 * MS
    while t < 105 * MS:
        a = t + rng.randrange(0, 400_000)
        b = a + rng.randrange(1, 900_000)
        dev.append((K3 if rng.random() < 0.3 else f"op{rng.randrange(9)}",
                    a, b, 0))
        t = a + rng.randrange(-200_000, 600_000)
    spans, t = [], 0
    while t < 100 * MS:
        d = rng.randrange(1, 7 * MS)
        spans.append((rng.choice(["dispatch", "wait", "finalize"]), t,
                      t + d))
        t += d + rng.randrange(0, 300_000)
    return dev, spans


def _idle_gaps_one_union(device, spans, window):
    """The idle gaps as the harness read them over the union of every
    device interval."""
    lo, hi = window
    busy = [(max(a, lo), min(b, hi)) for _, a, b, _ in device
            if b > lo and a < hi]
    inner = sorted((s for s in spans if s[0] != "window"),
                   key=lambda s: s[1])
    starts = [s[1] for s in inner]
    out, t = defaultdict(int), lo
    for a, b in trace.merged(busy) + [[hi, hi]]:
        if a > t:
            mid = (t + a) // 2
            k = bisect.bisect_right(starts, mid) - 1
            name = inner[k][0] if k >= 0 and inner[k][2] >= mid \
                else "no span"
            out[name] += a - t
        t = max(t, b)
    return dict(out)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_one_card_reads_as_the_union_did(seed):
    dev, spans = _one_card(seed)
    run = _run(dev, spans)
    win = readers.window_device(run)
    lo, hi = run.window_ns
    every = [(a, b) for _, a, b, _ in win]
    rest = [(a, b) for n, a, b, _ in win if n != K3]
    k3 = [(a, b) for n, a, b, _ in win if n == K3]
    assert readers.idle_share_pct(run) == \
        (1.0 - trace.union_ns(every) / (hi - lo)) * 100.0
    assert readers.loop_device_ms_per_chunk(run) == \
        trace.union_ns(rest) / 1e6 / 16
    bound = roofline.search_bound_ms("full", 1088, 1920, 64, 8)
    assert readers.search_roofline_pct(run, "k3") == \
        len(k3) * bound / (sum(b - a for a, b in k3) / 1e6) * 100.0
    busy = [b / 1e9 for b in readers.card_busy_ns(run)]
    assert sum(busy) / len(busy) == trace.union_ns(every) / 1e9
    assert trace.idle_gaps(win, run.trace["spans"], run.window_ns, [0]) \
        == _idle_gaps_one_union(win, run.trace["spans"], run.window_ns)
    assert readers.cards_busy_at_once(run) == 1.0


def test_two_cards_in_turn_read_one_at_once():
    """Card 0 busy 0-40 ms, card 1 busy 50-90 ms of a 100 ms window."""
    run = _run([("op", 0, 40 * MS, 0), ("op", 50 * MS, 90 * MS, 1)],
               [("dispatch", 0, 45 * MS), ("finalize", 45 * MS, 100 * MS)],
               cards=[0, 1], shards=2)
    assert readers.cards_busy_at_once(run) == 1.0
    assert readers.idle_share_pct(run) == 60.0
    assert readers.loop_device_ms_per_chunk(run) == 80 / 16
    # card 0 idle 40-100 (its middle in finalize), card 1 idle 0-50 (its
    # middle in dispatch) and 90-100 (finalize): card-ns, summed
    assert trace.idle_gaps(readers.window_device(run), run.trace["spans"],
                           run.window_ns, run.cards) == {
        "finalize": 70 * MS, "dispatch": 50 * MS}


def test_two_cards_together_read_two_at_once():
    run = _run([("op", 10 * MS, 60 * MS, 0), ("op", 10 * MS, 60 * MS, 1)],
               cards=[0, 1], shards=2)
    assert readers.cards_busy_at_once(run) == 2.0
    assert readers.idle_share_pct(run) == 50.0
    assert readers.card_busy_ns(run) == [50 * MS, 50 * MS]


def test_a_card_that_ran_nothing_counts_idle():
    run = _run([("op", 0, 80 * MS, 0)], cards=[0, 1, 2, 3], shards=4)
    assert readers.idle_share_pct(run) == pytest.approx((20 + 300) / 4)
    assert readers.card_busy_ns(run) == [80 * MS, 0, 0, 0]
    assert readers.cards_busy_at_once(run) == 1.0


def test_a_launch_on_a_mesh_covers_its_shards_chunks():
    """32 chunks a dispatch over four shards: each search launch codes
    eight chunks' planes, and the bound counts eight."""
    k3 = [(K3, i * 10 * MS, i * 10 * MS + 2 * MS, i % 4) for i in range(8)]
    run = _run(k3, cards=[0, 1, 2, 3], shards=4, batch=32)
    bound = roofline.search_bound_ms("full", 1088, 1920, 64, 8)
    assert readers.search_roofline_pct(run, "k3") == \
        pytest.approx(8 * bound / 16 * 100.0)
    assert readers.cards_busy_at_once(run) == 1.0


def test_nothing_traced_reads_none():
    run = _run([])
    for read in (readers.idle_share_pct, readers.loop_device_ms_per_chunk,
                 readers.cards_busy_at_once, readers.card_busy_ns):
        assert read(run) is None
    run.trace = None
    assert readers.cards_busy_at_once(run) is None

