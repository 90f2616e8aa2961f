"""The closed loop that drives the program: dispatches of C chunks from
the pool, ``in_flight`` of them enqueued at once, each finalized in order
once the oldest is due, with the benchmark's host spans around every call
into the program."""

from __future__ import annotations

import contextlib
import functools
import time
from collections import deque

from torch.profiler import record_function

from .trace import SPAN


class ClosedLoop:
    """A program's entries ``(dispatch, finalize)`` (an adapter's
    ``entries``: dispatch takes C chunks (C, F, H, W, 3) and returns a
    handle, finalize takes the handle and returns each chunk's output,
    in order) over ``pool`` (P, F, H, W, 3), C chunks a dispatch
    (dispatch d takes pool chunks d*C .. d*C + C - 1, modulo P, a
    multiple of C), on ``cards`` (the cell's devices), with ``mesh`` (a
    ``ChunkMesh``) passed to each dispatch where one is given. The
    outputs of the pool chunks in ``keep`` are kept for the check.
    Per dispatch it records its spans in ns: ``source`` (slicing the
    pool), ``dispatch``, ``wait`` (until the events recorded on every
    card when the dispatch returned have completed: its device work and
    its copies back), ``finalize``; and per chunk its latency, from the
    dispatch call to the return of its finalize."""

    def __init__(self, entries, pool, batch: int, in_flight: int, cards,
                 keep=(), mesh=None):
        self.pool, self.batch = pool, batch
        self.in_flight = in_flight
        self.dispatch_fn, self.finalize_fn = entries
        if mesh is not None:
            self.dispatch_fn = functools.partial(self.dispatch_fn,
                                                 mesh=mesh)
        self.cards = list(cards)
        self.keep = set(keep)
        self.n = 0
        self.traced = False

    @contextlib.contextmanager
    def _span(self, name: str, rec: dict):
        """``rec[name]``: the block's host ns; traced, also a profiler
        annotation ``bench.<name>``."""
        with (record_function(SPAN + name) if self.traced
              else contextlib.nullcontext()):
            t0 = time.perf_counter_ns()
            yield
            rec[name] = time.perf_counter_ns() - t0

    def _events(self):
        """An event recorded on each card's current stream (none on the
        CPU)."""
        import torch
        evs = []
        for dev in self.cards:
            if dev.type == "cuda":
                evs.append(torch.cuda.Event())
                evs[-1].record(torch.cuda.current_stream(dev))
        return evs

    def run(self, seconds: float = None, dispatches: int = None) -> dict:
        """Dispatch until ``seconds`` have passed and every pool chunk was
        dispatched once (or until ``dispatches`` were made), then drain.
        Returns the window's records: ``t0``/``t1`` ns (the first
        dispatch call, the last finalize's return),
        ``dispatches`` [span dict], ``latency_ns`` per chunk, ``chunks``,
        ``frames``, ``kept`` {pool index: [chunk output]}."""
        p = self.pool.shape[0]
        f = self.pool.shape[1]
        pending = deque()
        out = dict(dispatches=[], latency_ns=[], chunks=0, frames=0,
                   kept={})

        def drain():
            idx, handle, evs, start, rec = pending.popleft()
            with self._span("wait", rec):
                for ev in evs:
                    ev.synchronize()
            with self._span("finalize", rec):
                chunks = self.finalize_fn(handle)
            done = time.perf_counter_ns()
            for i, data in zip(idx, chunks):
                out["latency_ns"].append(done - start)
                if i in self.keep:
                    out["kept"].setdefault(i, []).append(data)
            out["chunks"] += len(chunks)
            out["frames"] += len(chunks) * f
            out["dispatches"].append(rec)
            out["t1"] = done

        out["t0"] = t_end = time.perf_counter_ns()
        if seconds is not None:
            t_end += int(seconds * 1e9)
        made = 0
        while (time.perf_counter_ns() < t_end or made * self.batch < p
               if dispatches is None else made < dispatches):
            start = time.perf_counter_ns()
            rec = {}
            first = (self.n * self.batch) % p
            idx = [(first + b) % p for b in range(self.batch)]
            with self._span("source", rec):
                frames = self.pool[first:first + self.batch]
            with self._span("dispatch", rec):
                handle = self.dispatch_fn(frames)
            pending.append((idx, handle, self._events(), start, rec))
            self.n += 1
            made += 1
            if len(pending) == self.in_flight:
                drain()
        while pending:
            drain()
        return out
