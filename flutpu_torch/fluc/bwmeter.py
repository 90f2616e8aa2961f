"""Bandwidth meter: process-global read-bandwidth estimator.

Reference: fluc bwmeter (fluc_bwmeter_base.c): windowed raw measurement
(window closes at >=0.1 s or >=64 KiB, forced at 0.5 s) smoothed with an
asymmetric EWMA — rise alpha 0.2, fall alpha 1.0 — a deliberately
conservative minimum-available-bandwidth estimate for adaptive streaming
decisions. Native singleton when built; Python fallback mirrors it.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Tuple

from .. import native

_MIN_WINDOW_SEC = 0.1
_FORCE_WINDOW_SEC = 0.5
_MIN_WINDOW_BYTES = 64 * 1024
_RISE_ALPHA = 0.2
_FALL_ALPHA = 1.0


class BwMeter:
    """Python mirror of the native meter (used when the lib is absent, and
    directly unit-testable)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.sessions = 0
        self._window_start = None
        self._window_bytes = 0
        self.raw_bps = 0.0
        self.avg_bps = 0.0
        self.total_bytes = 0
        self._have_avg = False

    def session_start(self):
        with self._lock:
            if self.sessions == 0:
                self._window_start = None
                self._window_bytes = 0
            self.sessions += 1

    def session_end(self):
        with self._lock:
            if self.sessions > 0:
                self.sessions -= 1

    def data(self, nbytes: int, _now=None):
        with self._lock:
            now = time.monotonic() if _now is None else _now
            if self._window_start is None:
                self._window_start = now
            self._window_bytes += nbytes
            self.total_bytes += nbytes
            elapsed = now - self._window_start
            done = (elapsed >= _MIN_WINDOW_SEC
                    and self._window_bytes >= _MIN_WINDOW_BYTES) \
                or elapsed >= _FORCE_WINDOW_SEC
            if done and elapsed > 0:
                self.raw_bps = self._window_bytes * 8.0 / elapsed
                if not self._have_avg:
                    self.avg_bps = self.raw_bps
                    self._have_avg = True
                else:
                    alpha = _RISE_ALPHA if self.raw_bps > self.avg_bps \
                        else _FALL_ALPHA
                    self.avg_bps += alpha * (self.raw_bps - self.avg_bps)
                self._window_start = now
                self._window_bytes = 0

    def stats(self) -> Tuple[float, float, int]:
        with self._lock:
            return self.raw_bps, self.avg_bps, self.total_bytes


class _NativeBwMeter:
    """Facade over the native global singleton."""

    def __init__(self, lib):
        self._lib = lib

    def session_start(self):
        self._lib.flu_bwmeter_session_start()

    def session_end(self):
        self._lib.flu_bwmeter_session_end()

    def data(self, nbytes: int):
        self._lib.flu_bwmeter_data(nbytes)

    def stats(self) -> Tuple[float, float, int]:
        raw = ctypes.c_double()
        avg = ctypes.c_double()
        total = ctypes.c_uint64()
        self._lib.flu_bwmeter_get(ctypes.byref(raw), ctypes.byref(avg),
                                  ctypes.byref(total))
        return raw.value, avg.value, total.value


class SockBwMeter:
    """Per-connection read meter (reference fluc_bwmeter_sock.c:14-35).

    The sock variant of the meter: the same windowed base + asymmetric
    EWMA, but *instantiable* — one instance per socket/connection — so a
    single transfer's bandwidth can be estimated in isolation while the
    global singleton keeps accounting for total traffic. ``recv`` wraps a
    socket read and feeds both this meter and (by default) the global one,
    which is how the reference's downloader-style consumers use it."""

    def __init__(self, feed_global: bool = True):
        self.feed_global = feed_global
        lib = native.get_lib()
        self._lib = lib if lib is not None and \
            hasattr(lib, "flu_bwmeter_sock_new") else None
        if self._lib is not None:
            self._h = self._lib.flu_bwmeter_sock_new()
            self._lib.flu_bwmeter_sock_start(self._h)
        else:
            self._py = BwMeter()
            self._py.session_start()

    def data(self, nbytes: int):
        if self._lib is not None:
            self._lib.flu_bwmeter_sock_data(self._h, nbytes)
        else:
            self._py.data(nbytes)
        if self.feed_global:
            bwmeter.data(nbytes)

    def recv(self, sock, nbytes: int) -> bytes:
        """sock.recv with the returned byte count metered."""
        data = sock.recv(nbytes)
        if data:
            self.data(len(data))
        return data

    def stats(self) -> Tuple[float, float, int]:
        if self._lib is not None:
            raw = ctypes.c_double()
            avg = ctypes.c_double()
            total = ctypes.c_uint64()
            self._lib.flu_bwmeter_sock_get(
                self._h, ctypes.byref(raw), ctypes.byref(avg),
                ctypes.byref(total))
            return raw.value, avg.value, total.value
        return self._py.stats()

    def close(self):
        if self._lib is not None:
            if self._h is not None:
                self._lib.flu_bwmeter_sock_end(self._h)
                self._lib.flu_bwmeter_sock_free(self._h)
                self._h = None
            self._lib = None
        elif getattr(self, "_py", None) is not None:
            self._py.session_end()
            self._py = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def _make_global():
    lib = native.get_lib()
    if lib is not None:
        return _NativeBwMeter(lib)
    return BwMeter()


bwmeter = _make_global()
"""The process-global meter (reference fluc_bwmeter.c:25-48). The native
downloader feeds the native singleton directly; Python-side producers call
``bwmeter.data(nbytes)``."""
