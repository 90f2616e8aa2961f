"""Concurrency primitives: native-backed with Python fallbacks.

Reference: fluc threads (fluc_mutex/monitor/barrier). The Barrier is the
open/closed gate used for downloader pause/resume.
"""

from __future__ import annotations

import threading
from typing import Optional

from .. import native


class Mutex:
    def __init__(self):
        lib = native.get_lib()
        self._lib = lib
        self._h = lib.flu_mutex_new() if lib is not None else None
        self._py = threading.Lock() if self._h is None else None

    def lock(self):
        if self._h is not None:
            self._lib.flu_mutex_lock(self._h)
        else:
            self._py.acquire()

    def unlock(self):
        if self._h is not None:
            self._lib.flu_mutex_unlock(self._h)
        else:
            self._py.release()

    def trylock(self) -> bool:
        if self._h is not None:
            return bool(self._lib.flu_mutex_trylock(self._h))
        return self._py.acquire(blocking=False)

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.flu_mutex_free(self._h)
            self._h = None


class Monitor:
    """Mutex + condition variable pair (fluc_monitor)."""

    def __init__(self):
        lib = native.get_lib()
        self._lib = lib
        self._h = lib.flu_monitor_new() if lib is not None else None
        if self._h is None:
            self._py_lock = threading.Lock()
            self._py_cond = threading.Condition(self._py_lock)

    def lock(self):
        if self._h is not None:
            self._lib.flu_monitor_lock(self._h)
        else:
            self._py_lock.acquire()

    def unlock(self):
        if self._h is not None:
            self._lib.flu_monitor_unlock(self._h)
        else:
            self._py_lock.release()

    def wait(self, timeout_ms: Optional[int] = None) -> bool:
        if self._h is not None:
            if timeout_ms is None:
                self._lib.flu_monitor_wait(self._h)
                return True
            return bool(self._lib.flu_monitor_wait_ms(self._h, timeout_ms))
        return self._py_cond.wait(
            None if timeout_ms is None else timeout_ms / 1000.0)

    def signal(self):
        if self._h is not None:
            self._lib.flu_monitor_signal(self._h)
        else:
            self._py_cond.notify()

    def broadcast(self):
        if self._h is not None:
            self._lib.flu_monitor_broadcast(self._h)
        else:
            self._py_cond.notify_all()

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.flu_monitor_free(self._h)
            self._h = None


class Barrier:
    """Open/closed gate: threads pass freely while open, block while
    closed (fluc_barrier.c:34-88)."""

    def __init__(self, open_: bool = True):
        lib = native.get_lib()
        self._lib = lib
        self._h = lib.flu_barrier_new(1 if open_ else 0) if lib is not None \
            else None
        self._py = threading.Event() if self._h is None else None
        if self._py is not None and open_:
            self._py.set()

    def set_open(self, open_: bool):
        if self._h is not None:
            self._lib.flu_barrier_set_open(self._h, 1 if open_ else 0)
        elif open_:
            self._py.set()
        else:
            self._py.clear()

    def is_open(self) -> bool:
        if self._h is not None:
            return bool(self._lib.flu_barrier_is_open(self._h))
        return self._py.is_set()

    def pass_(self):
        if self._h is not None:
            self._lib.flu_barrier_pass(self._h)
        else:
            self._py.wait()

    def trypass_for(self, timeout_ms: int) -> bool:
        if self._h is not None:
            return bool(self._lib.flu_barrier_trypass_ms(self._h, timeout_ms))
        return self._py.wait(timeout_ms / 1000.0)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.flu_barrier_free(self._h)
            self._h = None
