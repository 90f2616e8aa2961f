"""Structured per-category logging + profiling hooks.

Rebuild of the reference's GStreamer debug-category system (SURVEY §5.1):
every component gets a named category; levels are controlled per category
via the ``FLUTPU_DEBUG`` env var using the familiar syntax::

    FLUTPU_DEBUG=hype:5,ttmlbase:3,*:2

Levels mirror GStreamer: 0=none 1=error 2=warning 3=info 4=debug 5=log
6=trace 7=memdump. ``memdump`` renders buffer hexdumps like
gstttmlutils.c:350-367.

``trace_span(name)`` marks a phase of the program on the profiler's
timeline. With no torch profiler recording it costs one flag check
(``torch._C._autograd._profiler_enabled()``) and opens nothing; with one
recording it opens a record function of that name, unchanged, in the same
kineto record as the device's kernels, so spans and kernels share one
clock. Its parent is the span that encloses it on the same thread. The
record is the profiler's function scope, not ``record_function``'s user
scope: kineto mirrors a user-scope range onto the device as a
``gpu_user_annotation`` over its kernels, which a reader of the device's
operations would count as device work; a function-scope one stays on the
host. Every span of the program is named ``SPAN_PREFIX`` + its layer and
phase (``flu.jpeg.fetch_wait``), one span per phase of a dispatch or a
finalize, never one per kernel launch or per frame step.
"""

from __future__ import annotations

import logging
import os
import sys
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import torch

#: the first characters of every span the program records
SPAN_PREFIX = "flu."

_LEVELS = {
    0: logging.CRITICAL + 10,
    1: logging.ERROR,
    2: logging.WARNING,
    3: logging.INFO,
    4: logging.DEBUG,
    5: logging.DEBUG - 1,
    6: logging.DEBUG - 2,
    7: logging.DEBUG - 3,
}

logging.addLevelName(_LEVELS[5], "LOG")
logging.addLevelName(_LEVELS[6], "TRACE")
logging.addLevelName(_LEVELS[7], "MEMDUMP")

_categories: Dict[str, "Category"] = {}
_spec: Optional[Dict[str, int]] = None


def _parse_spec() -> Dict[str, int]:
    global _spec
    if _spec is None:
        _spec = {}
        for part in os.environ.get("FLUTPU_DEBUG", "").split(","):
            part = part.strip()
            if not part:
                continue
            name, _, lvl = part.partition(":")
            try:
                _spec[name] = int(lvl) if lvl else 4
            except ValueError:
                pass
    return _spec


def _level_for(name: str) -> int:
    spec = _parse_spec()
    if name in spec:
        return spec[name]
    return spec.get("*", 1)


class Category:
    """A named debug category (GST_DEBUG_CATEGORY analog)."""

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self.logger = logging.getLogger(f"flutpu_torch.{name}")
        lvl = _level_for(name)
        self.logger.setLevel(_LEVELS.get(lvl, logging.ERROR))
        if not self.logger.handlers and lvl >= 2:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            self.logger.addHandler(h)
            self.logger.propagate = False

    def error(self, msg, *a):
        self.logger.error(msg, *a)

    def warning(self, msg, *a):
        self.logger.warning(msg, *a)

    def info(self, msg, *a):
        self.logger.info(msg, *a)

    def debug(self, msg, *a):
        self.logger.debug(msg, *a)

    def log(self, msg, *a):
        self.logger.log(_LEVELS[5], msg, *a)

    def trace(self, msg, *a):
        self.logger.log(_LEVELS[6], msg, *a)

    def memdump(self, label: str, data) -> None:
        """Buffer hexdump at the MEMDUMP level (gstttmlutils.c:350-367)."""
        if not self.logger.isEnabledFor(_LEVELS[7]):
            return
        raw = bytes(data[:256]) if not isinstance(data, (bytes, bytearray)) \
            else bytes(data[:256])
        lines = []
        for off in range(0, len(raw), 16):
            chunk = raw[off:off + 16]
            hexpart = " ".join(f"{b:02x}" for b in chunk)
            asc = "".join(chr(b) if 32 <= b < 127 else "." for b in chunk)
            lines.append(f"  {off:08x}: {hexpart:<47} {asc}")
        self.logger.log(_LEVELS[7], "%s (%d bytes)\n%s", label, len(raw),
                        "\n".join(lines))


def category(name: str, description: str = "") -> Category:
    if name not in _categories:
        _categories[name] = Category(name, description)
    return _categories[name]


_profiling = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast
_NO_SPAN = nullcontext()


def trace_span(name: str):
    """A context manager that records the block as span ``name`` when a
    torch profiler is recording, and does nothing otherwise."""
    return _record(name) if _profiling() else _NO_SPAN


@contextmanager
def profile(logdir: str):
    """Capture a torch profiler trace (host and CUDA activity) of the
    enclosed pipeline section into ``logdir`` as a Chrome trace (the
    reference's external-tracer-hooks analog)."""
    import os
    import torch.profiler
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
