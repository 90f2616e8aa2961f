"""flutpu.fluc — concurrency + metrics SDK bindings.

Python face of the native fluc library (native/fluc: annotated mutex/
monitor/barrier + the global bandwidth meter — reference: fluc
flu-codec-sdk). Pure-Python fallbacks keep behavior identical when the
native library is unavailable.
"""

from .threads import Barrier, Monitor, Mutex
from .bwmeter import BwMeter, bwmeter

__all__ = ["Barrier", "Monitor", "Mutex", "BwMeter", "bwmeter"]
