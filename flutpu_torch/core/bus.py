"""Message bus — async element→application channel (GstBus analog)."""

from __future__ import annotations

import enum
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class MessageType(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"
    EOS = "eos"
    STATE_CHANGED = "state-changed"
    ELEMENT = "element"
    NOTIFY = "notify"


@dataclass
class Message:
    type: MessageType
    source: Any = None
    structure: Dict[str, Any] = field(default_factory=dict)

    def __repr__(self) -> str:
        src = getattr(self.source, "name", self.source)
        return f"Message({self.type.value}, src={src}, {self.structure})"


class Bus:
    def __init__(self):
        self._queue: "queue.Queue[Message]" = queue.Queue()
        self._watchers: List[Callable[[Message], None]] = []
        self._lock = threading.Lock()

    def post(self, msg: Message) -> None:
        with self._lock:
            watchers = list(self._watchers)
        for cb in watchers:
            cb(msg)
        self._queue.put(msg)

    def pop(self, timeout: Optional[float] = 0) -> Optional[Message]:
        """timeout=0 → non-blocking, timeout=None → wait forever (the
        timed_pop_filtered convention), else wait up to ``timeout``."""
        try:
            if timeout == 0:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def timed_pop_filtered(self, timeout: Optional[float],
                           types: List[MessageType]) -> Optional[Message]:
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                msg = self._queue.get(timeout=remaining)
            except queue.Empty:
                return None
            if msg.type in types:
                return msg
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def add_watch(self, cb: Callable[[Message], None]) -> None:
        with self._lock:
            self._watchers.append(cb)

    def remove_watch(self, cb: Callable[[Message], None]) -> None:
        with self._lock:
            self._watchers.remove(cb)
