"""Synchronous downloader facade.

Reference: libs/flu/downloader/lib/fludownloaderhelper.c — mutex+cond wait
for completion: GET-to-memory, HEAD with header capture, one-shot sync
download.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from .downloader import Downloader, Task, TaskOutcome


class DownloadHelper:
    """Blocking wrapper over a Downloader session."""

    def __init__(self, user_agent: Optional[str] = None,
                 cookies: Optional[str] = None,
                 proxy: Optional[str] = None,
                 ssl_verify: bool = True,
                 ca_file: Optional[str] = None,
                 force_python: bool = False):
        self._chunks: list = []
        self._done = threading.Event()
        self._outcome = TaskOutcome.PENDING
        self._status = 0
        self._dl = Downloader(self._on_data, self._on_done,
                              force_python=force_python)
        if user_agent:
            self._dl.set_user_agent(user_agent)
        if cookies:
            self._dl.set_cookies(cookies)
        if proxy:
            self._dl.set_proxy(proxy)
        if not ssl_verify or ca_file:
            self._dl.set_ssl(ssl_verify, ca_file)

    def _on_data(self, data: bytes, task: Task) -> bool:
        self._chunks.append(data)
        return True

    def _on_done(self, outcome, http_status, size, task):
        self._outcome = outcome
        self._status = http_status
        self._done.set()
        return None

    def download(self, url: str, range: str = "",
                 timeout: float = 30.0) -> Tuple[Optional[bytes], TaskOutcome, int]:
        """GET to memory; returns (payload or None, outcome, http_status)."""
        self._chunks = []
        self._done.clear()
        self._outcome = TaskOutcome.PENDING
        self._dl.new_task(url, range)
        if not self._done.wait(timeout):
            self._dl.abort_all(True)
            return None, TaskOutcome.TIMEOUT, 0
        payload = b"".join(self._chunks)
        if self._outcome != TaskOutcome.OK:
            return None, self._outcome, self._status
        return payload, self._outcome, self._status

    def head(self, url: str, timeout: float = 30.0) -> Tuple[TaskOutcome, int]:
        self._done.clear()
        self._dl.new_task(url, "HEAD")
        if not self._done.wait(timeout):
            self._dl.abort_all(True)
            return TaskOutcome.TIMEOUT, 0
        return self._outcome, self._status

    def close(self):
        self._dl.destroy()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def download_sync(url: str, range: str = "",
                  timeout: float = 30.0) -> Optional[bytes]:
    """One-shot synchronous download
    (reference fludownloaderhelper.c:271-287)."""
    with DownloadHelper() as h:
        payload, outcome, _ = h.download(url, range, timeout)
        return payload


def parse_http_date(datestring: str) -> Optional[int]:
    """HTTP date string → seconds since the Epoch (reference
    fludownloader_getdate, a curl_getdate proxy). Returns None when
    unparseable."""
    from email.utils import parsedate_to_datetime
    try:
        return int(parsedate_to_datetime(datestring).timestamp())
    except (TypeError, ValueError):
        return None
