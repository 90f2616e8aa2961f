"""flutpu.io — network/file I/O subsystem.

Reference: libs/flu/downloader. Threaded download sessions with task
pipelining, outcome taxonomy, pause/resume, fault injection; a synchronous
helper facade; every payload feeds the global fluc bandwidth meter.
"""

from .downloader import (Downloader, SslStatus, Task, TaskOutcome,
                         outcome_string)
from .helper import DownloadHelper, download_sync, parse_http_date

__all__ = ["Downloader", "SslStatus", "Task", "TaskOutcome",
           "outcome_string",
           "DownloadHelper", "download_sync", "parse_http_date"]
