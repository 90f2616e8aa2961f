"""Downloader session — Python face of the native fludownloader.

Reference: libs/flu/downloader/lib/fludownloader.[ch]. A session owns one
native worker thread; tasks queue and run in order with look-ahead request
pipelining at 75%, pause/resume, timeouts, an outcome taxonomy, and
fault-injection via outcome override. Callbacks arrive on the worker
thread. A pure-Python fallback (urllib + thread) covers environments
without the native library.
"""

from __future__ import annotations

import ctypes
import enum
import queue as _pyqueue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .. import native
from ..fluc import Barrier, bwmeter


class TaskOutcome(enum.IntEnum):
    OK = 0
    PENDING = 1
    ABORTED = 2
    ERROR = 3
    COULD_NOT_CONNECT = 4
    CONNECTION_REFUSED = 5
    HTTP_ERROR = 6
    SEND_ERROR = 7
    RECV_ERROR = 8
    TIMEOUT = 9
    FILE_NOT_FOUND = 10
    COULD_NOT_RESOLVE_HOST = 11
    SSL_ERROR = 12
    NO_TASK = 13
    TOO_MANY_REDIRECTS = 14
    DECODE_ERROR = 15  # corrupt/truncated Content-Encoding payload


class SslStatus(enum.IntEnum):
    """SSL status taxonomy (reference fludownloader.h:50-82)."""
    OK = 0
    CONNECT_ERROR = 1
    ENGINE_NOT_FOUND = 2
    ENGINE_SET_FAILED = 3
    CERTPROBLEM = 4
    CIPHER = 5
    CACERT = 6
    ENGINE_INIT_FAILED = 7
    CACERT_BADFILE = 8
    SHUTDOWN_FAILED = 9
    CRL_BADFILE = 10
    ISSUER_ERROR = 11
    PINNEDPUBKEYNOTMATCH = 12
    INVALIDCERTSTATUS = 13
    NO_TASK = 14


DataCallback = Callable[[bytes, "Task"], bool]
DoneCallback = Callable[[TaskOutcome, int, int, "Task"], Optional[bool]]


@dataclass
class Task:
    url: str
    range: str = ""
    user_data: object = None
    outcome: TaskOutcome = TaskOutcome.PENDING
    http_status: int = 0
    downloaded: int = 0
    content_length: int = 0
    ssl_status: SslStatus = SslStatus.OK
    raw_headers: str = ""  # full response header block (task_get_header)
    date: str = ""         # Date response header (task_get_date analog)
    _native_handle: Optional[int] = None
    _session: object = None
    _forced: bool = False
    _abort: bool = False

    def abort(self):
        self._abort = True
        if self._native_handle is not None and self._session is not None:
            self._session._lib.flu_dl_abort_task(self._native_handle)

    def set_outcome(self, outcome: TaskOutcome):
        """Fault injection hook (reference fludownloader.h:166-168)."""
        self.outcome = outcome
        self._forced = True
        if self._native_handle is not None and self._session is not None:
            self._session._lib.flu_dl_task_set_outcome(
                self._native_handle, int(outcome))

    @property
    def length(self) -> int:
        if self._native_handle is not None and self._session is not None:
            return int(self._session._lib.flu_dl_task_get_length(
                self._native_handle))
        return self.content_length


def outcome_string(outcome: TaskOutcome) -> str:
    return outcome.name


class Downloader:
    """A download session (reference: FluDownloader)."""

    def __init__(self, data_cb: Optional[DataCallback] = None,
                 done_cb: Optional[DoneCallback] = None,
                 force_python: bool = False):
        self.data_cb = data_cb
        self.done_cb = done_cb
        self._lib = None if force_python else native.get_lib()
        self._tasks: Dict[int, Task] = {}
        self._lock = threading.Lock()
        self._task_counter = 0
        if self._lib is not None:
            self._c_data_cb = native.DATA_CB(self._on_data)
            self._c_done_cb = native.DONE_CB(self._on_done)
            self._ctx = self._lib.flu_dl_new(self._c_data_cb, self._c_done_cb)
            bwmeter.session_start()
        else:
            self._ctx = None
            self._py = _PythonWorker(self)
            bwmeter.session_start()

    # -- native callbacks --------------------------------------------------
    def _on_data(self, buf, size, user_data, task_handle) -> int:
        task = self._tasks.get(int(user_data or 0))
        if task is None:
            return 1
        data = ctypes.string_at(buf, size)
        task.downloaded += len(data)
        if self.data_cb is not None:
            if not self.data_cb(data, task):
                return 0
        return 1

    def _on_done(self, outcome, http_status, size, user_data, task_handle,
                 cancel_remaining):
        task = self._tasks.pop(int(user_data or 0), None)
        if task is None:
            return
        task.outcome = TaskOutcome(outcome)
        task.http_status = http_status
        task.content_length = int(
            self._lib.flu_dl_task_get_length(task_handle)) or task.downloaded
        task.ssl_status = SslStatus(int(
            self._lib.flu_dl_task_get_ssl_status(task_handle)))
        # capture header snapshot while the native task is still alive
        # (reference fludownloader_task_get_header / _get_date)
        hdr = self._lib.flu_dl_task_get_header(task_handle)
        task.raw_headers = hdr.decode("latin-1") if hdr else ""
        date = self._lib.flu_dl_task_get_date(task_handle)
        task.date = date.decode("latin-1") if date else ""
        task._native_handle = None
        if self.done_cb is not None:
            if self.done_cb(task.outcome, http_status, size, task):
                cancel_remaining[0] = 1

    # -- API ---------------------------------------------------------------
    def new_task(self, url: str, range: str = "",
                 user_data: object = None) -> Task:
        task = Task(url=url, range=range or "", user_data=user_data,
                    _session=self)
        with self._lock:
            self._task_counter += 1
            tid = self._task_counter
        self._tasks[tid] = task
        if self._lib is not None:
            task._native_handle = self._lib.flu_dl_new_task(
                self._ctx, url.encode(), (range or "").encode(),
                ctypes.c_void_p(tid))
        else:
            self._py.submit(tid, task)
        return task

    def abort_all(self, including_current: bool = True):
        if self._lib is not None:
            self._lib.flu_dl_abort_all(self._ctx, 1 if including_current else 0)
        else:
            self._py.abort_all(including_current)

    def pause(self):
        if self._lib is not None:
            self._lib.flu_dl_pause(self._ctx)
        else:
            self._py.barrier.set_open(False)

    def resume(self):
        if self._lib is not None:
            self._lib.flu_dl_resume(self._ctx)
        else:
            self._py.barrier.set_open(True)

    def set_timeouts(self, connect_ms: int, idle_ms: int):
        if self._lib is not None:
            self._lib.flu_dl_set_timeouts(self._ctx, connect_ms, idle_ms)

    def set_user_agent(self, ua: str):
        if self._lib is not None:
            self._lib.flu_dl_set_user_agent(self._ctx, ua.encode())

    def set_cookies(self, cookies: str):
        if self._lib is not None:
            self._lib.flu_dl_set_cookies(self._ctx, cookies.encode())

    def set_proxy(self, proxy: str):
        if self._lib is not None:
            self._lib.flu_dl_set_proxy(self._ctx, proxy.encode())
        else:
            self._py.proxy = proxy

    def set_ssl(self, verify: bool = True, ca_file: Optional[str] = None):
        """TLS configuration: certificate verification on/off and an
        optional CA bundle override (tests, private roots)."""
        if self._lib is not None:
            self._lib.flu_dl_set_ssl(self._ctx, 1 if verify else 0,
                                     (ca_file or "").encode())
        else:
            self._py.ssl_verify = verify
            self._py.ca_file = ca_file

    def set_polling_period(self, period_us: int):
        if self._lib is not None:
            self._lib.flu_dl_set_polling_period(self._ctx, period_us)

    def tasks_count(self) -> int:
        if self._lib is not None:
            return int(self._lib.flu_dl_get_tasks_count(self._ctx))
        return self._py.count()

    def destroy(self):
        if self._lib is not None and self._ctx is not None:
            self._lib.flu_dl_destroy(self._ctx)
            self._ctx = None
        elif self._ctx is None and hasattr(self, "_py"):
            self._py.stop()
        bwmeter.session_end()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()


class _PythonWorker:
    """urllib-based fallback worker preserving the session semantics."""

    def __init__(self, session: Downloader):
        self.session = session
        self.queue: "_pyqueue.Queue" = _pyqueue.Queue()
        self.barrier = Barrier(True)
        self.proxy: Optional[str] = None
        self.ssl_verify = True
        self.ca_file: Optional[str] = None
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, tid: int, task: Task):
        self.queue.put((tid, task))

    def count(self) -> int:
        return self.queue.qsize()

    def abort_all(self, including_current: bool):
        try:
            while True:
                _, t = self.queue.get_nowait()
                t._abort = True
                self._finish(t, TaskOutcome.ABORTED)
        except _pyqueue.Empty:
            pass

    def stop(self):
        self.running = False
        self.queue.put(None)

    def _finish(self, task: Task, outcome: TaskOutcome):
        if not task._forced:
            task.outcome = outcome
        self.session._tasks = {k: v for k, v in self.session._tasks.items()
                               if v is not task}
        if self.session.done_cb is not None:
            self.session.done_cb(task.outcome, task.http_status,
                                 task.downloaded, task)

    def _loop(self):
        import urllib.request
        import urllib.error
        while self.running:
            item = self.queue.get()
            if item is None:
                return
            _, task = item
            if task._abort or task._forced:
                self._finish(task, TaskOutcome.ABORTED)
                continue
            try:
                import ssl as _ssl
                req = urllib.request.Request(task.url)
                if task.range and task.range != "HEAD":
                    req.add_header("Range", f"bytes={task.range}")
                if task.range == "HEAD":
                    req.get_method = lambda: "HEAD"
                sctx = _ssl.create_default_context(cafile=self.ca_file)
                if not self.ssl_verify:
                    sctx.check_hostname = False
                    sctx.verify_mode = _ssl.CERT_NONE
                handlers = [urllib.request.HTTPSHandler(context=sctx)]
                if self.proxy:
                    handlers.append(urllib.request.ProxyHandler(
                        {"http": self.proxy, "https": self.proxy}))
                opener = urllib.request.build_opener(*handlers)
                with opener.open(req, timeout=10) as resp:
                    task.http_status = getattr(resp, "status", 200) or 200
                    length = resp.headers.get("Content-Length") \
                        if hasattr(resp, "headers") else None
                    if length:
                        task.content_length = int(length)
                    if hasattr(resp, "headers"):
                        task.raw_headers = str(resp.headers)
                        task.date = resp.headers.get("Date", "") or ""
                    while not task._abort:
                        self.barrier.trypass_for(4000)
                        chunk = resp.read(64 * 1024)
                        if not chunk:
                            break
                        task.downloaded += len(chunk)
                        bwmeter.data(len(chunk))
                        if self.session.data_cb is not None:
                            if not self.session.data_cb(chunk, task):
                                task._abort = True
                self._finish(task, TaskOutcome.ABORTED if task._abort
                             else TaskOutcome.OK)
            except urllib.error.HTTPError as e:
                task.http_status = e.code
                if (e.code in (301, 302, 303, 307, 308)
                        and e.headers.get("Location")):
                    # urllib surfaces an exhausted redirect chain as an
                    # HTTPError carrying the final 3xx status + Location
                    self._finish(task, TaskOutcome.TOO_MANY_REDIRECTS)
                elif e.code in (301, 302, 303, 307, 308):
                    # a Location-less 3xx is not followable: deliver its
                    # body as an ordinary (successful) response — matching
                    # the native downloader and curl's FOLLOWLOCATION
                    try:
                        body = e.read()
                    except Exception:
                        body = b""
                    if body:
                        task.downloaded += len(body)
                        bwmeter.data(len(body))
                        if self.session.data_cb is not None:
                            self.session.data_cb(body, task)
                    self._finish(task, TaskOutcome.OK)
                else:
                    self._finish(task, TaskOutcome.HTTP_ERROR)
            except FileNotFoundError:
                self._finish(task, TaskOutcome.FILE_NOT_FOUND)
            except urllib.error.URLError as e:
                import ssl as _ssl
                if isinstance(getattr(e, "reason", None), _ssl.SSLError):
                    task.ssl_status = SslStatus.CACERT
                    self._finish(task, TaskOutcome.SSL_ERROR)
                else:
                    self._finish(task, TaskOutcome.ERROR)
            except Exception:
                self._finish(task, TaskOutcome.ERROR)
