"""The port's copies of flutpu's ``fluc`` (mutex, monitor, barrier, the
bandwidth meter) and ``io`` (the downloader and its synchronous helper),
on the port's build of the native library and on their pure-Python
fallbacks: a subset of tests/test_io_fluc.py, with ``file://`` and
loopback sources only. Every payload the downloader delivers is counted
by the port's process-global meter; both packages' meters give the same
estimates for the same readings."""

import os
import socket
import threading
import time

import pytest
import torch

from flutpu.fluc.bwmeter import BwMeter as JBwMeter
from flutpu_torch import native
from flutpu_torch.fluc import Barrier, Monitor, Mutex
from flutpu_torch.fluc.bwmeter import BwMeter, SockBwMeter, bwmeter
from flutpu_torch.io import (DownloadHelper, Downloader, TaskOutcome,
                             download_sync, outcome_string)
from torch_helpers import LoopbackServer

torch.set_num_threads(1)

HELLO = b"hello downloader" * 100
BIG = os.urandom(300 * 1024)


@pytest.fixture(scope="module")
def server():
    with LoopbackServer({"/hello.txt": HELLO, "/big.bin": BIG}) as srv:
        yield srv


def test_native_library_binds_fluc_and_the_downloader():
    lib = native.get_lib()
    assert lib is not None
    for name in ("flu_mutex_new", "flu_monitor_new", "flu_barrier_new",
                 "flu_bwmeter_sock_new", "flu_dl_new", "flu_dl_new_task",
                 "flu_dl_task_get_header", "flu_dl_getdate"):
        assert getattr(lib, name).restype is not None, name
    assert type(bwmeter).__name__ == "_NativeBwMeter"


def test_mutex_and_monitor():
    m = Mutex()
    with m:
        pass
    assert m.trylock()
    m.unlock()
    mon, hits = Monitor(), []

    def waiter():
        with mon:
            mon.wait(timeout_ms=5000)
            hits.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with mon:
        mon.signal()
    t.join(timeout=5)
    assert hits == [1]


def test_barrier_gate_and_timeout():
    b, passed = Barrier(open_=False), []
    t = threading.Thread(target=lambda: (b.pass_(), passed.append(1)))
    t.start()
    time.sleep(0.05)
    assert passed == []
    b.set_open(True)
    t.join(timeout=5)
    assert passed == [1]
    b = Barrier(open_=False)
    t0 = time.monotonic()
    assert not b.trypass_for(100)
    assert time.monotonic() - t0 >= 0.09
    b.set_open(True)
    assert b.trypass_for(100)


@pytest.mark.parametrize("windows", [
    [(0, 0.0), (128 * 1024, 0.2)],
    [(0, 0.0), (200 * 1024, 0.2), (20 * 1024, 0.75), (400 * 1024, 1.0)],
    [(0, 0.0), (10, 0.05), (10, 0.6), (70 * 1024, 0.75)]])
def test_meter_equals_flutpus(windows):
    """The windowed rate and the asymmetric EWMA (rise 0.2, fall 1.0) of
    flutpu's meter, reading for reading."""
    t, j = BwMeter(), JBwMeter()
    for m in (t, j):
        m.session_start()
    for nbytes, now in windows:
        t.data(nbytes, _now=now)
        j.data(nbytes, _now=now)
        assert t.stats() == j.stats()
    raw, avg, total = t.stats()
    assert total == sum(n for n, _ in windows) and raw > 0 and avg > 0


def test_sock_meter_feeds_the_global_one():
    a, b = socket.socketpair()
    try:
        m = SockBwMeter(feed_global=True)
        g0 = bwmeter.stats()[2]
        a.sendall(b"x" * 4096)
        got = b""
        while len(got) < 4096:
            got += m.recv(b, 65536)
        assert m.stats()[2] == 4096
        assert bwmeter.stats()[2] - g0 >= 4096
        m.close()
    finally:
        a.close()
        b.close()
    m = SockBwMeter(feed_global=False)
    g0 = bwmeter.stats()[2]
    m.data(1234)
    assert m.stats()[2] == 1234 and bwmeter.stats()[2] == g0
    m.close()


@pytest.mark.parametrize("force_python", [False, True])
class TestDownloader:
    def test_file_url(self, force_python, tmp_path):
        p = tmp_path / "data.bin"
        payload = os.urandom(50000)
        p.write_bytes(payload)
        with DownloadHelper(force_python=force_python) as h:
            data, outcome, _ = h.download(f"file://{p}")
        assert outcome == TaskOutcome.OK and data == payload

    def test_file_not_found(self, force_python):
        with DownloadHelper(force_python=force_python) as h:
            data, outcome, _ = h.download("file:///nonexistent/nope.bin")
        assert data is None
        assert outcome in (TaskOutcome.FILE_NOT_FOUND, TaskOutcome.ERROR)

    def test_http_get_is_metered(self, server, force_python):
        g0 = bwmeter.stats()[2]
        with DownloadHelper(force_python=force_python) as h:
            data, outcome, status = h.download(server.url("/big.bin"))
        assert (outcome, status) == (TaskOutcome.OK, 200) and data == BIG
        assert bwmeter.stats()[2] - g0 >= len(BIG)

    def test_http_404(self, server, force_python):
        with DownloadHelper(force_python=force_python) as h:
            _, outcome, status = h.download(server.url("/missing.txt"))
        assert (outcome, status) == (TaskOutcome.HTTP_ERROR, 404)

    def test_sequence_in_order(self, server, force_python):
        done, ev = [], threading.Event()

        def done_cb(outcome, status, size, task):
            done.append(task.url.rsplit("/", 1)[-1])
            if len(done) == 3:
                ev.set()

        dl = Downloader(None, done_cb, force_python=force_python)
        try:
            for name in ("hello.txt", "big.bin", "hello.txt"):
                dl.new_task(server.url(f"/{name}"))
            assert ev.wait(20)
            assert done == ["hello.txt", "big.bin", "hello.txt"]
        finally:
            dl.destroy()


def test_download_sync_and_outcome_names(server):
    assert download_sync(server.url("/hello.txt")) == HELLO
    assert outcome_string(TaskOutcome.TIMEOUT) == "TIMEOUT"
