"""Downloader demo on the port (flutpu_torch counterpart of
examples/multidl.py; reference examples/multidl.c analog): queue several
downloads on one session, watch pipelining + the bandwidth meter. Host
only: no device.

Usage: python examples/torch/multidl.py URL [URL...]
"""

import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from flutpu_torch.fluc import bwmeter
from flutpu_torch.io import Downloader


def main(argv=None) -> int:
    urls = sys.argv[1:] if argv is None else list(argv)
    if not urls:
        print("usage: python examples/torch/multidl.py URL [URL...]")
        return 2
    done = threading.Event()
    remaining = [len(urls)]
    lock = threading.Lock()

    def data_cb(chunk, task):
        return True

    def done_cb(outcome, status, size, task):
        print(f"  {task.url}: {outcome.name} http={status} {size} bytes")
        with lock:
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()

    with Downloader(data_cb, done_cb) as dl:
        for u in urls:
            dl.new_task(u)
        finished = done.wait(timeout=120)
    raw, avg, total = bwmeter.stats()
    print(f"bwmeter: raw={raw/1e6:.2f} Mbps avg={avg/1e6:.2f} Mbps "
          f"total={total} B")
    return 0 if finished else 1


if __name__ == "__main__":
    sys.exit(main())
