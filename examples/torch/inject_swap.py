"""Hot-swap a device encoder into a running pipeline with injectbin, on
the port (flutpu_torch counterpart of examples/inject_swap.py).

Setting injectbin's ``element`` property prewarms the incoming element
against the current caps BEFORE any dataflow block is installed: the
stream keeps flowing while it runs, so the output gap stays bounded by
queue depth (the reference's brief-block contract). ``cudajpegenc``'s
prewarm builds its kernels (nvcc) on first use and encodes one GOP, so
the printed "prewarm+install" time includes the build when the build
directory ``flutpu_torch/_build/`` is cold.

Usage: python examples/torch/inject_swap.py [--device cuda|cuda:N|cpu]
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from flutpu_torch.core import Buffer, MSECOND, make, parse_launch
from flutpu_torch.launch import watch_errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    p = parse_launch(
        "appsrc name=src caps='video/x-raw, format=RGB, width=64, "
        "height=32' ! injectbin name=ib ! appsink name=out")
    src, ib, sink = (p.get_by_name(x) for x in ("src", "ib", "out"))
    with watch_errors(p) as errors:
        return _swap(p, src, ib, sink, args.device, errors)


def _swap(p, src, ib, sink, device, errors) -> int:
    p.play()

    got = []
    puller = threading.Thread(target=lambda: [
        got.append(b) for b in iter(
            lambda: sink.try_pull_buffer(timeout=10), None)])
    puller.start()

    frame = np.zeros((32, 64, 3), np.uint8)
    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set():
            src.push(Buffer(frame, pts=i * MSECOND, offset=i))
            i += 1
            time.sleep(0.01)
        src.end_of_stream()

    feeder = threading.Thread(target=feed)
    feeder.start()
    time.sleep(0.1)

    enc = make("cudajpegenc", batch_frames=8, device=device)
    t0 = time.perf_counter()
    ib.set_property("element", enc)   # prewarm builds and runs here
    print(f"swap requested; prewarm+install took "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms "
          f"(stream kept flowing)")
    time.sleep(0.5)
    stop.set()
    feeder.join()
    puller.join()
    p.stop()
    if errors:
        print(f"ERROR from {errors[0]}", file=sys.stderr)
        return 1

    jpeg = sum(1 for b in got if bytes(b.data[:2]) == b"\xff\xd8")
    print(f"{len(got)} buffers out: {len(got) - jpeg} raw passthrough, "
          f"{jpeg} JPEG after the swap")
    return 0


if __name__ == "__main__":
    sys.exit(main())
