"""flutpu_torch-launch — run textual pipeline descriptions (gst-launch
analog; port of flutpu/launch.py).

    python -m flutpu_torch.launch "videotestsrc num-buffers=30 ! cudajpegenc \
        ! filesink location=out.mjpeg"

Runs the pipeline to EOS or to its first error (an ERROR on the bus, or
a streaming thread ended by an exception), printing bus messages.
``-v`` prints each element's factory and every bus message. The port's
elements run on the card (``device=cuda``, their default); ask for the
CPU per element with ``device=cpu``. No environment variable moves an
element off the card: where an element's device is missing, it posts an
ERROR, and the run stops there and exits 1, as ``gst-launch-1.0`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import threading
import time

from .core import MessageType, parse_launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flutpu_torch-launch")
    ap.add_argument("pipeline", nargs="+", help="pipeline description")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="stop after N seconds (0 = run to EOS)")
    args = ap.parse_args(argv)

    desc = " ".join(args.pipeline)
    try:
        pipeline = parse_launch(desc)
    except (ValueError, KeyError) as e:
        print(f"ERROR: could not build pipeline: {e}", file=sys.stderr)
        return 1

    if args.verbose:
        for el in pipeline.iterate_elements():
            print(f"  element {el.name} ({el.FACTORY})", file=sys.stderr)

    done = threading.Event()

    def watch(msg):
        if msg.type == MessageType.EOS:
            done.set()
        if args.verbose or msg.type in (MessageType.ERROR,
                                        MessageType.WARNING):
            print(f"bus: {msg}", file=sys.stderr)

    with watch_errors(pipeline, done.set, watch) as errors:
        return _run(pipeline, args.timeout, done, errors)


# The open ``watch_errors`` blocks: (threads alive at entry, add) each.
# One hook serves them all, chained to the hook it found; it goes in with
# the first block and out with the last, unless other code has put its
# own hook over it meanwhile: then it stays in that hook's chain (so it
# is not put in again) and only passes exceptions on.
_blocks: list = []
_blocks_lock = threading.Lock()
_prev_hook = None
_hooked = False


def _thread_died(hook):
    with _blocks_lock:
        blocks, prev = list(_blocks), _prev_hook
    for before, add in blocks:
        if hook.thread is not None and hook.thread not in before:
            add(f"thread {hook.thread.name}: "
                f"{hook.exc_type.__name__}: {hook.exc_value}")
    prev(hook)


@contextlib.contextmanager
def watch_errors(pipeline, on_error=None, on_message=None):
    """Collect ``pipeline``'s errors while the block runs: each ERROR on
    its bus, and each thread started in the block that ends on an
    exception (an element failing outside a pad's chain, in its EOS flush
    say, posts nothing and ends its streaming thread; the pipeline starts
    its threads when it plays). Yields the list of their descriptions;
    ``on_error()`` runs after each is added, ``on_message(msg)`` on every
    bus message."""
    global _prev_hook, _hooked
    errors = []

    def add(text):
        errors.append(text)
        if on_error is not None:
            on_error()

    def watch(msg):
        if msg.type == MessageType.ERROR:
            add(f"element {getattr(msg.source, 'name', msg.source)}: "
                f"{msg.structure.get('error', msg.structure)}")
        if on_message is not None:
            on_message(msg)

    block = (frozenset(threading.enumerate()), add)
    with _blocks_lock:
        if not _hooked:
            _prev_hook, threading.excepthook = (threading.excepthook,
                                                _thread_died)
            _hooked = True
        _blocks.append(block)
    pipeline.bus.add_watch(watch)
    try:
        yield errors
    finally:
        pipeline.bus.remove_watch(watch)
        with _blocks_lock:
            _blocks.remove(block)
            if not _blocks and threading.excepthook is _thread_died:
                threading.excepthook, _hooked = _prev_hook, False


def _run(pipeline, timeout: float, done: threading.Event, errors) -> int:
    """Play to EOS, the first error or ``timeout`` seconds (0 = none);
    stop; 1 on an error."""
    if pipeline.play().name == "FAILURE":
        print("ERROR: pipeline refused to start", file=sys.stderr)
        pipeline.stop()
        return 1
    print("Pipeline is PLAYING ...", file=sys.stderr)

    t0 = time.monotonic()
    try:
        while not done.wait(0.05):
            if timeout and time.monotonic() - t0 > timeout:
                print("timeout reached", file=sys.stderr)
                break
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    pipeline.stop()
    if errors:
        print(f"ERROR from {errors[0]}", file=sys.stderr)
        print("Pipeline stopped on an error.", file=sys.stderr)
        return 1
    print("Pipeline stopped.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
