"""Chunk-parallel FVC encode of a synthetic clip on the port's elements,
then decode + PSNR check (flutpu_torch counterpart of
examples/encode_parallel.py).

The device reaches every branch's encoder through its ``encoder-N``
launch fragment (``encoder-1='cudafvcenc device=cuda'``).

Usage: python examples/torch/encode_parallel.py [n_frames]
           [--size WxH] [--device cuda|cuda:N|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from flutpu_torch.codec.fvc import FvcDecoder
from flutpu_torch.codec.jpeg import psnr
from flutpu_torch.core import parse_launch
from flutpu_torch.core.elements import make_test_frame
from flutpu_torch.launch import watch_errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=30)
    ap.add_argument("--size", default="320x240", help="WxH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, dev = args.n_frames, args.device
    w, h = (int(v) for v in args.size.split("x"))
    branches = " ".join(f"encoder-{k}='cudafvcenc device={dev}'"
                        for k in (1, 2, 3))
    p = parse_launch(
        f"videotestsrc num-buffers={n} pattern=ball width={w} height={h} "
        f"! hype gop-size=5 {branches} ! appsink name=out")
    sink = p.get_by_name("out")
    # an error ends the pull below: no EOS would come
    with watch_errors(p, sink.interrupt) as errors:
        p.play()
        chunks = []
        while (b := sink.try_pull_buffer(timeout=60)) is not None:
            chunks.append(bytes(b.data))
        p.stop()
    if errors:
        print(f"ERROR from {errors[0]}", file=sys.stderr)
        return 1
    stream = b"".join(chunks)
    print(f"{n} frames -> {len(chunks)} chunks, {len(stream)} bytes "
          f"({len(stream) / n:.0f} B/frame)")
    dec = FvcDecoder(dev).decode_stream(stream)
    ps = [psnr(make_test_frame("ball", w, h, i), dec[i]) for i in range(n)]
    print(f"decoded {dec.shape[0]} frames, PSNR min/mean = "
          f"{min(ps):.1f}/{sum(ps) / len(ps):.1f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
