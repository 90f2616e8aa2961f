"""FVC v2 motion-compensated encode vs v1 on the port: size and quality
on moving content (flutpu_torch counterpart of examples/fvc_motion.py).

Usage: python examples/torch/fvc_motion.py [n_frames]
           [--size WxH] [--device cuda|cuda:N|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.jpeg import psnr
from flutpu_torch.core.elements import make_test_frame


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=16)
    ap.add_argument("--size", default="160x96", help="WxH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, dev = args.n_frames, args.device
    w, h = (int(v) for v in args.size.split("x"))
    frames = np.stack([make_test_frame("ball", w, h, i) for i in range(n)])

    v1 = FvcEncoder(quality=85, device=dev).encode_chunk(frames)
    v2 = FvcEncoder(quality=85, motion=True, search_range=7,
                    device=dev).encode_chunk(frames)
    v2b = FvcEncoder(quality=85, motion=True, search_range=7, bframes=2,
                     device=dev).encode_chunk(frames)
    print(f"v1 (DCT residuals):        {len(v1):7d} bytes")
    print(f"v2 (motion-compensated):   {len(v2):7d} bytes "
          f"({100 * len(v2) / len(v1):.1f}% of v1)")
    print(f"v2 + B frames (bframes=2): {len(v2b):7d} bytes "
          f"({100 * len(v2b) / len(v1):.1f}% of v1)")

    dec = FvcDecoder(dev)
    for name, blob in (("v1", v1), ("v2", v2), ("v2b", v2b)):
        out, info = dec.decode_chunk(blob)
        ps = [psnr(frames[i], out[i]) for i in range(n)]
        print(f"{name}: frame types {list(info['types'][:6])}..., "
              f"psnr min/mean {min(ps):.1f}/{np.mean(ps):.1f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
