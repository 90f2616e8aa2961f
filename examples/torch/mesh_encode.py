"""Chunk-per-card encode with cudahype (flutpu_torch counterpart of
examples/mesh_encode.py).

cudahype deals its chunk x spatial mesh round the visible cards. Chunks
per dispatch: one per chunk shard the cards hold (at most 8 cards,
divided by ``spatial``), and at least one, so ``fvc-motion 2`` (4 chunks
x 2 row stripes on 8 cards) runs on one card as 1 chunk of 2 stripes;
``--device cpu`` is one shard on the CPU.

  python examples/torch/mesh_encode.py fvc-motion
  # sequence-parallel: row stripes, halo rows exchanged between them
  python examples/torch/mesh_encode.py fvc-motion 2
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch

from flutpu_torch.codec.avimux import parse_avi
from flutpu_torch.codec.fvc import FvcDecoder
from flutpu_torch.codec.jpeg import decode_jpeg, psnr
from flutpu_torch.core import MessageType, parse_launch
from flutpu_torch.core.elements import make_test_frame


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("codec", nargs="?", default="fvc",
                    help="jpeg | fvc | fvc-motion")
    ap.add_argument("spatial", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="output file (default: "
                    "mesh_encode.avi or .fvc in the temporary directory)")
    args = ap.parse_args(argv)
    codec, spatial, dev = args.codec, args.spatial, args.device
    cards = torch.cuda.device_count() if dev == "cuda" else 1
    chunks = max(1, min(8, cards) // spatial)
    n = chunks * 2
    out = args.out or os.path.join(
        tempfile.gettempdir(),
        f"mesh_encode.{'avi' if codec == 'jpeg' else 'fvc'}")
    sink = "avimux ! " if codec == "jpeg" else ""
    p = parse_launch(
        f"videotestsrc num-buffers={n} pattern=ball width=160 height=96 "
        f"! cudahype gop-size=2 chunks={chunks} spatial={spatial} "
        f"codec={codec} quality=88 device={dev} "
        f"! {sink}filesink location={out}")
    p.play()
    msg = p.bus.timed_pop_filtered(300, [MessageType.EOS,
                                         MessageType.ERROR])
    p.stop()
    if msg is None or msg.type != MessageType.EOS:
        why = "timeout" if msg is None else msg.structure.get("error")
        print(f"ERROR: {why}", file=sys.stderr)
        return 1
    with open(out, "rb") as fh:
        data = fh.read()
    print(f"{codec}: {chunks}-chunk encode of {n} frames x {spatial} "
          f"stripes -> {len(data)} bytes ({out})")
    ref = make_test_frame("ball", 160, 96, n - 1)
    if codec == "jpeg":
        frames = parse_avi(data)["frames"]
        print(f"demuxed {len(frames)} frames; last-frame psnr "
              f"{psnr(ref, decode_jpeg(frames[-1])):.1f} dB")
    else:
        dec = FvcDecoder(dev).decode_stream(data)
        print(f"decoded {dec.shape}; last-frame psnr "
              f"{psnr(ref, dec[-1]):.1f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
