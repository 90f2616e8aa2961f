"""Throughput-first FVC encoding on the port: B independent chunks per
device round trip (flutpu_torch counterpart of examples/fvc_batched.py).

``encode_chunk_batch_dispatch_src`` encodes B chunks from the on-device
test source in ONE dispatch (the chunks stacked on the chunk axis of
every kernel) and ``encode_chunk_batch_finalize`` brings all of them back
in ONE copy. Each chunk stays independently decodable (its frame 0 is
intra).

On the CPU the chunks are byte-identical to B separate dispatches. On a
card they need not be: the batched in-loop DCT/IDCT runs its matrix
products at another batch shape, whose float32 sums may round the other
way where a coefficient lies on a quantization tie, and the chunk splits
there. So this prints whether the bytes are equal and, where they are
not, the decoded PSNR of both encodes of each differing chunk.

Usage: python examples/torch/fvc_batched.py [--size WxH] [--frames N]
           [--device cuda|cuda:N|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import torch

from flutpu_torch.codec.fvc import FvcDecoder, FvcEncoder
from flutpu_torch.codec.jpeg import psnr
from flutpu_torch.codec.ops.testsrc import gradient_ball_planes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="480x270", help="WxH")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    w, h = (int(v) for v in args.size.split("x"))
    n, batch = args.frames, 2
    enc = FvcEncoder(quality=85, motion=True, device=dev)

    def src(ph, pw, k, start):
        # channel-planar device source; host-fed frames would pay the
        # upload and gain nothing from batching
        return gradient_ball_planes(ph, pw, k, start, device=dev)

    t0 = time.time()
    handle = enc.encode_chunk_batch_dispatch_src(src, 0, n, h, w,
                                                 batch=batch)
    chunks = enc.encode_chunk_batch_finalize(handle)
    dt = time.time() - t0
    print(f"{batch} chunks x {n} frames in one dispatch+fetch: "
          f"{[len(c) for c in chunks]} bytes, {dt:.2f}s incl. first use "
          "(on a card: the kernel build where flutpu_torch/_build/ is "
          "cold)")

    # chunks decode independently and in any order
    dec = FvcDecoder(dev)
    f1, _ = dec.decode_chunk(chunks[1])
    f0, _ = dec.decode_chunk(chunks[0])
    print(f"decoded chunk shapes: {f0.shape} {f1.shape}")

    single = []
    for b in range(batch):
        hh = enc.encode_chunk_dispatch_src(src, b * n, n, h, w)
        single.append(enc.encode_chunk_finalize(hh))
    print("byte-identical to separate dispatches:", single == chunks)
    for b, (one, many) in enumerate(zip(single, chunks)):
        if one == many:
            continue
        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
        ref = torch.stack(src(ph, pw, n, b * n), -1)[:, :h, :w].cpu().numpy()
        ps = [float(np.mean([psnr(ref[i], f[i]) for i in range(n)]))
              for f in (dec.decode_chunk(many)[0], dec.decode_chunk(one)[0])]
        print(f"chunk {b}: differs; mean PSNR batched {ps[0]:.4f} dB, "
              f"separate {ps[1]:.4f} dB (difference "
              f"{abs(ps[0] - ps[1]):.4f} dB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
