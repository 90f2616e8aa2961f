"""Render TTML subtitles and burn them into video frames on the card
(flutpu_torch counterpart of examples/subtitle_burnin.py).

``cudattmlrender`` draws the window (host shaping, glyph atlas and
compositor on the device), ``overlay_on_frames`` blends it into the
frames, and frame 0 is written as a PNG with the standard library's
``zlib`` and ``struct``: Pillow is not needed (without it, the renderer
draws with its bitmap font).

Usage: python examples/torch/subtitle_burnin.py [out.png] [--size WxH]
           [--device cuda|cuda:N|cpu]
"""

import argparse
import os
import struct
import sys
import tempfile
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import torch

TTML = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="bottom" tts:origin="10% 78%" tts:extent="80% 18%"
            tts:backgroundColor="#00000090" tts:displayAlign="center"
            tts:textAlign="center"/>
  </layout></head>
  <body><div>
    <p begin="0s" end="5s" region="bottom" tts:color="white"
       tts:textOutline="black 2px">Subtitles, composited on a GPU.</p>
  </div></body>
</tt>"""


def png_bytes(pixels: np.ndarray) -> bytes:
    """An 8-bit RGB or RGBA PNG (filter 0 on every row) of an (h, w, 3)
    or (h, w, 4) uint8 array."""
    h, w, c = pixels.shape
    raw = b"".join(b"\x00" + pixels[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           {3: 2, 4: 6}[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def main(argv=None) -> int:
    from flutpu_torch.core import Buffer, Harness
    from flutpu_torch.core.elements import make_test_frame
    from flutpu_torch.ttml.render.composite import overlay_on_frames

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "burnin.png"))
    ap.add_argument("--size", default="640x360", help="WxH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))
    dev = torch.device(args.device)

    hr = Harness(f"cudattmlrender window-width={w} window-height={h} "
                 f"device={dev}")
    try:
        hr.set_src_caps("application/ttml+xml")
        hr.push(Buffer(TTML.encode(), pts=0))
        hr.push_eos()
        overlay = np.asarray(hr.pull(timeout=20).data)
    finally:
        hr.teardown()

    video = np.stack([make_test_frame("gradient", w, h, i)
                      for i in range(8)])
    burned = overlay_on_frames(torch.from_numpy(video).to(dev),
                               torch.from_numpy(overlay).to(dev)).cpu()
    with open(args.out, "wb") as fh:
        fh.write(png_bytes(burned[0].numpy()))
    print(f"wrote {args.out} ({burned.shape[0]} frames burned in)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
