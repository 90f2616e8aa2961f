#!/usr/bin/env python3
"""A/B of the search kernels between two checkouts on one NVIDIA GPU, in
one process: K3 (``flu_motion_search_mc``), K6a at 8x8
(``flu_motion_search_mc_blocks``) and K5 (``flu_motion_search_hier``).

Each checkout's ``flutpu_torch/csrc/motion.cu`` is compiled by nvcc with
``flutpu_torch._build``'s flags into its own library; both are called
through ctypes (argtypes as ``_build`` sets them) on the same 1088x1920
gradient-ball luma pair (K6a on its 2x2-mean-pooled 544x960 planes),
and on a seeded noise pair rolled by (5, -40) for the comparison. Each
shape's turns run other, this, this, other; each turn is the mean device
ms of 10 calls behind a device sleep (CUDA events). Vectors and
predictions must be equal between the two, bit for bit, on both pairs.
While the turns run, ``nvidia-smi`` samples the SM clock every 100 ms.

Usage, from this checkout's root (for example against the parent commit
unpacked with ``git archive``)::

    python3 ab_motion.py OTHER_CHECKOUT [--k3 7,33,64,126] [--k5 7,40,64,126]
        [--k6a 64] [--batched 7]

``--k3``, ``--k5``, ``--k6a``: the search ranges of each kernel (an empty
list skips it); ``--batched``: K3's ranges at 8 chunks in one launch.
Prints the card's name and power limit, one line per kernel and range,
and the SM clocks seen.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

PH, PW, C = 1088, 1920, 8
ENTRIES = {"K3": "flu_motion_search_mc", "K6a": "flu_motion_search_mc_blocks",
           "K5": "flu_motion_search_hier"}


def _build(root: str, out_dir: str, nvcc: str, flags, configure):
    src = os.path.join(root, "flutpu_torch", "csrc", "motion.cu")
    lib = os.path.join(out_dir, f"motion_{len(os.listdir(out_dir))}.so")
    subprocess.run([nvcc, *flags, "-shared", "-o", lib, src], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    configure(dll)
    return dll


def _ranges(text: str):
    return [int(x) for x in text.split(",") if x.strip()]


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    ap.add_argument("--k3", type=_ranges, default=[7, 33, 64, 126])
    ap.add_argument("--k5", type=_ranges, default=[7, 40, 64, 126])
    ap.add_argument("--k6a", type=_ranges, default=[64])
    ap.add_argument("--batched", type=_ranges, default=[7])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_motion.py needs a CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from flutpu_torch import _build as B
    from flutpu_torch.codec.ops.colorspace import planes_to_i420, \
        subsample_420
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    print(_smi("name,power.limit"), flush=True)

    def configure(dll):
        # _build's argtypes for the motion entries
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, extra in (("flu_motion_search_mc", []),
                            ("flu_motion_search_mc_blocks", [i]),
                            ("flu_motion_search_hier", [])):
            getattr(dll, name).argtypes = [p, p, p, p, i, i, i, i, *extra, p]
            getattr(dll, name).restype = i

    flags = [f for f in B.NVCC_FLAGS if f != "-Xptxas=-v"]
    dev = torch.device("cuda", 0)
    y = planes_to_i420(*gradient_ball_planes(PH, PW, 2 * C, 0,
                                             device=dev))[0]
    ball = (y[1::2].contiguous(), y[0::2].contiguous())
    g = torch.Generator().manual_seed(17)
    prev = (torch.rand((PH, PW), generator=g) * 255).to(dev)
    noise = (torch.roll(prev, (5, -40), (0, 1)).contiguous(), prev)
    pairs = {"ball": ball, "noise": noise}
    # each kernel's planes: K6a's pooled; C chunks' copies one after the
    # other for the batched launches
    planes = {}
    for label, pair in pairs.items():
        planes[label, "K6a", 1] = tuple(subsample_420(p).contiguous()
                                        for p in pair)
        planes[label, "K3", 1] = planes[label, "K5", 1] = pair
        planes[label, "K3", C] = tuple(p.expand(C, *p.shape).contiguous()
                                       for p in pair)
    with tempfile.TemporaryDirectory() as d:
        libs = {"this": _build(here, d, B.find_nvcc(), flags, configure),
                "other": _build(os.path.abspath(args.other), d,
                                B.find_nvcc(), flags, configure)}
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(name, kernel, label, nc, r):
            cur, prev = planes[label, kernel, nc]
            mb = 8 if kernel == "K6a" else 16
            h, w = cur.shape[-2:]
            mv = torch.empty((nc, h // mb, w // mb, 2), dtype=torch.int32,
                             device=dev)
            pred = torch.empty((nc, h, w), device=dev)
            extra = (mb,) if kernel == "K6a" else ()
            err = getattr(libs[name], ENTRIES[kernel])(
                cur.data_ptr(), prev.data_ptr(), mv.data_ptr(),
                pred.data_ptr(), nc, h, w, r, *extra, stream)
            if err:
                raise RuntimeError(f"{name} {kernel} r={r}: CUDA error {err}")
            return mv, pred

        def time_ms(fn, reps):
            fn()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(2e6 + reps * 4e5))
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / reps

        cases = ([("K3", 1, r) for r in args.k3]
                 + [("K3", C, r) for r in args.batched]
                 + [("K6a", 1, r) for r in args.k6a]
                 + [("K5", 1, r) for r in args.k5])
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            for kernel, nc, r in cases:
                for label in pairs:
                    got = [call(n, kernel, label, nc, r)
                           for n in ("this", "other")]
                    if not all(torch.equal(x.view(torch.int32),
                                           z.view(torch.int32))
                               for x, z in zip(*got)):
                        raise RuntimeError(f"{kernel} C={nc} r={r}: the "
                                           "checkouts differ")
                turns = [time_ms(lambda: call(n, kernel, "ball", nc, r), 10)
                         for n in ("other", "this", "this", "other")]
                shape = ("pooled 544x960 plane" if kernel == "K6a" else
                         "1088x1920 luma frame" if nc == 1 else
                         "1088x1920 frame step of 8 chunks")
                print(f"{kernel} C={nc} r={r} per {shape}: other "
                      f"{turns[0]:.4f}, {turns[3]:.4f} ms; this "
                      f"{turns[1]:.4f}, {turns[2]:.4f} ms; vectors and "
                      "predictions equal on both pairs", flush=True)
        finally:
            sampler.terminate()
            out, _ = sampler.communicate(timeout=10)
        clocks = [tuple(int(v) for v in line.split(","))
                  for line in out.splitlines() if line.count(",") == 1
                  and all(v.strip().isdigit() for v in line.split(","))]
        if clocks:
            sm = [c for c, _ in clocks]
            print(f"SM clock during the turns: {min(sm)}-{max(sm)} MHz "
                  f"({len(sm)} samples), max {clocks[0][1]} MHz", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
