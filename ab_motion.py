#!/usr/bin/env python3
"""A/B of the full-search kernel (K3, ``flu_motion_search_mc``) between
two checkouts on one NVIDIA GPU, in one process.

Each checkout's ``flutpu_torch/csrc/motion.cu`` is compiled by nvcc with
``flutpu_torch._build``'s flags into its own library; both are called
through ctypes on the same 1088x1920 gradient-ball luma pairs at range
7: one plane, and 8 chunks' planes in one launch. Turns run other,
this, this, other; each turn is the mean device ms of 20 calls behind a
device sleep (CUDA events). Vectors and predictions must be equal
between the two.

Usage: ``python3 ab_motion.py OTHER_CHECKOUT`` from this checkout's root
(for example the parent commit unpacked with ``git archive``). Prints
the card's name and power limit and one line per shape.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

PH, PW, C = 1088, 1920, 8


def _build(root: str, out_dir: str, nvcc: str, flags) -> ctypes.CDLL:
    src = os.path.join(root, "flutpu_torch", "csrc", "motion.cu")
    lib = os.path.join(out_dir, f"motion_{len(os.listdir(out_dir))}.so")
    subprocess.run([nvcc, *flags, "-shared", "-o", lib, src], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.flu_motion_search_mc.argtypes = [p, p, p, p, i, i, i, i, p]
    dll.flu_motion_search_mc.restype = i
    return dll


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 ab_motion.py OTHER_CHECKOUT (needs a CUDA "
              "device)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from flutpu_torch import _build as B
    from flutpu_torch.codec.ops.colorspace import planes_to_i420
    from flutpu_torch.codec.ops.testsrc import gradient_ball_planes
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    flags = [f for f in B.NVCC_FLAGS if f != "-Xptxas=-v"]
    dev = torch.device("cuda", 0)
    y = planes_to_i420(*gradient_ball_planes(PH, PW, 2 * C, 0,
                                             device=dev))[0]
    cur, prev = y[1::2].contiguous(), y[0::2].contiguous()
    with tempfile.TemporaryDirectory() as d:
        libs = {"this": _build(here, d, B.find_nvcc(), flags),
                "other": _build(os.path.abspath(sys.argv[1]), d,
                                B.find_nvcc(), flags)}
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(name, nc, r):
            mv = torch.empty((nc, PH // 16, PW // 16, 2), dtype=torch.int32,
                             device=dev)
            pred = torch.empty((nc, PH, PW), device=dev)
            err = libs[name].flu_motion_search_mc(
                cur.data_ptr(), prev.data_ptr(), mv.data_ptr(),
                pred.data_ptr(), nc, PH, PW, r, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return mv, pred

        def time_ms(name, nc, r, reps=20):
            call(name, nc, r)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(2e6 + reps * 4e5))
            a.record()
            for _ in range(reps):
                call(name, nc, r)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / reps

        for nc, r in ((1, 7), (C, 7)):
            got = [call(n, nc, r) for n in ("this", "other")]
            same = all(torch.equal(x, z) for x, z in zip(*got))
            if not same:
                raise RuntimeError(f"C={nc} r={r}: the checkouts differ")
            turns = [time_ms(n, nc, r) for n in ("other", "this", "this",
                                                 "other")]
            print(f"K3 C={nc} r={r} per 1088x1920 frame step: other "
                  f"{turns[0]:.4f}, {turns[3]:.4f} ms; this {turns[1]:.4f}, "
                  f"{turns[2]:.4f} ms; vectors and predictions equal",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
