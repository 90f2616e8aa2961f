"""The benchmark of flutpu_torch's FVC encoder on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Runs one cell of ``BENCHMARK.json`` (its
configuration ``benchmark/configs/<config>.json``, its traffic
``benchmark/traffic/<mix>.json``) on this machine's card: set-up, then
``--seconds`` of the closed loop, then the check of the window's chunks
against the plain reference. Prints the check's numbers last on standard
error and one JSON line last on standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` (torch.profiler over the
window) its per-layer metrics, read by ``benchmark/metrics/<metric>.py``.
Exits nonzero, printing no result, without enough CUDA devices, without
the program, or where a module of JAX or of the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))   # the program, at the root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchlib.manifest import Manifest
    from benchlib.runner import loaded_forbidden, run_cell
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = result["checks"]
    print(f"check chunks_differing: {checks['chunks_differing']['value']} "
          f"(limit {checks['chunks_differing']['limit']}: at most)\n"
          f"check chunks_compared: {checks['chunks_compared']['value']} "
          f"(limit {checks['chunks_compared']['limit']}: at least)",
          file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
