"""Where the program's dispatch and finalize spend the host's time, read
from the program's own spans in one traced run of a cell.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \
        --seconds <s>

from the root of a checkout, on a machine with the cell's card. Runs the
cell as ``benchmark/run.py --trace 1`` does (set-up, the closed loop
under torch.profiler for ``--seconds`` (``trace.profiled``: the
device's operations, the benchmark's ``bench.*`` spans and the
program's ``flu.*`` spans, which ``benchlib/program.py`` reads), the
check against the plain reference).
Prints on standard error the program's ms per dispatch by span, the
device's idle seconds by the innermost program span open, and the shares
of ``bench.dispatch`` and ``bench.finalize`` that the spans account for;
last on standard output one JSON line with those numbers, the
reductions of ``benchlib/program.py``, the cell's per-layer metrics as
``run.py --trace 1`` reads them, the window's frames/s, the check's
verdict and the device. Exits nonzero without a CUDA device."""

import argparse
import json
import os
import sys
import time

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the reductions of ``benchlib/program.py`` reported per run
REDUCTIONS = ("redispatches_per_dispatch", "fetch_wait_ms_per_chunk",
              "redispatch_ms_per_chunk", "finalize_host_ms_per_chunk",
              "codec_enqueue_ms_per_chunk")


def traced_run(manifest, name: str, seed: int, seconds: float, device):
    """One traced run of cell ``name`` → (``runner.Run`` whose ``trace``
    holds ``program``, whether the kept chunks equal the reference's)."""
    from benchlib import runner
    run, loop, pool, keep = runner.prepare(manifest, name, seed, device)
    cards = loop.cards
    runner.measure(run, loop, seconds, True)
    frames = {i: pool[i].to(device, copy=True) for i in keep}
    del loop, pool
    runner.free(cards)
    want = {i: run.system.reference(run.config, frames[i]) for i in keep}
    outs = [(i, data) for i, kept in run.records["kept"].items()
            for data in kept]
    return run, bool(outs) and all(data == want[i] for i, data in outs)


def report(manifest, run, correct: bool) -> dict:
    """The run's numbers: the JSON line's dict."""
    from benchlib import program
    per_layer = {}
    for m in manifest.metrics(run.cell["name"], True):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            per_layer[m["name"]] = value
    idle = program.idle_by_span(run) or {}
    return {"workload": run.cell["name"], "correct": correct,
            "frames_per_s": run.records["frames"] / run.window_s,
            "chunks": run.records["chunks"],
            "dispatches": len(run.records["dispatches"]),
            "program": {k: getattr(program, k)(run) for k in REDUCTIONS},
            "coverage": program.coverage(run),
            "ms_per_dispatch": program.ms_per_dispatch(run),
            "idle_s_by_span": {k: v / 1e9 for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])},
            "per_layer": per_layer,
            "other_cuda_activities": run.trace["other"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from benchlib.manifest import Manifest
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest()
    t0 = time.perf_counter()
    run, correct = traced_run(manifest, args.workload, args.seed,
                              args.seconds, "cuda")
    out = report(manifest, run, correct)
    out.update(seed=args.seed, seconds=time.perf_counter() - t0,
               device=torch.cuda.get_device_name(0))
    print("program ms per dispatch: " + ", ".join(
        f"{k} {v:.3f}"
        for k, v in sorted((out["ms_per_dispatch"] or {}).items())),
        file=sys.stderr)
    print("device idle s by program span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["idle_s_by_span"].items()),
        file=sys.stderr)
    print("spans over the calls: " + ", ".join(
        f"{k} {v}" for k, v in (out["coverage"] or {}).items()),
        file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
