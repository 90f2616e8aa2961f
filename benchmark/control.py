"""The check's control on the card, at a cell's own size: the plain
reference put in the program's place and computed in bfloat16, judged
as a run judges the program, on several seeds; beside it the float32
reference's time per chunk.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line per seed: the chunks compared, those that differ
from the float32 reference (the check's number; its limit is 0) and the
seconds of each reference."""

import argparse
import json
import os
import sys
import time

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from benchlib.manifest import Manifest
    from benchlib.runner import (batch_of, make_pool, pool_size, sample,
                                  validate)
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    batch, chips = batch_of(config, traffic), cell["chips"]
    system = validate(config, traffic, batch, chips, manifest)
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = make_pool(config, traffic, seed, dev, chips)
        keep = sample(seed, pool_size(config, chips),
                      traffic["sample_chunks"], batch)
        frames = {i: pool[i].clone() for i in keep}
        del pool
        differing, secs = 0, {"float32": 0.0, "bfloat16": 0.0}
        for i in keep:
            got = {}
            for name, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                t0 = time.perf_counter()
                got[name] = system.reference(config, frames[i], dtype)
                secs[name] += time.perf_counter() - t0
            differing += got["bfloat16"] != got["float32"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "chunks_compared": len(keep),
                          "chunks_differing": differing,
                          "ref_s_per_chunk": {k: v / len(keep)
                                              for k, v in secs.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
