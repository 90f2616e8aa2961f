"""Tiny cells for the CPU: the benchmark's own configurations and
traffic with small frames, a short range and a small pool. A cell on
several cards runs over a chunk mesh of the one CPU repeated."""

import json
import os

from benchlib.manifest import BENCH_DIR, ROOT, Manifest

TINY = {"width": 80, "height": 40, "chunk_frames": 4, "pool_chunks": 4,
        "chunks_per_dispatch": 2}
RANGE = {"full": 6, "hier": 10}


def tiny_manifest(tmp_path, **config) -> Manifest:
    """BENCHMARK.json's cells over shrunken copies of their files, the
    benchmark's readers and adapters beside them; ``config`` keys replace
    the tiny ones."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        data = json.load(fh)
    for kind in ("configs", "traffic"):
        (tmp_path / kind).mkdir()
        for name in os.listdir(os.path.join(BENCH_DIR, kind)):
            with open(os.path.join(BENCH_DIR, kind, name)) as fh:
                d = json.load(fh)
            if kind == "configs":
                d.update(TINY, search_range=RANGE[d["search"]])
                d.update(config)
            else:
                d["pan_per_1080_rows"] = [27, 108]   # (1, 4) at 40 rows
                d["object_size_per_1080_rows"] = [432, 432]   # 16 x 16
                d["object_speeds_per_1080_rows"] = [[27, 108], [54, 27]]
                cards = max(w["chips"] for w in data["workloads"]
                            if w["traffic"] == d["name"])
                if cards > 1:
                    # a dispatch over a mesh: the tiny configuration's on
                    # each of the cell's cards
                    d["chunks_per_dispatch"] = cards * config.get(
                        "chunks_per_dispatch", TINY["chunks_per_dispatch"])
            (tmp_path / kind / name).write_text(json.dumps(d))
    for kind in ("metrics", "systems"):
        os.symlink(os.path.join(BENCH_DIR, kind), tmp_path / kind)
    return Manifest(data, str(tmp_path))


CELLS = ["fvc1080_full64.pan-vod", "fvc2160_hier126.pan-vod",
         "fvc1080_full64.pan-stream", "fvc2160_hier126.pan-stream",
         "fvc1080_full64.pan-vod4"]
#: the cells that dispatch several chunks at once
BATCHED = [c for c in CELLS if "vod" in c]
#: the four-card cell
MESH_CELL = "fvc1080_full64.pan-vod4"
