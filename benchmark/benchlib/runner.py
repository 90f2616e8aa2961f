"""One run of one cell: set-up (the program, the pool, a warm pass), the
measured window (optionally traced), the check against the plain
reference once the window has closed, and the result line."""

from __future__ import annotations

import random
import sys
import time
from collections import Counter

from . import readers, roofline, trace
from .loop import ClosedLoop
from .manifest import Manifest
from .source import SOURCES

#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "flutpu")


class Run:
    """What a metric's reader reads: the cell, its configuration and
    traffic, the window's records (``records``: see ``ClosedLoop.run``),
    ``setup_s``, ``window_s``, ``batch``, ``shards`` (the chunk mesh's
    shards, over which a dispatch's C chunks split; 1 without a mesh),
    ``cards`` (the device indices of the cards the run uses), ``system``
    (the configuration's adapter, ``systems/<adapter>.py``), and in a
    traced run ``trace`` ({"device", "spans", "program"}: see
    ``trace.profiled``) with ``window_ns``."""

    def __init__(self, cell, config, traffic, batch, shards=1, cards=(0,)):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.batch, self.shards, self.cards = batch, shards, list(cards)
        self.records = self.system = None
        self.setup_s = self.window_s = None
        self.trace = None
        self.window_ns = None

    @property
    def coded(self):
        """The coded (rows, columns): whole 16x16 macroblocks."""
        return tuple(-(-self.config[k] // roofline.MB) * roofline.MB
                     for k in ("height", "width"))


def loaded_forbidden():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``flutpu_torch`` is not ``flutpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


#: keys a configuration file may hold beside its adapter's ``KEYS``: what
#: the harness reads, and the description beside it
CONFIG_KEYS = {"name", "source", "deployment", "system", "adapter", "width",
               "height", "chunk_frames", "chunks_per_dispatch",
               "pool_chunks", "precision", "guarantees", "documented",
               "assumed"}
TRAFFIC_KEYS = {"name", "frames", "content", "texture_box_passes",
                "pan_per_1080_rows", "object_size_per_1080_rows",
                "object_speeds_per_1080_rows", "noise_sigma", "entry",
                "chunks_per_dispatch", "in_flight", "sample_chunks", "pool",
                "assumed", "about"}
#: where a traffic's ``pool`` may lie
POOL_PLACES = ("device", "host")


def validate(config: dict, traffic: dict, batch: int, chips: int = 1,
             manifest: Manifest = None):
    """Refuse a configuration or traffic that states what this harness
    would not run: a configuration without an adapter
    (``manifest.system``; default: the benchmark's own ``systems/``), an
    unknown key, what the adapter's ``check`` refuses, a pool that is no
    whole number of dispatches, or a cell on several cards whose dispatch
    does not split evenly over them. Returns the adapter."""
    system = (manifest or Manifest({})).system(config)
    for what, d, keys in (("configuration", config,
                           CONFIG_KEYS | system.KEYS),
                          ("traffic", traffic, TRAFFIC_KEYS)):
        unknown = sorted(set(d) - keys)
        if unknown:
            raise ValueError(f"{what} {d.get('name')!r}: keys {unknown} "
                             "are not read by the harness")
    if traffic.get("pool", "device") not in POOL_PLACES:
        raise ValueError(f"traffic {traffic['name']!r}: pool "
                         f"{traffic['pool']!r}, not one of {POOL_PLACES}")
    system.check(config, traffic, batch)
    if pool_size(config, chips) % batch:
        raise ValueError("pool_chunks must be a multiple of the chunks a "
                         "dispatch, so each pool chunk keeps its position")
    if chips > 1 and (traffic["entry"] not in system.MESH_ENTRIES
                      or batch % chips):
        entries = " or ".join(map(repr, system.MESH_ENTRIES)) or "none"
        raise ValueError(f"a cell on {chips} cards dispatches through "
                         f"entry {entries}, its chunks a dispatch a "
                         "multiple of the cards")
    return system


def batch_of(config: dict, traffic: dict) -> int:
    """Chunks a dispatch: the traffic's, else the configuration's."""
    return traffic["chunks_per_dispatch"] or config["chunks_per_dispatch"]


def pool_size(config: dict, chips: int) -> int:
    """Pool chunks: the configuration's for each of the cell's cards."""
    return config["pool_chunks"] * chips


def pool_on_host(traffic: dict, chips: int) -> bool:
    """Whether the pool lies in (pageable) host memory: the traffic's
    ``pool``; without one, on a cell of several cards, as ``cudahype``
    keeps a batch that a mesh of several cards codes, and otherwise on
    the device."""
    return traffic.get("pool", "host" if chips > 1 else "device") == "host"


def mesh_devices(dev, chips: int):
    """The devices of a cell's chunk mesh: cards 0 .. chips - 1 (the CPU
    stands in for each card)."""
    import torch
    return [torch.device("cuda", i) if dev.type == "cuda" else dev
            for i in range(chips)]


def sample(seed: int, pool: int, n: int, batch: int = 1):
    """The pool chunks whose outputs the reference checks, drawn from the
    seed: one from each of ``n`` strata of positions in a dispatch (pool
    chunk i sits at position i % batch), so a fault confined to part of
    the batch falls on one of them."""
    rng = random.Random(seed)
    strata = [[i for i in range(pool) if (i % batch) * n // batch == k]
              for k in range(n)]
    strata = [s for s in strata if s]
    keep = []
    for k in range(min(n, pool)):
        keep.append(rng.choice([i for i in strata[k % len(strata)]
                                if i not in keep]))
    return sorted(keep)


def make_pool(config: dict, traffic: dict, seed: int, device,
              chips: int = 1):
    h, w = config["height"], config["width"]

    def scale(v):
        return [s * h // 1080 for s in v]
    return SOURCES[traffic["frames"]](
        pool_size(config, chips), config["chunk_frames"], h, w,
        scale(traffic["pan_per_1080_rows"]), traffic["texture_box_passes"],
        seed, device, scale(traffic["object_size_per_1080_rows"]),
        [scale(v) for v in traffic["object_speeds_per_1080_rows"]],
        traffic["noise_sigma"])


def _synchronize(cards):
    import torch
    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def prepare(manifest, name: str, seed: int, device, marks=None):
    """Cell ``name``'s set-up: the pool made from the seed on ``device``
    and then kept in host memory where ``pool_on_host`` says so (on
    several cards, so that the program's mesh entry uploads each shard's
    block to its own card), the program that the configuration's adapter
    makes there, the chunks the check samples and the closed loop over
    the adapter's entries and the cell's cards (``mesh_devices``; a cell
    on several chips dispatches over a ``ChunkMesh`` of them), which has
    made one warm pass over the pool with every card then synchronized.
    ``marks`` gets (step, ``perf_counter``) after each step. Returns (the
    ``Run``, the loop, the pool, the sampled pool chunks)."""
    import torch
    marks = [] if marks is None else marks
    cell = manifest.cell(name)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    batch = batch_of(config, traffic)
    chips = cell["chips"]
    system = validate(config, traffic, batch, chips, manifest)
    dev = torch.device(device)
    devices = mesh_devices(dev, chips)
    cards = list(dict.fromkeys(devices))
    mesh = None
    if chips > 1:
        from flutpu_torch.parallel.mesh import ChunkMesh
        mesh = ChunkMesh(devices)
    n_pool = pool_size(config, chips)

    marks.append(("start to here", time.perf_counter()))
    pool = make_pool(config, traffic, seed, dev, chips)
    _synchronize([dev])
    if pool_on_host(traffic, chips):
        pool = pool.cpu()
    marks.append(("pool", time.perf_counter()))
    program = system.make(config, dev)
    marks.append(("program", time.perf_counter()))
    keep = sample(seed, n_pool, traffic["sample_chunks"], batch)
    loop = ClosedLoop(system.entries(program, traffic["entry"]), pool,
                      batch, traffic["in_flight"], cards, keep, mesh)
    # warm: every pool chunk once, in the window's loop shape (the
    # program's buffer sizes adapt to them)
    loop.run(dispatches=max(-(-n_pool // batch), traffic["in_flight"] + 1))
    _synchronize(cards)
    marks.append(("warm pass", time.perf_counter()))
    run = Run(cell, config, traffic, batch, mesh.size if mesh else 1,
              [d.index or 0 for d in cards])
    run.system = system
    return run, loop, pool, keep


def free(cards):
    """Release the cached memory of every card (the program's state
    already dropped), before the reference runs."""
    import torch
    for d in cards:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()


def measure(run, loop, seconds: float, traced: bool) -> dict:
    """The window: ``loop`` for ``seconds``, with ``traced`` under
    ``trace.profiled`` (``run.trace``, ``run.window_ns``: the
    ``bench.window`` span). Sets ``run.records`` and ``run.window_s``
    and returns the records."""
    if traced:
        from torch.profiler import record_function
        loop.traced = True
        run.trace = {}
        with trace.profiled(run.trace):
            with record_function(trace.SPAN + "window"):
                run.records = loop.run(seconds=seconds)
            t_read = time.perf_counter()
        per_card = Counter(e[3] for e in run.trace["device"])
        print(f"trace: {len(run.trace['device'])} device operations (by "
              f"card {dict(sorted(per_card.items()))}), read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        win = [s for s in run.trace["spans"] if s[0] == "window"]
        run.window_ns = (win[0][1], win[0][2]) if win else None
    else:
        run.records = loop.run(seconds=seconds)
    run.window_s = (run.records["t1"] - run.records["t0"]) / 1e9
    return run.records


def run_cell(manifest, name: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float = None):
    """Run cell ``name`` → the result dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, [``breakdown``], ``checks``)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    marks = []
    run, loop, pool, keep = prepare(manifest, name, seed, device, marks)
    config, chips, cards = run.config, run.cell["chips"], loop.cards
    dev = torch.device(device)
    run.setup_s = marks[-1][1] - t_start
    print("set-up s: " + ", ".join(
        f"{k} {b - a:.3f}" for (k, b), (_, a)
        in zip(marks, [("", t_start)] + marks[:-1])), file=sys.stderr)

    records = measure(run, loop, seconds, traced)
    spans = {k: sum(d.get(k, 0) for d in records["dispatches"])
             / len(records["dispatches"]) / 1e6
             for k in ("source", "dispatch", "wait", "finalize")}
    print("host ms per dispatch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items())
        + f"; {records['chunks']} chunks in {run.window_s:.3f} s"
        + (f"; other CUDA activities {run.trace['other']}" if traced else ""),
        file=sys.stderr)
    peaks = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
             for d in cards]

    # the check: the program's state freed on every card, the reference
    # on the kept pool chunks' frames
    frames = {i: pool[i].to(dev, copy=True) for i in keep}
    del loop, pool
    free(cards)
    t_ref = time.perf_counter()
    want = {i: run.system.reference(config, frames[i]) for i in keep}
    print(f"reference: {len(keep)} chunk(s) in "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    compared = differing = 0
    for i, outs in records["kept"].items():
        for data in outs:
            compared += 1
            differing += data != want[i]
    print("reference chunk bytes: " + ", ".join(
        f"pool {i}: {len(want[i])}" for i in keep), file=sys.stderr)
    checks = {"chunks_differing": {"value": differing, "limit": 0},
              "chunks_compared": {"value": compared, "limit": 1}}
    correct = differing == 0 and compared >= 1

    metrics = {}
    for m in manifest.metrics(name, traced):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": max(peaks),
            "memory_peak_bytes_per_card": peaks}
    result = {"correct": bool(correct), "attempted": records["chunks"],
              "failed": differing, "metrics": metrics, "device": info}
    if traced and run.window_ns is not None:
        lo, hi = run.window_ns
        dev_ev = readers.window_device(run)
        busy = [b / 1e9 for b in readers.card_busy_ns(run)
                or [0] * len(run.cards)]
        info["busy_s"] = sum(busy) / len(busy)
        info["busy_s_per_card"] = busy
        info["window_s"] = (hi - lo) / 1e9
        ops = sorted(trace.device_ops(dev_ev).items(), key=lambda kv: -kv[1])
        gaps = sorted(trace.idle_gaps(dev_ev, run.trace["spans"],
                                      run.window_ns, run.cards).items(),
                      key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[k, v / 1e9] for k, v in ops[:10]],
            "idle_gaps": [[k, v / 1e9] for k, v in gaps[:10]]}
    result["checks"] = checks
    return result
