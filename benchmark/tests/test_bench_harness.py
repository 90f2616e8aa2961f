"""The harness end to end on the CPU at tiny sizes: every cell's run
through the program's CPU path judged by the reference, the result
line's shape, the check's verdict under planted faults, the refusal
without a card, and no module of JAX or of the JAX package loaded."""

import json
import os
import subprocess
import sys

import pytest

from bench_helpers import BATCHED, CELLS, MESH_CELL, tiny_manifest
from benchlib.runner import run_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(tmp_path, cell, traced):
    m = tiny_manifest(tmp_path)
    r = run_cell(m, cell, 2 ** 31 + 11, 0.3, traced, "cpu")
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["chunks_differing"] == {"value": 0, "limit": 0}
    assert r["checks"]["chunks_compared"]["value"] >= 1
    assert r["attempted"] >= 1
    names = {e["name"] for e in m.metrics(cell, traced)}
    # the CPU has no device trace: only host-clock metrics are read
    host = {e["name"] for e in m.metrics(cell, traced)
            if e["source"] == "host_clock"}
    assert host <= set(r["metrics"]) <= names
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["device"]["count"] == m.cell(cell)["chips"]
    assert r["device"]["memory_peak_bytes_per_card"] == [0]
    if traced:
        assert {"busy_s", "window_s", "busy_s_per_card"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(r)


def _code_plane_unchanged(monkeypatch):
    """A step that leaves its state unchanged: the in-loop reconstruction
    never takes the coded residual."""
    from flutpu_torch.codec import fvc
    real = fvc._code_plane

    def broken(resid, qtab, planar=False):
        coefs, rec = real(resid, qtab, planar)
        return coefs, rec * 0
    monkeypatch.setattr(fvc, "_code_plane", broken)


def _half_batch(monkeypatch):
    """Half of the batch left out: the first half of the chunks coded,
    their results standing in for the rest."""
    import torch
    from flutpu_torch.codec import fvc
    real = fvc.FvcEncoder._codec

    def broken(self, frames, mesh=None, spatial=False):
        c = frames.shape[0]
        half = real(self, frames[:max(1, c // 2)], mesh, spatial)
        return tuple(torch.cat([p] * 2)[:c] for p in half)
    monkeypatch.setattr(fvc.FvcEncoder, "_codec", broken)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: one byte of each chunk's
    last scan flipped in the container."""
    from flutpu_torch.codec import fvc
    real = fvc.FvcEncoder._build_chunk

    def broken(self, *a, **k):
        data = bytearray(real(self, *a, **k))
        data[-2] ^= 0x10
        return bytes(data)
    monkeypatch.setattr(fvc.FvcEncoder, "_build_chunk", broken)


def _exchange_left_out(monkeypatch):
    """The exchange between cards left out for one shard: the last
    card's block of the dispatch never reaches it, and it codes the
    first card's block in its place."""
    from flutpu_torch.parallel import gop
    real = gop.chunk_blocks

    def broken(c, mesh, spatial):
        blocks = real(c, mesh, spatial)
        return blocks[:-1] + [(blocks[0][0], blocks[-1][1])]
    monkeypatch.setattr(gop, "chunk_blocks", broken)


FAULTS = {"state_unchanged": (_code_plane_unchanged, CELLS),
          "half_batch": (_half_batch, BATCHED),
          "answer_altered": (_answer_altered, CELLS),
          "exchange_left_out": (_exchange_left_out, [MESH_CELL])}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cells)
                                        in FAULTS.items() for c in cells])
def test_fault_is_refused(tmp_path, monkeypatch, fault, cell):
    m = tiny_manifest(tmp_path)
    FAULTS[fault][0](monkeypatch)
    r = run_cell(m, cell, 77, 0.3, False, "cpu")
    assert r["correct"] is False
    assert r["checks"]["chunks_differing"]["value"] >= 1


#: seeds on which a uniform draw of two pool chunks keeps two of the
#: first half of a dispatch's positions (16 chunks, C = 8; and 8, C = 4)
FIRST_HALF_SEEDS = [2147483649, 2147483651, 2147483654]


@pytest.mark.parametrize("seed", FIRST_HALF_SEEDS)
@pytest.mark.parametrize("cell", CELLS[:2])
def test_half_batch_is_refused_at_the_cells_pool_and_batch(
        tmp_path, monkeypatch, cell, seed):
    """The cell's own pool and chunks a dispatch (tiny frames), on seeds
    where a draw blind to positions would judge only chunks that the
    fault codes."""
    import random
    from benchlib.manifest import Manifest
    real = Manifest().config(Manifest().cell(cell)["config"])
    pool, c = real["pool_chunks"], real["chunks_per_dispatch"]
    blind = random.Random(seed).sample(range(pool), 2)
    assert all(i % c < c // 2 for i in blind)
    m = tiny_manifest(tmp_path, pool_chunks=pool, chunks_per_dispatch=c,
                      chunk_frames=2)
    _half_batch(monkeypatch)
    r = run_cell(m, cell, seed, 0.0, False, "cpu")
    assert r["correct"] is False
    assert r["checks"]["chunks_differing"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_sample_takes_each_half_of_a_dispatch(cell):
    """At the cell's own pool and batch, on 2,000 large seeds: one judged
    chunk from each half of a dispatch's positions (C = 1: any two)."""
    from benchlib.manifest import Manifest
    from benchlib.runner import batch_of, pool_size, sample
    m = Manifest()
    config = m.config(m.cell(cell)["config"])
    traffic = m.traffic(m.cell(cell)["traffic"])
    c = batch_of(config, traffic)
    pool = pool_size(config, m.cell(cell)["chips"])
    seen = set()
    for seed in range(2 ** 31, 2 ** 31 + 2000):
        keep = sample(seed, pool, 2, c)
        assert len(set(keep)) == 2
        if c > 1:
            assert sorted(i % c < c // 2 for i in keep) == [False, True]
        seen.update(keep)
    assert seen == set(range(pool))


def test_the_four_card_sample_takes_one_chunk_a_card():
    """The four-card cell's own pool (its configuration's on each card)
    and batch, its own sample size, on 2,000 large seeds: one judged
    chunk from each card's block of a dispatch, every pool chunk judged
    on some seed."""
    from benchlib.manifest import Manifest
    from benchlib.runner import batch_of, pool_size, sample
    m = Manifest()
    cell = m.cell(MESH_CELL)
    config, traffic = m.config(cell["config"]), m.traffic(cell["traffic"])
    c, cards = batch_of(config, traffic), cell["chips"]
    pool = pool_size(config, cards)
    assert (c, cards, pool) == (32, 4, 64)
    assert traffic["sample_chunks"] == cards
    seen = set()
    for seed in range(2 ** 31, 2 ** 31 + 2000):
        keep = sample(seed, pool, traffic["sample_chunks"], c)
        assert sorted(i % c // (c // cards) for i in keep) == \
            list(range(cards))
        seen.update(keep)
    assert seen == set(range(pool))


@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 32 + 7, 3100211907])
def test_one_cards_fault_is_refused_at_the_cells_pool_and_batch(
        tmp_path, monkeypatch, seed, faulty):
    """The four-card cell's own pool, chunks a dispatch and sample over
    four CPU slots (tiny frames): a fault in the last card's block alone
    makes the check differ; without it the run is correct."""
    from benchlib.manifest import Manifest
    real = Manifest().config(Manifest().cell(MESH_CELL)["config"])
    m = tiny_manifest(tmp_path, pool_chunks=real["pool_chunks"],
                      chunks_per_dispatch=real["chunks_per_dispatch"],
                      chunk_frames=2)
    if faulty:
        _exchange_left_out(monkeypatch)
    r = run_cell(m, MESH_CELL, seed, 0.0, False, "cpu")
    assert r["checks"]["chunks_compared"]["value"] >= 4
    assert r["correct"] is not faulty
    assert (r["checks"]["chunks_differing"]["value"] >= 1) is faulty


@pytest.mark.parametrize("config,traffic,message", [
    ({"pool_chunks": 48}, {"chunks_per_dispatch": 6},
     "multiple of the cards"),
    ({"pool_chunks": 15}, {"chunks_per_dispatch": 30},
     "multiple of the cards"),
    ({}, {"entry": "chunk", "chunks_per_dispatch": 1}, "entry 'chunks'")])
def test_a_mesh_it_cannot_split_is_refused(config, traffic, message):
    """A four-card cell whose dispatch does not split evenly over its
    cards (its pool a whole number of dispatches), or goes through the
    one-chunk entry, raises before any work; the cell as it stands
    passes."""
    from benchlib.manifest import Manifest
    from benchlib.runner import batch_of, validate
    m = Manifest()
    cell = m.cell(MESH_CELL)
    real, mix = m.config(cell["config"]), m.traffic(cell["traffic"])
    validate(real, mix, batch_of(real, mix), 4)
    config, mix = dict(real, **config), dict(mix, **traffic)
    with pytest.raises(ValueError, match=message):
        validate(config, mix, batch_of(config, mix), 4)


@pytest.mark.parametrize("where,key,value", [
    ("configs", "bframes", 1), ("configs", "subpel", True),
    ("configs", "chroma", "4:4:4"), ("configs", "version", 1),
    ("configs", "planar", True), ("traffic", "loop", "open"),
    ("configs", "pool_chunks", 3)])
def test_unread_settings_are_refused(tmp_path, where, key, value):
    """A file that states a setting the harness would not run raises
    before any work, where it would otherwise run the default."""
    m = tiny_manifest(tmp_path)
    for path in (tmp_path / where).iterdir():
        d = json.loads(path.read_text())
        d[key] = value
        path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match=key if key != "pool_chunks"
                       else "multiple"):
        run_cell(m, CELLS[0], 3, 0.0, False, "cpu")


def test_no_jax_after_a_run(tmp_path):
    """In a process of its own: a run's modules hold no top-level jax,
    jaxlib, flax or flutpu (flutpu_torch is another name)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import pathlib, bench_helpers\n"
        "from benchlib.runner import run_cell, loaded_forbidden\n"
        "m = bench_helpers.tiny_manifest(pathlib.Path(%r))\n"
        "run_cell(m, 'fvc1080_full64.pan-stream', 5, 0.2, False, 'cpu')\n"
        "assert 'flutpu_torch' in sys.modules\n"
        "print(loaded_forbidden())\n" % (os.path.dirname(__file__), BENCH,
                                         str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(card_absent):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_a_short_window_still_covers_the_pool(tmp_path):
    """However short ``--seconds``, the window dispatches every pool chunk
    once, so the sampled chunks are always judged."""
    m = tiny_manifest(tmp_path)
    r = run_cell(m, CELLS[2], 9, 0.0, False, "cpu")
    assert r["attempted"] >= 4 and r["correct"] is True
