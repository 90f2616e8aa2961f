"""A configuration joins the harness through files of its own: a second
system written as new files alone into a fresh benchmark directory runs
and is judged; a configuration without an adapter is refused; the pool
lies where the traffic says, and the loop runs on the cell's cards; and
the harness's own files name no codec."""

import json
import os

import pytest

from bench_helpers import CELLS, MESH_CELL, tiny_manifest
from benchlib import runner
from benchlib.manifest import BENCH_DIR, Manifest

#: a second system: the port's JPEG encoder, one chunk a GOP, judged
#: against a per-frame encode (the test checks the harness, not the
#: codec)
JPEG_ADAPTER = '''
"""The port's JPEG encoder, one chunk a GOP: each chunk's frames as
JFIF bytestreams, against an encode of each frame alone."""

KEYS = {"quality", "engine"}
MESH_ENTRIES = ()


def check(config, traffic, batch):
    if traffic["entry"] != "gops":
        raise ValueError(f"entry {traffic['entry']!r}: this adapter's is "
                         "'gops'")


def make(config, device):
    from flutpu_torch.codec.jpeg import JpegEncoder
    return JpegEncoder(config["quality"], engine=config["engine"],
                       device=device)


def entries(enc, entry):
    def dispatch(frames):
        return [enc.encode_gop_dispatch(f.to(enc.device), f.shape[1],
                                        f.shape[2]) for f in frames]

    def finalize(handles):
        return [enc.encode_gop_finalize(h) for h in handles]
    return dispatch, finalize


def reference(config, frames, dtype=None):
    from flutpu_torch.codec.jpeg import JpegEncoder
    enc = JpegEncoder(config["quality"], device=frames.device)
    return [enc.encode_gop(f[None])[0] for f in frames]
'''
CELL = "jpeg_tiny.gop-vod"


def jpeg_manifest(bench_dir, pool="host", width=80, height=40,
                  frames=4) -> Manifest:
    """A benchmark directory holding only the second system's files
    (a configuration, a traffic mix, its adapter) and the benchmark's
    readers, with a manifest of its one cell."""
    for kind in ("configs", "traffic", "systems"):
        os.makedirs(os.path.join(bench_dir, kind))
    os.symlink(os.path.join(BENCH_DIR, "metrics"),
               os.path.join(bench_dir, "metrics"))
    config = {"name": "jpeg_tiny", "adapter": "jpeg_gop", "width": width,
              "height": height, "chunk_frames": frames,
              "chunks_per_dispatch": 2, "pool_chunks": 4, "quality": 85,
              "engine": "device"}
    traffic = {"name": "gop-vod", "frames": "pan", "texture_box_passes": 2,
               "pan_per_1080_rows": [27, 108],
               "object_size_per_1080_rows": [432, 432],
               "object_speeds_per_1080_rows": [[27, 108]],
               "noise_sigma": 1.0, "entry": "gops",
               "chunks_per_dispatch": None, "in_flight": 2,
               "sample_chunks": 2, "pool": pool}
    for kind, d in (("configs", config), ("traffic", traffic)):
        with open(os.path.join(bench_dir, kind, d["name"] + ".json"),
                  "w") as fh:
            json.dump(d, fh)
    with open(os.path.join(bench_dir, "systems", "jpeg_gop.py"), "w") as fh:
        fh.write(JPEG_ADAPTER)
    data = {"configs": [{"name": "jpeg_tiny"}],
            "workloads": [{"name": CELL, "config": "jpeg_tiny",
                           "traffic": "gop-vod", "chips": 1}],
            "end_to_end": [
                {"name": "vod_frames_per_s", "unit": "frames/s"},
                {"name": "setup_s", "unit": "s"}],
            "per_layer": [
                {"name": "finalize_ms_per_chunk.vod", "unit": "ms"},
                {"name": "device_idle_share.vod", "unit": "%"}]}
    return Manifest(data, str(bench_dir))


def _altered(monkeypatch):
    """An answer altered where it is produced: one byte of every frame of
    a GOP of several frames flipped (the reference codes frames alone)."""
    from flutpu_torch.codec.jpeg import JpegEncoder
    real = JpegEncoder.encode_gop_finalize

    def broken(self, handle):
        out = real(self, handle)
        if len(out) < 2:
            return out
        return [b[:-3] + bytes([b[-3] ^ 0x10]) + b[-2:] for b in out]
    monkeypatch.setattr(JpegEncoder, "encode_gop_finalize", broken)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("altered", [False, True])
def test_a_second_system_joins_by_new_files(tmp_path, monkeypatch, altered,
                                            traced):
    m = jpeg_manifest(tmp_path / "bench")
    assert sorted(os.listdir(tmp_path / "bench" / "systems")) == \
        ["jpeg_gop.py"]
    if altered:
        _altered(monkeypatch)
    r = runner.run_cell(m, CELL, 2 ** 31 + 41, 0.2, traced, "cpu")
    assert r["correct"] is not altered
    assert r["checks"]["chunks_compared"]["value"] >= 2
    assert (r["checks"]["chunks_differing"]["value"] >= 1) is altered
    assert r["attempted"] >= 4
    assert set(r["metrics"]) >= ({"finalize_ms_per_chunk.vod"} if traced
                                 else {"vod_frames_per_s", "setup_s"})
    assert r["device"]["count"] == 1


@pytest.mark.cuda
def test_a_second_system_on_the_card_from_host_memory(tmp_path, card):
    """The second system on one card at 1080p, its pool in host memory:
    every dispatch uploads its frames, the run reads the card's peak and
    is correct."""
    m = jpeg_manifest(tmp_path / "bench", "host", 1920, 1080, 8)
    run, loop, pool, keep = runner.prepare(m, CELL, 3100223001, "cuda")
    assert pool.device.type == "cpu" and loop.cards == [card]
    del run, loop, pool
    r = runner.run_cell(m, CELL, 3100223001, 2.0, False, "cuda")
    print(json.dumps({k: r[k] for k in ("correct", "attempted", "metrics",
                                        "device", "checks")}))
    assert r["correct"] is True, r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0
    assert r["device"]["kind"].startswith("NVIDIA")


@pytest.mark.parametrize("adapter,message", [
    (None, "names no adapter"), ("h264", "systems/h264.py")])
def test_a_configuration_without_its_adapter_is_refused(tmp_path, adapter,
                                                        message):
    m = tiny_manifest(tmp_path)
    for path in (tmp_path / "configs").iterdir():
        d = json.loads(path.read_text())
        del d["adapter"]
        if adapter:
            d["adapter"] = adapter
        path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match=message):
        runner.run_cell(m, CELLS[0], 3, 0.0, False, "cpu")
    cell = m.cell(CELLS[0])
    config, mix = m.config(cell["config"]), m.traffic(cell["traffic"])
    with pytest.raises(ValueError, match=message):
        runner.validate(config, mix, runner.batch_of(config, mix), 1, m)


def test_the_benchmarks_configurations_name_their_adapter():
    m = Manifest()
    for c in m.data["configs"]:
        config = m.config(c["name"])
        assert config["adapter"] == "fvc"
        assert m.system(config).MESH_ENTRIES == ("chunks",)


@pytest.mark.parametrize("pool,chips,host", [
    (None, 1, False), (None, 4, True), ("host", 1, True),
    ("device", 1, False), ("device", 4, False), ("host", 4, True)])
def test_the_pool_lies_where_the_traffic_says(pool, chips, host):
    traffic = {} if pool is None else {"pool": pool}
    assert runner.pool_on_host(traffic, chips) is host


def test_an_unknown_pool_place_is_refused(tmp_path):
    m = tiny_manifest(tmp_path)
    path = tmp_path / "traffic" / "pan-vod.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    pool="pinned")))
    with pytest.raises(ValueError, match="pinned"):
        runner.run_cell(m, CELLS[0], 3, 0.0, False, "cpu")


@pytest.mark.parametrize("pool", [None, "host", "device"])
@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2], MESH_CELL])
def test_the_loop_runs_on_the_cells_cards(tmp_path, monkeypatch, cell,
                                          pool):
    """The pool moves to host memory exactly where ``pool_on_host`` says
    (seen as its ``.cpu()``: on the CPU both places are one), and the
    loop's cards are the cell's (``mesh_devices``), not the pool's."""
    import torch
    m = tiny_manifest(tmp_path)
    traffic = m.cell(cell)["traffic"]
    if pool:
        path = tmp_path / "traffic" / (traffic + ".json")
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        pool=pool)))
    moved, real = [], torch.Tensor.cpu

    def cpu(self, *a, **k):
        moved.append(tuple(self.shape))
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    run, loop, pool_t, keep = runner.prepare(m, cell, 5, "cpu")
    chips = m.cell(cell)["chips"]
    assert (tuple(pool_t.shape) in moved) is runner.pool_on_host(
        m.traffic(traffic), chips)
    assert loop.cards == list(dict.fromkeys(runner.mesh_devices(
        torch.device("cpu"), chips))) == [torch.device("cpu")]
    assert run.cards == [0] and run.shards == chips


@pytest.mark.parametrize("name", ["benchlib/runner.py", "benchlib/loop.py",
                                  "control.py", "program_spans.py"])
def test_the_harness_names_no_codec(name):
    """The runner, the loop, the control and the span report reach the
    program and its reference only through the adapter: they import no
    codec of the program and no plain reference."""
    import ast
    with open(os.path.join(BENCH_DIR, name)) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] + [a.name for a in node.names]
        else:
            continue
        for m in mods:
            assert "codec" not in m and not m.split(".")[-1].startswith(
                "ref_"), (name, m)
