"""BENCHMARK.json against the benchmark's contract, and the harness
finding each cell's files by name."""

import json
import os
import re

import pytest

from benchlib.manifest import BENCH_DIR, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    DATA = json.load(fh)


def test_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "benchmark/run.py"]
    assert DATA["paths"] == ["benchmark"]
    assert 1 <= DATA["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in DATA[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    for c in DATA["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in DATA["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in DATA[kind]}) == len(DATA[kind])
    metrics = [e["name"] for k in ("end_to_end", "per_layer")
               for e in DATA[k]]
    assert len(set(metrics)) == len(metrics)


def test_entry_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for e in DATA["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in DATA["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_enough():
    m = Manifest(DATA)
    e2e = {e["name"] for e in DATA["end_to_end"]}
    for w in DATA["workloads"]:
        mine = {e["name"] for e in m.metrics(w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = m.metrics(w["name"], True)
        assert layer
        for e in layer:
            assert e["moves"] in mine and e["moves"] in e2e


def test_files_are_found_by_name():
    m = Manifest(DATA)
    for c in DATA["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert m.config(c["name"])["name"] == c["name"]
    for w in DATA["workloads"]:
        assert m.traffic(w["traffic"])["name"] == w["traffic"]
    for e in DATA["end_to_end"] + DATA["per_layer"]:
        assert callable(m.reader(e["name"]))


def test_a_new_file_is_found_by_name(tmp_path):
    """A later cell adds files and edits none: a configuration, a traffic
    mix and a reader of its own are found under their names."""
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "new_cfg.json").write_text('{"name": "new_cfg"}')
    (tmp_path / "traffic" / "new-mix.json").write_text('{"name": "new-mix"}')
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(run):\n    return 4.5\n")
    data = dict(DATA, workloads=DATA["workloads"] + [
        {"name": "new_cfg.new-mix", "config": "new_cfg", "traffic":
         "new-mix", "chips": 1, "why": "a test"}])
    m = Manifest(data, str(tmp_path))
    cell = m.cell("new_cfg.new-mix")
    assert m.config(cell["config"]) == {"name": "new_cfg"}
    assert m.traffic(cell["traffic"]) == {"name": "new-mix"}
    assert m.reader("new_metric.x")(None) == 4.5


def test_layers_are_named_alike():
    layers = {e["layer"] for e in DATA["per_layer"]}
    for layer in layers:
        assert 1 <= len(layer) <= 200 and "\n" not in layer


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(BENCH_DIR,
                                                                "configs"))))
def test_config_files_state_their_guarantees(name):
    with open(os.path.join(BENCH_DIR, "configs", name)) as fh:
        c = json.load(fh)
    assert c["quality"] == 85 and c["motion"] and not c["bframes"]
    assert len(c["guarantees"]) == 3 and c["assumed"]
