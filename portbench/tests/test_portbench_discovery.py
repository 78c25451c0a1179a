"""Everything BENCHMARK.json names is found by name, and the file keeps
to the benchmark's contract."""

import importlib
import json
import os
import re

import pytest

from portbench import run as R

ROOT = R.ROOT
BENCH = R.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_configuration_and_traffic(cell):
    c, cfg, traffic = R.find_cell(BENCH, cell)
    assert c["chips"] == 1
    assert cfg["layout"] in ("uniform", "amplicon")
    assert "varcall" in traffic
    names = {m["name"] for m in R.metrics_of(BENCH, cell, False)}
    assert "setup_s" in names and "call_cols_per_s" in names
    assert R.metrics_of(BENCH, cell, True)


def test_a_traffic_key_that_nothing_reads_is_refused(tmp_path):
    from bench_small import bench_root

    root = bench_root(tmp_path)
    path = os.path.join(root, "portbench", "traffic", "call.json")
    with open(path) as fh:
        traffic = json.load(fh)
    with open(path, "w") as fh:
        json.dump(dict(traffic, clients=4), fh)
    with pytest.raises(ValueError, match="clients"):
        R.find_cell(R.load_benchmark(root), "ecoli-800x.call", root)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(R.metric_reader(metric))


@pytest.mark.parametrize("function", sorted(R.roofline_modules()))
def test_each_roofline_hooks_a_port_function(function):
    mod = R.roofline_modules()[function]
    target = importlib.import_module(mod.HOOK[0])
    assert callable(getattr(target, mod.HOOK[1]))
    launches = mod.launches()
    assert launches and all(k.endswith("_kernel") for k in launches)


def test_configurations_keep_their_files_and_reduced_keys():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert c["file"].startswith("portbench/")
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert c["source"] == cfg["source"]
        assert cfg["assumed"]


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert m["better"] in ("lower", "higher")
        assert 1 <= len(m["unit"]) <= 16 and " " not in m["unit"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    cells = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(cells) == len(set(cells))
