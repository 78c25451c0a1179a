"""Small configurations and a benchmark root around them, for the tests:
the cells' configurations with the genome, depth and SNVs cut to sizes a
CPU test holds."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def small_configs() -> dict:
    def load(name):
        with open(os.path.join(ROOT, "portbench", "configs", name)) as fh:
            return json.load(fh)

    e = load("ecoli-800x.json")
    e.update(genome_length=20000, samples=[{"depth": 100}],
             snvs=[[0.1, 3], [0.5, 3]])
    c = load("sarscov2-cohort.json")
    c.update(genome_length=5000, samples=[{"depth": 300}, {"depth": 600}],
             snvs=[[1.0, 5], [0.05, 2], [0.02, 2]])
    c["amplicons"] = dict(c["amplicons"], count=16)
    return {"ecoli-800x": e, "sarscov2-cohort": c}


# the cohort deployment, kept for a later cell (PERF.md's open
# questions), is driven through whole runs here all the same
COHORT_CONFIG = {"name": "sarscov2-cohort", "source": "test",
                 "file": "portbench/configs/sarscov2-cohort.json",
                 "reduced": [], "why": "test"}
COHORT_CELL = {"name": "sarscov2-cohort.call", "config": "sarscov2-cohort",
               "traffic": "call", "chips": 1, "why": "test"}


def bench_root(tmp) -> str:
    """A checkout-like root whose BENCHMARK.json names the small
    configurations, the cohort's cell among them; traffic, metrics and
    roofline files are the real ones."""
    root = str(tmp)
    os.makedirs(os.path.join(root, "portbench", "configs"), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "portbench", "traffic"),
                    os.path.join(root, "portbench", "traffic"),
                    dirs_exist_ok=True)
    for name, cfg in small_configs().items():
        with open(os.path.join(root, "portbench", "configs",
                               name + ".json"), "w") as fh:
            json.dump(cfg, fh)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    if COHORT_CELL["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["configs"].append(COHORT_CONFIG)
        bench["workloads"].append(COHORT_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root
