"""A configuration's samples: drawn from the seed, written as FASTA, BAM
and BAI, and kept in one fixed directory of the checkout for the newest
seed only.

The directory is portbench/.cache/inputs/<config>/<key>/, key = a hash of
the configuration and of the generator's source, and the seed.  A
finished entry holds meta.json; an unfinished one is named <key>.partial
and is thrown away on the next run.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import simulate as S

GENOME_STREAM = 1 << 20      # the cohort genome's seed stream


def sample_seed(seed: int, j: int, n_samples: int):
    """The seed of sample j: the run's seed itself for a lone sample (the
    bench.py draws), else (seed, j)."""
    return seed if n_samples == 1 else [seed, j]


def draw(cfg: dict, seed: int, j: int) -> dict:
    """Sample j's genome, reads, quals, strands and planted SNVs."""
    n = len(cfg["samples"])
    depth = cfg["samples"][j]["depth"]
    snvs = tuple(tuple(x) for x in cfg["snvs"])
    qr = tuple(cfg["qual_range"])
    if cfg["layout"] == "uniform":
        return S.draw_uniform(sample_seed(seed, j, n), cfg["genome_length"],
                              depth, cfg["read_length"], snvs, qr)
    if cfg["layout"] == "amplicon":
        a = cfg["amplicons"]
        return S.draw_amplicon(sample_seed(seed, j, n), [seed, GENOME_STREAM],
                               cfg["genome_length"], depth,
                               cfg["read_length"], snvs, qr, a["count"],
                               a["length"], a["flank"], a["share_sigma"])
    raise ValueError(f"unknown layout {cfg['layout']!r}")


def covered_columns(starts, read_len: int) -> int:
    """Reference positions under at least one read (reads sorted)."""
    starts = np.asarray(starts, np.int64)
    if not len(starts):
        return 0
    step = np.minimum(np.diff(starts), read_len)
    return int(step.sum()) + read_len


def key(cfg: dict, seed: int) -> str:
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for mod in (S.__file__, __file__):
        with open(mod, "rb") as fh:
            h.update(fh.read())
    return f"{h.hexdigest()[:16]}-{seed}"


def prepare(cfg: dict, config: str, seed: int, cache_root: str,
            threads: int = None):
    """([{fa, bam, cols}] per sample, seconds spent making them or 0.0,
    the drawn samples or None where the files were reused)."""
    base = os.path.join(cache_root, config)
    k = key(cfg, seed)
    done = os.path.join(base, k)
    meta_path = os.path.join(done, "meta.json")

    def paths(cols):
        return [dict(fa=os.path.join(done, f"s{j}", "ref.fa"),
                     bam=os.path.join(done, f"s{j}", "reads.bam"),
                     cols=c) for j, c in enumerate(cols)]

    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            return paths(json.load(fh)["cols"]), 0.0, None
    t0 = time.perf_counter()
    if os.path.isdir(base):
        shutil.rmtree(base)                 # only the newest seed is kept
    part = done + ".partial"
    os.makedirs(part)
    n = len(cfg["samples"])
    threads = threads or os.cpu_count() or 1

    def make(j):
        reads = draw(cfg, seed, j)
        d = os.path.join(part, f"s{j}")
        S.write_sample(d, cfg["chrom"], reads, level=cfg["bgzf_level"],
                       threads=max(1, threads // n))
        return reads

    with ThreadPoolExecutor(min(n, threads)) as ex:
        drawn = list(ex.map(make, range(n)))
    cols = [covered_columns(r["starts"], cfg["read_length"]) for r in drawn]
    with open(os.path.join(part, "meta.json"), "w") as fh:
        json.dump({"seed": seed, "cols": cols}, fh)
    os.rename(part, done)
    return paths(cols), time.perf_counter() - t0, drawn


def draw_all(cfg: dict, seed: int, threads: int = None) -> list:
    """Every sample of the configuration, drawn on several threads."""
    n = len(cfg["samples"])
    with ThreadPoolExecutor(min(n, threads or os.cpu_count() or 1)) as ex:
        return list(ex.map(lambda j: draw(cfg, seed, j), range(n)))
