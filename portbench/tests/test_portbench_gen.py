"""The generator's files against the port's simulator and indexer."""

import filecmp
import os

import numpy as np
import pytest

from portbench.gen import inputs, simulate as S

from bench_small import small_configs

SNVS = ((0.02, 20), (0.1, 20), (0.5, 20))


@pytest.mark.parametrize("genome_len,depth,seed",
                         [(20000, 50, 3), (60000, 20, 2 ** 31 + 7)])
def test_uniform_files_equal_simulate_fast_and_build_bai(tmp_path, genome_len,
                                                         depth, seed):
    from lofreq_tpu_torch.testing.simulate_fast import simulate_fast

    simulate_fast(str(tmp_path), genome_len=genome_len, depth=depth,
                  seed=seed, chrom="big1")
    reads = S.draw_uniform(seed, genome_len, depth, 100, SNVS, (28, 38))
    mine = tmp_path / "mine"
    S.write_sample(str(mine), "big1", reads, threads=3)
    for f in ("ref.fa", "reads.bam", "reads.bam.bai"):
        assert filecmp.cmp(tmp_path / f, mine / f, shallow=False), f


def test_amplicon_index_equals_build_bai(tmp_path):
    from lofreq_tpu_torch.io.bai import build_bai

    cfg = small_configs()["sarscov2-cohort"]
    reads = inputs.draw(cfg, 2 ** 32 + 5, 1)
    S.write_sample(str(tmp_path), "c", reads, threads=2)
    bam = str(tmp_path / "reads.bam")
    build_bai(bam, out_path=str(tmp_path / "port.bai"))
    assert filecmp.cmp(bam + ".bai", tmp_path / "port.bai", shallow=False)


def test_amplicon_reads_cover_one_end_of_an_amplicon():
    cfg = small_configs()["sarscov2-cohort"]
    a = cfg["amplicons"]
    reads = inputs.draw(cfg, 11, 0)
    amp = S.amplicon_starts(cfg["genome_length"], a["count"], a["length"],
                            a["flank"])
    rev = (reads["flags"] & 16) != 0
    assert np.isin(reads["starts"][~rev], amp).all()
    assert np.isin(reads["starts"][rev] + cfg["read_length"],
                   amp + a["length"]).all()
    assert np.all(np.diff(reads["starts"]) >= 0)
    # the samples share the genome; the ladder sets each sample's reads
    other = inputs.draw(cfg, 11, 1)
    assert np.array_equal(reads["genome"], other["genome"])
    assert len(other["starts"]) == (cfg["genome_length"]
                                    * cfg["samples"][1]["depth"]
                                    // cfg["read_length"])


def test_same_seed_same_inputs_and_covered_columns():
    cfg = small_configs()["ecoli-800x"]
    a, b = inputs.draw(cfg, 99, 0), inputs.draw(cfg, 99, 0)
    for k in ("genome", "starts", "seqs", "quals", "flags"):
        assert np.array_equal(a[k], b[k])
    assert inputs.covered_columns(np.array([0, 50, 400]), 100) == 250
    assert inputs.covered_columns(np.array([5]), 100) == 100


def test_prepare_reuses_the_newest_seed_only(tmp_path):
    cfg = small_configs()["ecoli-800x"]
    s1, t1, drawn1 = inputs.prepare(cfg, "e", 1, str(tmp_path))
    s2, _t2, drawn2 = inputs.prepare(cfg, "e", 1, str(tmp_path))
    assert drawn1 is not None and drawn2 is None and t1 > 0 and s1 == s2
    again = inputs.draw_all(cfg, 1)
    assert np.array_equal(again[0]["seqs"], drawn1[0]["seqs"])
    inputs.prepare(cfg, "e", 2, str(tmp_path))
    assert len(os.listdir(tmp_path / "e")) == 1
    assert not os.path.exists(s1[0]["bam"])


def test_cohort_seeds_make_the_same_work_in_another_order():
    cfg = small_configs()["sarscov2-cohort"]
    L = cfg["read_length"]

    def snv_depths(reads):
        st = reads["starts"]
        return sorted(int(np.searchsorted(st, p, side="right")
                          - np.searchsorted(st, p - L + 1))
                      for p, _alt, _af in reads["snvs"])

    a, b = inputs.draw(cfg, 1, 1), inputs.draw(cfg, 2, 1)
    assert snv_depths(a) == snv_depths(b)
    assert sorted(p for p, _a, _f in a["snvs"]) != \
        sorted(p for p, _a, _f in b["snvs"])
