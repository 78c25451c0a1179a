"""The port's device Viterbi (lofreq_tpu_torch/ops/viterbi_torch.py) with
device="cpu", against the JAX reference viterbi_batch_jax and the C
realigner viterbi_align, on the 109 cases of tests/golden/viterbi.json.

Both device programs run in f32, so a path may differ from the other's,
or from the C realigner's, only where the two paths score the same: an
f32 tie.  path_score scores a path in f64 under the realigner's HMM; two
paths tie when their scores agree within TIE_ULPS f32 ulps.  Every
difference seen is listed below and must be such a tie.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from lofreq_tpu.ops.viterbi import viterbi_align as ref_viterbi_align
from lofreq_tpu.ops.viterbi_jax import viterbi_batch_jax
from lofreq_tpu_torch.ops import viterbi_torch
from lofreq_tpu_torch.ops.viterbi import viterbi_align
from lofreq_tpu_torch.ops.viterbi_torch import viterbi_batch

torch.set_num_threads(1)  # the test workers share the cores

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "viterbi.json")
with open(GOLDEN) as fh:
    CASES = json.load(fh)
TIE_ULPS = 4
# golden cases whose torch path differs from JAX's (55: the deletion at
# query offset 26 against 29; the f64 scores differ by 3e-15)
TIES_VS_JAX = {55}
# golden cases whose torch path differs from the C realigner's (37: the
# 4 bp deletion two places apart; 68: the same states from ref offset 22
# against 0, a repeat of the window)
TIES_VS_C = {37, 68}
ALPHA, BETA = viterbi_torch.ALPHA, viterbi_torch.BETA
CODE = {ord(c): i for i, c in enumerate("ACGT")}


def _inputs(c):
    bq = np.frombuffer(c["bqual"].encode("latin-1"), np.uint8) - 33
    return ([c["ref"].encode()], [c["query"].encode()], [bq], [c["q2def"]])


def path_score(ref, query, bq, q2d, shift, aln):
    """log10 probability (f64) of the path `aln` from ref offset `shift`
    under the realigner's HMM (viterbi.c:99-220): its transitions, and
    the match, mismatch and insert emissions."""
    rlen = len(ref) + 1
    g = 1.0 / (2 * rlen)
    tp = {"MM": (1 - 2 * ALPHA) * (1 - g), "MI": ALPHA * (1 - g),
          "MD": ALPHA * (1 - g), "IM": (1 - BETA) * (1 - g),
          "II": BETA * (1 - g), "DM": 1 - BETA, "DD": BETA,
          "SM": (1 - ALPHA) / rlen, "SI": ALPHA / rlen}
    bp = 10.0 ** (-np.where(bq == 2, q2d, bq).astype(np.float64) / 10.0)
    s, prev, ri, qi = 0.0, "S", shift, 0
    for ch in aln:
        s += math.log10(tp[prev + ch])
        if ch == "M":
            same = CODE.get(ref[ri], 4) == CODE.get(query[qi], 4)
            s += math.log10(1 - bp[qi] if same else bp[qi] / 3)
            ri += 1
            qi += 1
        elif ch == "I":
            s += math.log10(0.25)
            qi += 1
        else:
            ri += 1
        prev = ch
    return s


def _assert_tie(c, got, want):
    ref, query, bqs, q2ds = _inputs(c)
    a = path_score(ref[0], query[0], bqs[0], q2ds[0], *got)
    b = path_score(ref[0], query[0], bqs[0], q2ds[0], *want)
    ulp = float(np.spacing(np.float32(abs(a))))
    assert abs(a - b) <= TIE_ULPS * ulp, (got, want, a, b)


@pytest.fixture(scope="module")
def torch_paths():
    return [viterbi_batch(*_inputs(c), device="cpu")[0] for c in CASES]


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_viterbi_torch_matches_jax(idx, torch_paths):
    """One case per batch, as the reference's test runs it."""
    c = CASES[idx]
    got = torch_paths[idx]
    want = viterbi_batch_jax(*_inputs(c))[0]
    if got != want:
        assert idx in TIES_VS_JAX, (idx, got, want)
        _assert_tie(c, got, want)


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_viterbi_torch_matches_c(idx, torch_paths):
    c = CASES[idx]
    got = torch_paths[idx]
    want = viterbi_align(c["ref"].encode(), c["query"].encode(),
                         c["bqual"].encode(), c["q2def"])
    if got != want:
        assert idx in TIES_VS_C, (idx, got, want)
        _assert_tie(c, got, want)


def test_viterbi_torch_path_identity_share(torch_paths):
    """The reference's own bar (tests/test_viterbi_jax.py): at least 95%
    of the goldens path-identical to the C realigner."""
    n_match = sum(
        torch_paths[i] == viterbi_align(c["ref"].encode(),
                                        c["query"].encode(),
                                        c["bqual"].encode(), c["q2def"])
        for i, c in enumerate(CASES))
    assert n_match >= int(len(CASES) * 0.95), f"{n_match}/{len(CASES)}"
    assert n_match == len(CASES) - len(TIES_VS_C)


def test_path_score_tells_paths_apart():
    """path_score is not blind: a golden path outscores a shifted one and
    an all-match path where the C realigner placed an indel."""
    c = next(c for c in CASES if "D" in c["aln"] and c["shift"] > 0)
    ref, query, bqs, q2ds = _inputs(c)
    best = path_score(ref[0], query[0], bqs[0], q2ds[0], c["shift"],
                      c["aln"])
    worse = path_score(ref[0], query[0], bqs[0], q2ds[0], c["shift"] - 1,
                       c["aln"])
    assert best - worse > 1e-3
    flat = "M" * len(query[0])
    assert best > path_score(ref[0], query[0], bqs[0], q2ds[0],
                             c["shift"], flat)


def _groups():
    by_len = {}
    for i, c in enumerate(CASES):
        by_len.setdefault(len(c["query"]), []).append(i)
    return [g for g in by_len.values()
            if len({len(CASES[i]["ref"]) for i in g}) > 1]


@pytest.mark.parametrize("group", _groups()[:4],
                         ids=lambda g: f"L{len(CASES[g[0]]['query'])}")
def test_viterbi_batch_masks_shorter_windows(group, torch_paths):
    """Goldens of one query length and windows of different lengths in
    one batch (padded to the longest, each masked beyond its own l_ref)
    give the paths they give one by one; the longest window is put last,
    so the padding does not come from the first."""
    group = sorted(group, key=lambda i: len(CASES[i]["ref"]))
    parts = [_inputs(CASES[i]) for i in group]
    got = viterbi_batch(*[sum((p[j] for p in parts), []) for j in range(4)],
                        device="cpu")
    assert got == [torch_paths[i] for i in group]


def test_viterbi_batch_pads_past_128():
    """A window longer than 128 pads the batch to 256: the shorter one's
    path is unchanged."""
    rng = np.random.default_rng(3)
    g = rng.choice(list(b"ACGT"), 200).astype(np.uint8)
    q = np.concatenate([g[20:60], g[63:100]])
    bq = np.full(len(q), 30, np.uint8)
    short = viterbi_batch([g[10:110].tobytes()], [q.tobytes()], [bq], [20],
                          device="cpu")
    both = viterbi_batch([g[10:110].tobytes(), g[:200].tobytes()],
                         [q.tobytes()] * 2, [bq, bq], [20, 20],
                         device="cpu")
    assert both[0] == short[0]
    assert short[0] == ref_viterbi_align(g[10:110].tobytes(), q.tobytes(),
                                         (bq + 33).tobytes(), 20)
    assert "DDD" in short[0][1]


def test_viterbi_batch_needs_the_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        viterbi_batch(*_inputs(CASES[0]))
