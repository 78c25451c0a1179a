"""The exact DP with its rows spread over native threads
(`lfq_poissbin_dp_batch_mt`, which `native.poissbin_dp_batch` calls)
gives the serial `lfq_poissbin_dp_batch`'s bits: `state` compared as raw
uint64, the -1e100 cells and the columns past a row's K included, and
`n_done`, at 1, 2, 3 and 8 native threads, on deep rows at AF 1.0,
early-exit rows, K = 1, K = N, padded rows, B = 0 and B = 1.  The
threads it ran on are 1 where one thread is asked for or the batch is
small, more for a deep batch, and each calling thread reads its own."""

import ctypes
import threading

import numpy as np
import pytest

from lofreq_tpu_torch import native

SIG = 0.01
THREADS = [1, 2, 3, 8]


def serial(probs, depths, ks, bonf, sig=SIG):
    """The reference's serial DP on the same arrays."""
    lib = native.get_lib()
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    depths = np.ascontiguousarray(depths, dtype=np.int64)
    ks = np.ascontiguousarray(ks, dtype=np.int64)
    bonf = np.ascontiguousarray(bonf, dtype=np.float64)
    B, Dmax = probs.shape
    Kmax = int(ks.max()) if B else 0
    state = np.empty((B, Kmax + 1), dtype=np.float64)
    n_done = np.empty(B, dtype=np.int64)
    if B:
        lib.lfq_poissbin_dp_batch(
            native._ptr(probs, native._f64), native._ptr(depths, native._i64),
            native._ptr(ks, native._i64), native._ptr(bonf, native._f64),
            sig, B, Dmax, Kmax, native._ptr(state, native._f64),
            native._ptr(n_done, native._i64))
    return state, n_done


def rows(rng, depths, ks, lo=2.0, hi=4.0, dmax=None):
    """[B, Dmax] ascending error probs 10^-U(lo, hi), padded with 2.0."""
    depths = np.asarray(depths, dtype=np.int64)
    dmax = int(depths.max()) if dmax is None else dmax
    probs = np.full((len(depths), dmax), 2.0)
    for b, n in enumerate(depths):
        probs[b, :n] = np.sort(10.0 ** -rng.uniform(lo, hi, n))
    return probs, depths, np.asarray(ks, dtype=np.int64)


def af_one(rng):
    """Planted SNVs at AF 1.0: K = N, up to ~3,000 reads deep."""
    depths = rng.integers(1500, 3001, 6)
    return rows(rng, depths, depths)


def early_exit(rng):
    """Error-only columns (K a few reads, error probs near 0.05): the
    tail passes sig at once and the row stops long before N."""
    depths = rng.integers(1000, 2500, 12)
    return rows(rng, depths, rng.integers(2, 6, 12), lo=1.0, hi=1.6)


def mixed(rng):
    """AF 1.0, low-AF, K = 1, K = N and early-exit rows in one batch,
    padded past every N (Dmax > max N)."""
    depths = np.array([2900, 2400, 1800, 1200, 700, 300, 2000, 1500, 50, 9])
    ks = np.array([2900, 120, 1, 1200, 3, 300, 40, 1500, 1, 9])
    probs, depths, ks = rows(rng, depths, ks, dmax=3100)
    probs[6, :depths[6]] = np.sort(10.0 ** -rng.uniform(1.0, 1.6,
                                                        depths[6]))
    return probs, depths, ks


def ascending(rng):
    """Rows given in cost-ascending order: the claim order reverses it."""
    depths = np.array([100, 300, 600, 900, 1400, 2000, 2600])
    return rows(rng, depths, depths)


BATCHES = {"af-one": af_one, "early-exit": early_exit, "mixed": mixed,
           "cost-ascending": ascending}


def same_bits(got, want):
    (gs, gn), (ws, wn) = got, want
    assert gs.shape == ws.shape and gn.shape == wn.shape
    assert np.array_equal(gs.view(np.uint64), ws.view(np.uint64))
    assert np.array_equal(gn, wn)


@pytest.mark.parametrize("nth", THREADS)
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_threads_keep_the_serial_bits(monkeypatch, batch, nth):
    monkeypatch.setenv("LOFREQ_NATIVE_THREADS", str(nth))
    probs, depths, ks = BATCHES[batch](np.random.default_rng(nth * 7 + 1))
    bonf = np.full(len(depths), 3e4)
    want = serial(probs, depths, ks, bonf)
    same_bits(native.poissbin_dp_batch(probs, depths, ks, bonf, SIG), want)
    assert native.last_dp_threads() <= nth
    state, n_done = want
    assert (state == -1e100).any()          # cells never reached
    if batch == "early-exit":
        assert (n_done < depths).all()
    if batch in ("af-one", "cost-ascending"):
        assert (n_done == depths).all()


@pytest.mark.parametrize("nth", THREADS)
def test_small_batches_keep_the_serial_bits(monkeypatch, nth):
    """B = 1, and B = 0 through the C entry itself."""
    monkeypatch.setenv("LOFREQ_NATIVE_THREADS", str(nth))
    probs, depths, ks = rows(np.random.default_rng(5), [2500], [2500],
                             dmax=2600)
    same_bits(native.poissbin_dp_batch(probs, depths, ks, 10.0, SIG),
              serial(probs, depths, ks, [10.0]))
    assert native.last_dp_threads() == 1
    used = ctypes.c_int64(-1)
    keep = [np.zeros(1), np.zeros(1, np.int64)]
    native.get_lib().lfq_poissbin_dp_batch_mt(
        native._ptr(keep[0], native._f64), native._ptr(keep[1], native._i64),
        native._ptr(keep[1], native._i64), native._ptr(keep[0], native._f64),
        SIG, 0, 1, 0, native._ptr(keep[0], native._f64),
        native._ptr(keep[1], native._i64), ctypes.byref(used))
    assert used.value == 1
    state, n_done = native.poissbin_dp_batch(np.zeros((0, 4)), [], [], 1.0,
                                             SIG)
    assert state.shape == (0, 1) and n_done.shape == (0,)


def test_one_thread_when_asked_or_when_the_batch_is_small(monkeypatch):
    rng = np.random.default_rng(9)
    deep = af_one(rng)
    small = rows(rng, [200] * 8, [200] * 8)   # ~0.16 M cells: under the cap
    monkeypatch.setenv("LOFREQ_NATIVE_THREADS", "1")
    native.poissbin_dp_batch(*deep, 1.0, SIG)
    assert native.last_dp_threads() == 1
    monkeypatch.setenv("LOFREQ_NATIVE_THREADS", "8")
    native.poissbin_dp_batch(*small, 1.0, SIG)
    assert native.last_dp_threads() == 1
    native.poissbin_dp_batch(*deep, 1.0, SIG)
    assert 1 < native.last_dp_threads() <= 6    # capped by the rows


def test_each_calling_thread_reads_its_own_count(monkeypatch):
    """Python threads call the DP at once (more of them than cores, each
    spreading its rows over 8 native threads): every result keeps the
    serial bits, and each thread reads the count of its own last call."""
    monkeypatch.setenv("LOFREQ_NATIVE_THREADS", "8")
    rng = np.random.default_rng(13)
    deep, small = mixed(rng), rows(rng, [300] * 4, [300] * 4)
    bonf = 3e4
    want = {id(b): serial(*b, np.full(len(b[1]), bonf))
            for b in (deep, small)}
    errors, counts = [], {}

    def work(i):
        b = deep if i % 2 else small
        try:
            for _ in range(3):
                same_bits(native.poissbin_dp_batch(*b, bonf, SIG),
                          want[id(b)])
                counts.setdefault(i, set()).add(native.last_dp_threads())
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(counts) == 12
    for i, seen in counts.items():
        assert (max(seen) > 1) if i % 2 else (seen == {1})
