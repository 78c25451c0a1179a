"""The BAQ lookup tables of lofreq_tpu_torch's native library are filled
once, when the library loads (_native_build._fill_baq_tables).

csrc/host/baq.c fills them at a thread's first BAQ batch, without a lock,
and its base-code table not idempotently: every entry is set to 4 (N),
then A, C, G and T.  A thread that found the table unfilled while another
thread's first batch was filling it resets the table again while the
other thread already reads it, and that thread codes its bases as N.

The test builds the port's baq.c with a hook at the three points of the
fill (before the reset, after it, after the table is marked filled) and
makes two threads' first batches interleave exactly so.  On a library
loaded without the fill the first thread's BAQ changes; on one loaded
with it, neither thread fills the tables again and the BAQ is the serial
one."""

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import pytest

from lofreq_tpu_torch import _native_build as NB

HOOK = "void (*lfq_test_hook)(int) = 0;\n"
FILL = """    if (!base_code_init_done) {
        memset(base_code, 4, 256);
"""
FILLED = """        base_code_init_done = 1;
"""
WAIT = 30.0

_i64 = ctypes.POINTER(ctypes.c_int64)
_u8 = ctypes.POINTER(ctypes.c_uint8)


@pytest.fixture(scope="module")
def hooked_lib(tmp_path_factory):
    """baq.c with the hook, built alone; a function that loads a fresh
    copy of it (its own tables)."""
    if shutil.which("gcc") is None:
        pytest.skip("no gcc")
    src = open(os.path.join(NB._CSRC, "baq.c")).read()
    assert src.count(FILL) == 1 and src.count(FILLED) == 1
    src = src.replace(FILL, FILL.replace(
        "        memset", "        if (lfq_test_hook) lfq_test_hook(0);\n"
        "        memset") + "        if (lfq_test_hook) lfq_test_hook(1);\n")
    src = src.replace(FILLED, FILLED + "        if (lfq_test_hook) "
                      "lfq_test_hook(2);\n")
    src = src.replace("static uint8_t base_code[256];",
                      HOOK + "static uint8_t base_code[256];")
    d = tmp_path_factory.mktemp("baq_hook")
    c = d / "baq.c"
    c.write_text(src)
    for dep in NB.DEPS:
        shutil.copy(os.path.join(NB._CSRC, dep), d / dep)
    so = d / "libbaq.so"
    subprocess.run(["gcc", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(so), str(c), "-lm", "-lpthread"],
                   check=True, capture_output=True)
    copies = iter(range(1000))

    def load():
        path = d / f"copy{next(copies)}.so"
        shutil.copy(so, path)
        return ctypes.CDLL(str(path))
    return load


def _batch(seed, n):
    """A reference and n reads of 100M on it with 5% of bases wrong, as
    the arrays lfq_baq_batch takes."""
    rng = np.random.default_rng(seed)
    ref = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5_000)]
    pos = np.sort(rng.integers(0, 4_900, n)).astype(np.int64)
    seqs = np.concatenate([ref[p:p + 100] for p in pos])
    wrong = rng.random(seqs.size) < 0.05
    seqs[wrong] = np.frombuffer(b"ACGT", np.uint8)[
        (np.searchsorted(np.frombuffer(b"ACGT", np.uint8), seqs[wrong])
         + 1) % 4]
    return dict(
        ref=ref.tobytes(), pos=pos,
        cigars=np.full(n, 100 << 4, np.uint32),
        cigar_start=np.arange(n + 1, dtype=np.int64),
        seqs=seqs.tobytes(), quals=np.full(seqs.size, 35, np.uint8),
        seq_start=np.arange(n + 1, dtype=np.int64) * 100,
        want_baq=np.ones(n, np.uint8), want_idaq=np.zeros(n, np.uint8))


def _run(lib, a):
    """lfq_baq_batch on the arrays of _batch; the BAQ bytes."""
    n = len(a["pos"])
    outs = [np.zeros(100 * n + n, np.uint8) for _ in range(3)]
    flags = np.zeros(n, np.uint8)
    lib.lfq_baq_batch(
        a["ref"], ctypes.c_int64(len(a["ref"])), ctypes.c_int64(n),
        a["pos"].ctypes.data_as(_i64),
        a["cigars"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        a["cigar_start"].ctypes.data_as(_i64), a["seqs"],
        a["quals"].ctypes.data_as(_u8), a["seq_start"].ctypes.data_as(_i64),
        a["want_baq"].ctypes.data_as(_u8), a["want_idaq"].ctypes.data_as(_u8),
        ctypes.c_int(1), ctypes.c_double(1e-5), ctypes.c_double(0.4),
        *[o.ctypes.data_as(_u8) for o in outs], flags.ctypes.data_as(_u8))
    return outs[0]


def _first_batches_interleaved(lib, first, second):
    """Both threads' first batches, the second thread finding the table
    unfilled while the first fills it, and resetting it after the first
    has marked it filled, until the first batch returns.  The first
    thread's BAQ bytes, and how many fills each thread ran."""
    ev = {k: threading.Event() for k in ("checked", "filled", "returned")}
    fills = {"one": 0, "two": 0}
    out = {}

    def hook(point):
        me = threading.current_thread().name
        if me not in fills:
            return
        if point == 0:
            fills[me] += 1
        if me == "one" and point == 1:
            ev["checked"].wait(WAIT)
        elif me == "one" and point == 2:
            ev["filled"].set()
        elif me == "two" and point == 0:
            ev["checked"].set()
            ev["filled"].wait(WAIT)
        elif me == "two" and point == 1:
            ev["returned"].wait(WAIT)

    cb = ctypes.CFUNCTYPE(None, ctypes.c_int)(hook)
    ctypes.c_void_p.in_dll(lib, "lfq_test_hook").value = \
        ctypes.cast(cb, ctypes.c_void_p).value

    def one():
        out["one"] = _run(lib, first)
        ev["returned"].set()

    threads = [threading.Thread(target=one, name="one"),
               threading.Thread(target=_run, args=(lib, second),
                                name="two")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * WAIT)
    ctypes.c_void_p.in_dll(lib, "lfq_test_hook").value = None
    return out["one"], fills


def test_concurrent_first_batches_code_bases_as_n_without_the_fill(
        hooked_lib):
    first, second = _batch(1, 400), _batch(2, 100)
    serial = _run(hooked_lib(), first)
    got, fills = _first_batches_interleaved(hooked_lib(), first, second)
    assert fills == {"one": 1, "two": 1}
    assert (got != serial).sum() > 0


def test_the_fill_at_load_keeps_first_batches_exact(hooked_lib):
    first, second = _batch(1, 400), _batch(2, 100)
    serial = _run(hooked_lib(), first)
    lib = hooked_lib()
    NB._fill_baq_tables(lib)
    got, fills = _first_batches_interleaved(lib, first, second)
    assert fills == {"one": 0, "two": 0}
    assert np.array_equal(got, serial)
