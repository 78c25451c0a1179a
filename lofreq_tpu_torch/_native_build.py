"""Builds and loads the native C library (csrc/host/ -> one .so).

The port's copy of lofreq_tpu/_native_build.py: the same sources, built
with the same gcc flags, from the port's own copies in csrc/host/ into
csrc/build/ of this package.  The JAX package's library is a different
file, so a process that loads both keeps them apart."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc", "host")
_BUILD = os.path.join(_PKG, "csrc", "build")
SRCS = ["ingest.c", "exact_stats.c", "baq.c", "realign.c", "columns.c",
        "bgzf.c", "screen_pack.c"]
# non-compiled inputs that must still invalidate the build cache
DEPS = ["baq_glocal_xw.inc", "realign_xw.inc"]

_lock = threading.Lock()
_lib = None
_malloc_tuned = False


def _tune_malloc():
    """Keep freed window buffers in the heap instead of munmap'ing them.

    The call pipeline allocates and frees GB-scale buffers every window
    (inflated raw records, per-window column tensors, arena growth).  With
    glibc's defaults each of those goes through mmap()/munmap(), and every
    munmap triggers cross-CPU TLB shootdowns while the striped native
    workers are running — measured on the 4-core dev VM as ~3x more SYSTEM
    than user time in the fused ingest (56s sys for a 50kb@800x window's
    first pass, 0.1s once allocation stops churning).  mallopt(M_MMAP_MAX,
    0) + a maxed trim threshold route large allocations through brk and
    keep frees process-local: steady-state windows run ~2x faster wall and
    the kernel time collapses.  Peak RSS stays bounded by the largest
    window working set, which the grow-only arenas impose anyway.

    Caveats: the settings are process-global — an application embedding
    this library keeps its peak heap for the process lifetime (set
    LOFREQ_MALLOC_TUNE=0 to restore glibc defaults; documented in
    README).  And they fully apply only to main-arena allocations: glibc
    non-main (per-thread) arenas still mmap/munmap blocks larger than
    the arena heap can grow, so the GB-scale window buffers are
    deliberately allocated from the pipeline's single ingest thread."""
    global _malloc_tuned
    if _malloc_tuned or os.environ.get(
            "LOFREQ_MALLOC_TUNE", "1").strip().lower() in (
            "0", "false", "no", "off"):
        _malloc_tuned = True
        return
    _malloc_tuned = True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_MMAP_THRESHOLD, 2**31 - 1)
        libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
    except (OSError, AttributeError):
        pass  # non-glibc: defaults are fine


def get_native_lib() -> ctypes.CDLL:
    """Build (if stale) and load csrc/build/liblofreq_native.so."""
    global _lib
    with _lock:
        if _lib is None:
            _tune_malloc()
            srcs = [os.path.join(_CSRC, s) for s in SRCS]
            out = os.path.join(_BUILD, "liblofreq_native.so")
            os.makedirs(_BUILD, exist_ok=True)
            deps = [os.path.join(_CSRC, d) for d in DEPS]
            newest = max(os.path.getmtime(s) for s in srcs + deps)
            if not (os.path.exists(out)
                    and os.path.getmtime(out) >= newest):
                tmp = out + f".tmp{os.getpid()}"
                # -ffp-contract=off: FMA contraction would change double
                # rounding and break bit-identity with the reference kernels
                # (goldens in tests/golden/); -march=native only vectorizes,
                # which keeps per-lane IEEE semantics.
                # libdeflate (2-3x zlib inflate) is optional: probe for
                # header + lib, fall back to plain zlib otherwise
                import ctypes.util as _cu

                extra = []
                if (os.path.exists("/usr/include/libdeflate.h")
                        and _cu.find_library("deflate")):
                    extra = ["-DLOFREQ_HAVE_LIBDEFLATE", "-ldeflate"]
                subprocess.run(
                    ["gcc", "-O3", "-march=native", "-ffp-contract=off",
                     "-shared", "-fPIC", "-o", tmp, *srcs,
                     "-lm", "-lpthread", "-lz", *extra],
                    check=True, capture_output=True,
                )
                os.replace(tmp, out)
            _lib = ctypes.CDLL(out)
    return _lib
