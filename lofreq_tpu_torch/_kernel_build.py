"""Builder and loader for the port's CUDA kernels (csrc/*.cu -> one .so).

Counterpart of lofreq_tpu/_native_build.py.  The kernels are compiled at
first use with nvcc for sm_90a, one nvcc per source started together, and
linked into a shared library with a plain C interface, loaded with ctypes
(pointers and the stream are passed as c_void_p).  The library lands in csrc/build/, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads at once.  A file lock covers the build: the screen is resolved on
several confirm-executor threads, and several processes may share one
checkout.  Any build or load failure raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(CSRC, "build")
SRCS = ["poissbin_screen.cu", "baq_hmm.cu", "fused_call.cu"]
DEPS = ["poissbin_screen.cuh", "baq_hmm.cuh", "fused_call.cuh"]
# no --use_fast_math: flush-to-zero and the approximate exp2/log would
# change the screen mask and the BAQ phreds against the plain PyTorch
# versions (the BAQ HMM clamps at the subnormal 1e-38).  -fmad=false: every
# multiply and add rounds on its own, as in the plain versions and in the
# CPU tests' g++ builds of the headers (-ffp-contract=off)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", os.path.join(os.sep, "usr", "local",
                                                    "cuda"))
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME "
                           "to build the CUDA kernels")
    return nvcc


def library_path() -> str:
    """Path of the kernel library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SRCS + DEPS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD, f"liblfq_kernels_{h.hexdigest()[:16]}.so")


def build_log() -> str:
    """nvcc's output of the last build (registers, spills), or ''."""
    log = library_path() + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as fh:
        return fh.read()


def _build(out: str) -> None:
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, ".lock"), "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return
        tmp = out + f".tmp{os.getpid()}"
        nvcc = _nvcc()
        # one nvcc per source, all at once, then one link
        objs = [f"{tmp}.{i}.o" for i in range(len(SRCS))]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o,
                 os.path.join(CSRC, src)] for src, o in zip(SRCS, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", tmp, *objs]
        try:
            for cmd, p, log in zip(cmds, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                       f"{' '.join(cmd)}\n{log}")
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}): "
                    f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.unlink(o)
        with open(out + ".log", "w") as fh:
            fh.write("".join(logs))
        os.replace(tmp, out)


def get_kernel_lib() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            vp = ctypes.c_void_p
            lib.lfq_screen_codes_launch.argtypes = [
                vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, vp]
            lib.lfq_screen_codes_launch.restype = ctypes.c_int
            i64, i32 = ctypes.c_longlong, ctypes.c_int
            lib.lfq_baq_fwd_launch.argtypes = [vp] * 7 + [i64, i32, i32,
                                                          i32, vp]
            lib.lfq_baq_fwd_launch.restype = ctypes.c_int
            lib.lfq_baq_bwd_launch.argtypes = [vp] * 9 + [i64, i32, i32,
                                                          i32, vp]
            lib.lfq_baq_bwd_launch.restype = ctypes.c_int
            lib.lfq_tail_probs_launch.argtypes = [vp, i64, vp, vp, i64,
                                                  i64, i32, vp]
            lib.lfq_tail_probs_launch.restype = ctypes.c_int
            lib.lfq_fused_call_launch.argtypes = [vp] * 6 + [i64, i64] + \
                [i32] * 5 + [i32, vp]
            lib.lfq_fused_call_launch.restype = ctypes.c_int
            lib.lfq_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lfq_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
