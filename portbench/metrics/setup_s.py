"""Set-up seconds: from run.py's first line to the window's start, on the
host's clock.  It covers importing torch and the port, the CUDA context,
building or loading the kernel and native libraries, making or reusing
the inputs, and one warm call of each of the cell's samples."""


def read(rec):
    return rec["setup_s"]
