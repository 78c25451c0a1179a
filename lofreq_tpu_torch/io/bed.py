"""BED interval index: equivalent of the reference's bedidx.c
(bed_read/bed_overlap).  Two-column input (chrom pos) is treated as a
1-based position list, three-column as 0-based half-open BED, matching
samtools' bedidx semantics.
"""

from __future__ import annotations

import gzip

import numpy as np


class BedIndex:
    def __init__(self):
        self._raw: dict[str, list] = {}
        self._starts: dict[str, np.ndarray] = {}
        self._ends: dict[str, np.ndarray] = {}
        self._maxend: dict[str, np.ndarray] = {}

    @classmethod
    def read(cls, path):
        idx = cls()
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(("#", "track", "browser")):
                    continue
                f = line.split()
                chrom = f[0]
                if len(f) >= 3:
                    try:
                        beg, end = int(f[1]), int(f[2])
                    except ValueError:
                        continue
                elif len(f) == 2:
                    try:
                        end = int(f[1])
                    except ValueError:
                        continue
                    beg = end - 1
                else:
                    continue
                if end < beg:
                    beg, end = end, beg
                idx._raw.setdefault(chrom, []).append((beg, end))
        idx._finish()
        return idx

    def _finish(self):
        for chrom, ivals in self._raw.items():
            ivals.sort()
            starts = np.array([i[0] for i in ivals], dtype=np.int64)
            ends = np.array([i[1] for i in ivals], dtype=np.int64)
            self._starts[chrom] = starts
            self._ends[chrom] = ends
            self._maxend[chrom] = np.maximum.accumulate(ends)

    def overlap(self, chrom, beg, end) -> bool:
        """True if [beg, end) overlaps any interval on chrom."""
        starts = self._starts.get(chrom)
        if starts is None:
            return False
        hi = np.searchsorted(starts, end, side="left")
        if hi == 0:
            return False
        return bool(self._maxend[chrom][hi - 1] > beg)

    def overlap_mask(self, chrom, positions: np.ndarray) -> np.ndarray:
        """Vectorized per-position overlap test (positions are 0-based)."""
        starts = self._starts.get(chrom)
        if starts is None:
            return np.zeros(len(positions), dtype=bool)
        hi = np.searchsorted(starts, positions, side="right")
        maxend = self._maxend[chrom]
        out = np.zeros(len(positions), dtype=bool)
        nz = hi > 0
        out[nz] = maxend[hi[nz] - 1] > positions[nz]
        return out

    def intervals(self, chrom):
        return list(zip(self._starts.get(chrom, []), self._ends.get(chrom, [])))

    @property
    def chroms(self):
        return list(self._raw.keys())

    def num_regions(self) -> int:
        return sum(len(v) for v in self._raw.values())

    def total_length(self) -> int:
        return int(sum((self._ends[c] - self._starts[c]).sum() for c in self._raw))
