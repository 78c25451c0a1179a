"""FASTA access with .fai (faidx) indexing.

Equivalent of the htslib faidx usage in the reference (fai_load /
faidx_fetch_seq, e.g. plp.c:1377-1389).  Sequences are returned uppercased,
matching the reference's strtoupper() safeguard (plp.c:1383).
"""

from __future__ import annotations

import gzip
import os


class FastaError(IOError):
    pass


def build_fai(path) -> list[tuple]:
    """Build a .fai index: (name, length, offset, linebases, linewidth)."""
    entries = []
    with open(path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        while True:
            line_off = fh.tell()
            line = fh.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = fh.tell()
                first_line = True
            else:
                if name is None:
                    raise FastaError("FASTA doesn't start with '>'")
                stripped = line.rstrip(b"\r\n")
                if first_line:
                    linebases = len(stripped)
                    linewidth = len(line)
                    first_line = False
                length += len(stripped)
                _ = line_off
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    return entries


def write_fai(path, entries) -> None:
    with open(str(path) + ".fai", "w") as fh:
        for name, length, offset, linebases, linewidth in entries:
            fh.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")


def read_fai(fai_path) -> list[tuple]:
    entries = []
    with open(fai_path) as fh:
        for line in fh:
            if not line.strip():
                continue
            fields = line.split("\t")
            entries.append(
                (fields[0], int(fields[1]), int(fields[2]), int(fields[3]),
                 int(fields[4]))
            )
    return entries


class Fasta:
    """Random access to an (optionally gzipped) FASTA file.

    Plain files use the .fai index for random access; gzipped files are
    slurped into memory (the reference genome is replicated per host anyway).
    """

    def __init__(self, path):
        self.path = str(path)
        self._seqs: dict[str, bytes] = {}
        self._fai: dict[str, tuple] = {}
        self._order: list[str] = []
        if self.path.endswith(".gz"):
            self._load_all_gz()
        else:
            fai_path = self.path + ".fai"
            if not os.path.exists(fai_path) or (
                os.path.getmtime(fai_path) < os.path.getmtime(self.path)
            ):
                entries = build_fai(self.path)
                try:
                    write_fai(self.path, entries)
                except OSError:
                    pass
            else:
                entries = read_fai(fai_path)
            for e in entries:
                self._fai[e[0]] = e
                self._order.append(e[0])
            self._fh = open(self.path, "rb")

    def _load_all_gz(self):
        name = None
        chunks = []
        with gzip.open(self.path, "rb") as fh:
            for line in fh:
                if line.startswith(b">"):
                    if name is not None:
                        self._seqs[name] = b"".join(chunks).upper()
                    name = line[1:].split()[0].decode()
                    self._order.append(name)
                    chunks = []
                else:
                    chunks.append(line.strip())
        if name is not None:
            self._seqs[name] = b"".join(chunks).upper()

    @property
    def references(self) -> list[str]:
        return list(self._order)

    def length(self, name) -> int:
        if name in self._fai:
            return self._fai[name][1]
        return len(self._seqs[name])

    def fetch(self, name) -> bytes:
        """Whole-chromosome fetch, uppercased (like the reference's usage)."""
        if name in self._seqs:
            return self._seqs[name]
        if name not in self._fai:
            raise FastaError(f"no sequence '{name}' in {self.path}")
        _, length, offset, linebases, linewidth = self._fai[name]
        nlines = (length + linebases - 1) // linebases if linebases else 0
        nbytes = length + nlines * (linewidth - linebases)
        self._fh.seek(offset)
        raw = self._fh.read(nbytes)
        seq = raw.replace(b"\n", b"").replace(b"\r", b"")[:length].upper()
        self._seqs[name] = seq  # cache: chromosome-at-a-time like plp.c
        return seq

    def close(self):
        fh = getattr(self, "_fh", None)
        if fh is not None:
            fh.close()


def write_fasta(path, seqs: dict, width: int = 60) -> None:
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            if isinstance(seq, bytes):
                seq = seq.decode()
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
