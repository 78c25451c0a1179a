"""VCF reading/writing with the exact record formats of the reference.

The reference's header + INFO emitters (vcf.c:608-676) define a bit-identity
contract: INFO is "DP=%d;AF=%f;SB=%d;DP4=%d,%d,%d,%d" plus ";INDEL;HRUN=%d"
for indels or ";HQA=%d" for SNVs and an optional ";CONSVAR".  QUAL is an
integer phred or '.'.
"""

from __future__ import annotations

import io
import os
import sys
import time
from dataclasses import dataclass, field

from .bgzf import BgzfReader, BgzfWriter, is_gzip

VCF_MISSING = "."
VCF_HEADER_LINE = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"

INFO_DEFS = (
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="Raw Depth">\n'
    '##INFO=<ID=AF,Number=1,Type=Float,Description="Allele Frequency">\n'
    '##INFO=<ID=SB,Number=1,Type=Integer,Description="Phred-scaled strand bias at this position">\n'
    '##INFO=<ID=DP4,Number=4,Type=Integer,Description="Counts for ref-forward bases, ref-reverse, alt-forward and alt-reverse bases">\n'
    '##INFO=<ID=HQA,Number=1,Type=Integer,Description="Count of high quality alt bases supporting SNP call">\n'
    '##INFO=<ID=INDEL,Number=0,Type=Flag,Description="Indicates that the variant is an INDEL.">\n'
    '##INFO=<ID=CONSVAR,Number=0,Type=Flag,Description="Indicates that the variant is a consensus variant (as opposed to a low frequency variant).">\n'
    '##INFO=<ID=HRUN,Number=1,Type=Integer,Description="Homopolymer length to the right of report indel position">\n'
)


def has_gz_ext(path) -> bool:
    return str(path).endswith(".gz")


@dataclass
class Var:
    """Equivalent of the reference's var_t (vcf.h:47-61). pos is 0-based."""

    chrom: str = None
    pos: int = -1
    id: str = None
    ref: str = None
    alt: str = None
    qual: int = -1  # -1 == missing
    filter: str = None
    info: str = None
    format: str = None
    samples: list = field(default_factory=list)

    # -- INFO helpers ---------------------------------------------------
    def info_value(self, key: str):
        """Return (found, value_or_None): mirrors vcf_var_has_info_key."""
        if not self.info or len(self.info) < 2:
            return False, None
        for token in self.info.split(";"):
            if token[: len(key)].upper() == key.upper() and (
                len(token) == len(key) or token[len(key)] == "="
            ):
                eq = token.find("=")
                return True, (token[eq + 1 :] if eq >= 0 else None)
        return False, None

    def has_info_key(self, key: str) -> bool:
        return self.info_value(key)[0]

    def add_info(self, info_str: str):
        if not self.info or self.info == VCF_MISSING:
            self.info = info_str
        else:
            self.info += ";" + info_str

    def add_filter(self, name: str):
        if self.filter in (None, "", VCF_MISSING, "PASS") or (
            self.filter and self.filter[0] == VCF_MISSING
        ):
            self.filter = name
        else:
            self.filter += ";" + name

    def is_indel(self) -> bool:
        return (
            len(self.ref or "") > 1
            or len(self.alt or "") > 1
            or self.has_info_key("INDEL")
        )

    def passes(self) -> bool:
        return self.filter is None or self.filter[0] == VCF_MISSING or \
            self.filter.startswith("PASS")

    def dp4(self):
        found, val = self.info_value("DP4")
        if not found or val is None:
            return None
        parts = val.split(",")
        if len(parts) != 4:
            return None
        return tuple(int(x) for x in parts)

    def key(self) -> str:
        return f"{self.chrom} {self.pos + 1} {self.ref} {self.alt}"

    def key_pos_only(self) -> str:
        return f"{self.chrom} {self.pos + 1}"

    # -- text -----------------------------------------------------------
    def to_line(self) -> str:
        out = [
            self.chrom if self.chrom is not None else VCF_MISSING,
            str(self.pos + 1),
            self.id if self.id is not None else VCF_MISSING,
            self.ref,
            self.alt,
            str(self.qual) if self.qual > -1 else VCF_MISSING,
            self.filter if self.filter else VCF_MISSING,
            self.info if self.info else VCF_MISSING,
        ]
        if self.format:
            out.append(self.format)
            out.extend(self.samples)
        return "\t".join(out)

    @classmethod
    def from_line(cls, line: str):
        f = line.rstrip("\n").rstrip("\r").split("\t")
        if len(f) < 5:
            return None
        v = cls()
        v.chrom = f[0]
        try:
            v.pos = int(f[1]) - 1
        except ValueError:
            v.pos = -1
        v.id = f[2] if len(f) > 2 else VCF_MISSING
        v.ref = f[3]
        v.alt = f[4]
        if len(f) > 5 and f[5][:1] != VCF_MISSING:
            try:
                # atoi semantics: parse leading int (handles floats like "57.0")
                v.qual = int(float(f[5]))
            except ValueError:
                v.qual = -1
        else:
            v.qual = -1
        v.filter = f[6] if len(f) > 6 else VCF_MISSING
        v.info = f[7] if len(f) > 7 else VCF_MISSING
        if len(f) > 8:
            v.format = f[8]
            v.samples = f[9:]
        return v


def sprintf_info(dp, af, sb, dp4, indel, hrun, consvar, num_alt_bases) -> str:
    """Byte-identical to vcf_var_sprintf_info (vcf.c:608-629)."""
    s = f"DP={dp};AF={af:f};SB={sb};DP4={dp4[0]},{dp4[1]},{dp4[2]},{dp4[3]}"
    if indel:
        s += f";INDEL;HRUN={hrun}"
    else:
        s += f";HQA={num_alt_bases}"
    if consvar:
        s += ";CONSVAR"
    return s


def new_header(src=None, reffa=None, file_date=None) -> str:
    """Reference vcf_write_new_header (vcf.c:649-676)."""
    if file_date is None:
        file_date = time.strftime("%Y%m%d")
    h = "##fileformat=VCFv4.0\n"
    h += f"##fileDate={file_date}\n"
    if src:
        h += f"##source={src}\n"
    if reffa:
        h += f"##reference={reffa}\n"
    h += INFO_DEFS
    h += VCF_HEADER_LINE + "\n"
    return h


def add_header_line(header: str, line: str) -> str:
    """Insert a meta line right before the #CHROM line (vcf_header_add)."""
    idx = header.find("#CHROM")
    if idx < 0:
        return header + line
    return header[:idx] + line + header[idx:]


class VcfReader:
    def __init__(self, path_or_fh):
        if isinstance(path_or_fh, (str, os.PathLike)):
            p = str(path_or_fh)
            if p == "-":
                self._fh = sys.stdin
            elif is_gzip(p):
                from .bgzf import is_bgzf

                if is_bgzf(p):
                    self._fh = io.TextIOWrapper(BgzfReader(p))
                else:  # plain gzip (htslib's BGZF reads these too)
                    import gzip

                    self._fh = gzip.open(p, "rt")
            else:
                self._fh = open(p)
        else:
            self._fh = path_or_fh
        self.header = ""
        self._pending = None
        self._parse_header()

    def _parse_header(self):
        lines = []
        for line in self._fh:
            if line.startswith("#"):
                lines.append(line)
                if line.startswith("#CHROM"):
                    break
            else:
                self._pending = line
                break
        self.header = "".join(lines)

    def __iter__(self):
        return self

    def __next__(self) -> Var:
        while True:
            if self._pending is not None:
                line = self._pending
                self._pending = None
            else:
                line = self._fh.readline()
            if not line:
                raise StopIteration
            if line.startswith("#") or not line.strip():
                continue
            v = Var.from_line(line)
            if v is not None:
                return v

    def close(self):
        if self._fh is not sys.stdin:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_vcf(path, only_passed=False):
    """Slurp a VCF; returns (header, [Var])."""
    with VcfReader(path) as rdr:
        vars_ = [v for v in rdr if not only_passed or v.passes()]
        return rdr.header, vars_


class VcfWriter:
    def __init__(self, path_or_fh, header: str = None):
        self._bgz = False
        if isinstance(path_or_fh, (str, os.PathLike)):
            p = str(path_or_fh)
            if p == "-":
                self._fh = sys.stdout
            elif has_gz_ext(p):
                self._fh = io.TextIOWrapper(BgzfWriter(p))
                self._bgz = True
            else:
                self._fh = open(p, "w")
        else:
            self._fh = path_or_fh
        if header:
            self._fh.write(header if header.endswith("\n") else header + "\n")

    def write(self, var: Var):
        self._fh.write(var.to_line() + "\n")

    def write_raw(self, text: str):
        self._fh.write(text)

    def close(self):
        if self._fh is not sys.stdout:
            self._fh.close()
        else:
            self._fh.flush()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
