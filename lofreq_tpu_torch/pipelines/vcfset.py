"""VCF set operations: intersect / complement / concat.

Equivalent of `lofreq vcfset` (lofreq_vcfset.c:110-539).  vcf1 streams;
vcf2 lookups go through its tabix index when one exists next to a bgzip
file (the reference's access pattern, lofreq_vcfset.c:427-433 — scales to
dbSNP-size inputs without loading them), falling back to a position-keyed
in-memory index otherwise.
"""

from __future__ import annotations

import os

from ..io.vcf import Var, VcfReader, VcfWriter


class _TabixVar2:
    """vcf2 lookup via tabix random access (streaming, O(1) memory)."""

    def __init__(self, path):
        from ..io.tabix import TabixVcf

        self.tbx = TabixVcf(path)

    def get(self, chrom, pos):
        out = []
        for line in self.tbx.fetch_lines(chrom, pos, pos + 1):
            v = Var.from_line(line.decode())
            if v.pos == pos:
                out.append(v)
        return out

    def close(self):
        self.tbx.close()


class _MemVar2:
    def __init__(self, path):
        self.idx = {}
        with VcfReader(path) as r2:
            for v2 in r2:
                self.idx.setdefault((v2.chrom, v2.pos), []).append(v2)

    def get(self, chrom, pos):
        return self.idx.get((chrom, pos), ())

    def close(self):
        pass


def _open_var2(path):
    p = str(path)
    if os.path.exists(p + ".tbi"):
        try:
            return _TabixVar2(p)
        except OSError:
            pass
    return _MemVar2(p)


def run_vcfset(
    action: str,
    vcf1_path,
    vcf2_path=None,
    out_path="-",
    add_info: str = None,
    count_only: bool = False,
    only_pos: bool = False,
    only_passed: bool = False,
    only_snvs: bool = False,
    only_indels: bool = False,
    concat_paths=(),
):
    assert action in ("intersect", "complement", "concat")

    var2 = _open_var2(vcf2_path) if vcf2_path is not None else None

    def var2_match(v1) -> bool:
        for v2 in var2.get(v1.chrom, v1.pos):
            if only_passed and not v2.passes():
                continue
            if only_snvs and v2.is_indel():
                continue
            if only_indels and not v2.is_indel():
                continue
            if only_pos:
                return True
            if v1.ref == v2.ref and v1.alt == v2.alt:
                return True
        return False

    num_out = 0
    writer = None
    inputs = [vcf1_path] + list(concat_paths)
    if action != "concat":
        inputs = [vcf1_path]
    for in_idx, path in enumerate(inputs):
        with VcfReader(path) as r1:
            if writer is None and not count_only:
                # NB the reference's vcfset does NOT register an ##INFO
                # header for -I values (the SOMATIC declaration comes
                # from lofreq_uniq.c:658 where the tag originates);
                # verified by test_vcfset_differential
                writer = VcfWriter(out_path, r1.header)
            for v1 in r1:
                if only_snvs and v1.is_indel():
                    continue
                if only_indels and not v1.is_indel():
                    continue
                if not only_pos and v1.alt and "," in v1.alt:
                    raise ValueError("No support for multi-allelic SNVs in vcf1")
                if only_passed and not v1.passes():
                    continue
                if add_info:
                    v1.add_info(add_info)
                if action == "concat":
                    num_out += 1
                    if writer:
                        writer.write(v1)
                    continue
                m = var2_match(v1)
                if (action == "complement" and not m) or (
                        action == "intersect" and m):
                    num_out += 1
                    if writer:
                        writer.write(v1)
    if writer:
        writer.close()
    if var2 is not None:
        var2.close()
    return num_out
