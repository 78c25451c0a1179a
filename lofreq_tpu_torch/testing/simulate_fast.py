"""Vectorized large-scale read simulator (SNVs only, fixed read length).

Builds all reads as one numpy matrix and encodes the BAM records in bulk
(fixed-size records, fixed-width names), so multi-million-read datasets
take seconds instead of minutes.

The port's copy of tests/simulate_fast.py, on the port's own io layer, so
that chip_smoke.py can make its BAM without the JAX package.  The two
write byte-identical files (tests/test_torch_standalone.py).
"""

from __future__ import annotations

import struct

import numpy as np

from ..io.bai import build_bai
from ..io.bam import BamHeader, reg2bin
from ..io.bgzf import BgzfWriter
from ..io.fasta import write_fasta

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
NT16_CODE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    NT16_CODE[ord(_c)] = _i


def simulate_fast(tmpdir, genome_len=2_000_000, depth=100, read_len=100,
                  snvs=((0.02, 20), (0.1, 20), (0.5, 20)), seed=3,
                  qual_range=(28, 38), chrom="big1", genome_seed=None):
    """genome_seed: draw the genome from a seed of its own, so that two
    samples (a tumor/normal pair) share it; by default `seed` draws the
    genome, the SNVs and the reads, as tests/simulate_fast.py does."""
    rng = np.random.default_rng(seed)
    genome = BASES[(rng if genome_seed is None
                    else np.random.default_rng(genome_seed))
                   .integers(0, 4, genome_len)]
    margin = read_len + 10

    n_vars = sum(n for _af, n in snvs)
    pos_pool = rng.choice(np.arange(margin, genome_len - margin),
                          n_vars * 3, replace=False)
    positions = np.sort(pos_pool)[:: 3][:n_vars]
    rng.shuffle(positions)
    snv_spec = []
    idx = 0
    for af, count in snvs:
        for _ in range(count):
            pos = int(positions[idx])
            idx += 1
            ref_b = genome[pos]
            alt_b = ref_b
            while alt_b == ref_b:
                alt_b = BASES[rng.integers(0, 4)]
            snv_spec.append((pos, int(alt_b), af))

    n_reads = genome_len * depth // read_len
    starts = np.sort(rng.integers(0, genome_len - read_len, n_reads))
    # read matrix from genome
    seqs = genome[starts[:, None] + np.arange(read_len)]
    # plant SNVs
    for pos, alt_b, af in snv_spec:
        lo = np.searchsorted(starts, pos - read_len + 1)
        hi = np.searchsorted(starts, pos, side="right")
        cover = np.arange(lo, hi)
        carry = cover[rng.random(len(cover)) < af]
        seqs[carry, pos - starts[carry]] = alt_b
    # quality + errors
    qlo, qhi = qual_range
    quals = rng.integers(qlo, qhi + 1, (n_reads, read_len)).astype(np.uint8)
    errp = 10.0 ** (-quals.astype(np.float64) / 10.0)
    err = rng.random((n_reads, read_len)) < errp
    shift = rng.integers(1, 4, (n_reads, read_len)).astype(np.uint8)
    base_idx = np.searchsorted(BASES, seqs)  # ACGT are sorted
    seqs = np.where(err, BASES[(base_idx + shift) % 4], seqs)
    flags = np.where(rng.random(n_reads) < 0.5, 16, 0).astype(np.uint16)

    # realized truth counts
    truth = []
    for pos, alt_b, af in snv_spec:
        lo = np.searchsorted(starts, pos - read_len + 1)
        hi = np.searchsorted(starts, pos, side="right")
        seg = seqs[lo:hi, :]
        offs = pos - starts[lo:hi]
        got = seg[np.arange(hi - lo), offs]
        cnt = int((got == alt_b).sum())
        truth.append((pos, chr(genome[pos]), chr(alt_b), af, "snv",
                      cnt, hi - lo))

    fa_path = f"{tmpdir}/ref.fa"
    write_fasta(fa_path, {chrom: genome.tobytes().decode()})
    bam_path = f"{tmpdir}/reads.bam"
    _bulk_write_bam(bam_path, chrom, genome_len, starts, seqs, quals, flags,
                    read_len)
    build_bai(bam_path)
    return dict(fa=fa_path, bam=bam_path, truth=truth, chrom=chrom,
                genome=genome.tobytes())


def _bulk_write_bam(path, chrom, chrom_len, starts, seqs, quals, flags,
                    read_len):
    """Encode fixed-size records for the whole read matrix in one numpy
    pass, then stream through the BGZF writer."""
    n = len(starts)
    qname_len = 12  # "r" + 10 digits + NUL
    nseq_bytes = (read_len + 1) // 2
    body_len = 32 + qname_len + 4 + nseq_bytes + read_len
    rec_len = 4 + body_len

    recs = np.zeros((n, rec_len), dtype=np.uint8)
    view32 = recs[:, :36].view(np.int32).reshape(n, 9)
    view32[:, 0] = body_len  # block_size
    view32[:, 1] = 0  # refID
    view32[:, 2] = starts
    # bins, vectorized (reads are < 16kb so almost always level-5 bins)
    beg = starts.astype(np.int64)
    end = beg + read_len - 1
    bins = np.where(
        (beg >> 14) == (end >> 14), 4681 + (beg >> 14),
        np.where((beg >> 17) == (end >> 17), 585 + (beg >> 17),
                 73 + (beg >> 20))).astype(np.uint16)
    recs[:, 12] = qname_len  # l_read_name
    recs[:, 13] = 60  # mapq
    recs[:, 14:16].view(np.uint16)[:, 0] = bins
    recs[:, 16:18].view(np.uint16)[:, 0] = 1  # n_cigar
    recs[:, 18:20].view(np.uint16)[:, 0] = flags
    view32[:, 5] = read_len  # l_seq
    view32[:, 6] = -1  # next_refID
    view32[:, 7] = -1  # next_pos
    view32[:, 8] = 0  # tlen
    # qname: fixed width r%010d
    digits = np.empty((n, 10), dtype=np.uint8)
    vals = np.arange(n)
    for d in range(10):
        digits[:, 9 - d] = (vals % 10) + ord("0")
        vals = vals // 10
    off = 36
    recs[:, off] = ord("r")
    recs[:, off + 1 : off + 11] = digits
    recs[:, off + 11] = 0
    off += qname_len
    # cigar: read_len<<4 | 0
    recs[:, off : off + 4].view(np.uint32)[:, 0] = (read_len << 4)
    off += 4
    # seq 4-bit
    codes = NT16_CODE[seqs]
    if read_len % 2:
        codes = np.concatenate(
            [codes, np.zeros((n, 1), dtype=np.uint8)], axis=1)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    recs[:, off : off + nseq_bytes] = packed
    off += nseq_bytes
    recs[:, off : off + read_len] = quals

    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [(chrom, chrom_len)])
    w = BgzfWriter(path)
    text = header.text + f"@SQ\tSN:{chrom}\tLN:{chrom_len}\n"
    tb = text.encode()
    w.write(b"BAM\x01" + struct.pack("<i", len(tb)) + tb)
    w.write(struct.pack("<i", 1))
    nb = chrom.encode() + b"\x00"
    w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", chrom_len))
    blob = recs.tobytes()
    CH = 8 << 20
    for i in range(0, len(blob), CH):
        w.write(blob[i : i + CH])
    w.close()
