"""Seeded read simulator for the benchmark: reads, BAM, BAI and FASTA.

A frozen copy of the port's `testing/simulate_fast.py` with two changes
that shorten a run's set-up: the BAI is written from the record offsets
the encoder already knows (no second pass that decodes every record), and
the BGZF blocks are compressed on all of the host's cores.  It imports
nothing of the program.

Two read layouts, both SNVs only, fixed read length, no indels:
  * `uniform`: reads start uniformly over the genome, either strand; the
    draws are simulate_fast's, so its BAM and BAI are simulate_fast's
    byte for byte (portbench/tests).
  * `amplicon`: a tiled amplicon scheme; each read covers one end of one
    amplicon (forward from its start, reverse from its end), the
    amplicons' shares of the depth the quantiles of a lognormal, so that
    every seed makes the same work in another order.

`draw_*` return the reads as arrays (the reference reads them from
there); `write_sample` writes ref.fa, reads.bam and reads.bam.bai.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from statistics import NormalDist

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
NT16_CODE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    NT16_CODE[ord(_c)] = _i

BLOCK_PAYLOAD = 65280           # htslib's BGZF block payload
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
PSEUDO_BIN = 37450
LINEAR_SHIFT = 14
QNAME_LEN = 12                  # "r" + 10 digits + NUL


def _plant(genome, rng, snvs, margin, lo=None, hi=None):
    """[(pos, alt code, af)] drawn as simulate_fast draws them: positions
    from every third of a sorted pool, so no two are adjacent."""
    n_vars = sum(n for _af, n in snvs)
    lo = margin if lo is None else lo
    hi = len(genome) - margin if hi is None else hi
    pool = rng.choice(np.arange(lo, hi), n_vars * 3, replace=False)
    positions = np.sort(pool)[::3][:n_vars]
    rng.shuffle(positions)
    spec, idx = [], 0
    for af, count in snvs:
        for _ in range(count):
            pos = int(positions[idx])
            idx += 1
            ref_b = genome[pos]
            alt_b = ref_b
            while alt_b == ref_b:
                alt_b = BASES[rng.integers(0, 4)]
            spec.append((pos, int(alt_b), af))
    return spec


_ERRP = 10.0 ** (-np.arange(256, dtype=np.float64) / 10.0)
_ERRP32 = _ERRP.astype(np.float32)
_CODE4 = np.zeros(256, np.int64)
_CODE4[BASES] = np.arange(4)


def _errors(rng, seqs, qual_range):
    """Quals and sequencing errors of a read matrix, simulate_fast's
    draws (tables in place of its per-base power and search): returns
    (seqs with errors, quals)."""
    n, read_len = seqs.shape
    qlo, qhi = qual_range
    quals = rng.integers(qlo, qhi + 1, (n, read_len)).astype(np.uint8)
    err = rng.random((n, read_len)) < _ERRP[quals]
    shift = rng.integers(1, 4, (n, read_len)).astype(np.uint8)
    seqs = seqs.copy()
    seqs[err] = BASES[(_CODE4[seqs[err]] + shift[err]) % 4]
    return seqs, quals


def _rows(genome, starts, read_len):
    """[n, read_len] copy of the genome under each read."""
    return np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]


def _carry(rng, seqs, starts, read_len, spec):
    """Plant each SNV in the reads over it, each with probability af."""
    for pos, alt_b, af in spec:
        lo = np.searchsorted(starts, pos - read_len + 1)
        hi = np.searchsorted(starts, pos, side="right")
        cover = np.arange(lo, hi)
        carry = cover[rng.random(len(cover)) < af]
        seqs[carry, pos - starts[carry]] = alt_b


def draw_uniform(seed, genome_len, depth, read_len, snvs, qual_range):
    """simulate_fast's draws: genome, SNVs, reads, quals, strands."""
    rng = np.random.default_rng(seed)
    genome = BASES[rng.integers(0, 4, genome_len)]
    spec = _plant(genome, rng, snvs, read_len + 10)
    n_reads = genome_len * depth // read_len
    starts = np.sort(rng.integers(0, genome_len - read_len, n_reads))
    seqs = _rows(genome, starts, read_len)
    _carry(rng, seqs, starts, read_len, spec)
    seqs, quals = _errors(rng, seqs, qual_range)
    flags = np.where(rng.random(n_reads) < 0.5, 16, 0).astype(np.uint16)
    return dict(genome=genome, starts=starts, seqs=seqs, quals=quals,
                flags=flags, snvs=spec)


def amplicon_starts(genome_len, n_amplicons, amplicon_len, flank):
    """Start of each amplicon of a scheme tiled evenly from `flank` to
    genome_len - flank."""
    return np.round(np.linspace(flank, genome_len - flank - amplicon_len,
                                n_amplicons)).astype(np.int64)


def amplicon_shares(n_amplicons, share_sigma):
    """The amplicons' shares of the depth: the n quantiles of a lognormal
    of sigma share_sigma, summing to 1, smallest first."""
    z = [NormalDist().inv_cdf((i + 0.5) / n_amplicons)
         for i in range(n_amplicons)]
    share = np.exp(share_sigma * np.asarray(z))
    return share / share.sum()


def draw_amplicon(seed, genome_seed, genome_len, depth, read_len, snvs,
                  qual_range, n_amplicons, amplicon_len, flank, share_sigma):
    """One sample of an amplicon scheme.  The genome comes from
    genome_seed (shared by a cohort's samples).  Every seed gets the same
    work in another order: the same amplicon shares (permuted over the
    amplicons), the same read count per share, and each SNV at the same
    share rank, in the middle of its amplicon where both ends' reads
    cover it.  `seed` draws the permutation, the SNVs' positions there and
    their bases, each read's end, errors and quals.  depth is the
    sample's mean depth over the genome."""
    genome = BASES[np.random.default_rng(genome_seed)
                   .integers(0, 4, genome_len)]
    rng = np.random.default_rng(seed)
    amp = amplicon_starts(genome_len, n_amplicons, amplicon_len, flank)
    n_reads = genome_len * depth // read_len
    share = amplicon_shares(n_amplicons, share_sigma)
    exact = share * n_reads
    per_rank = np.floor(exact).astype(np.int64)
    rest = np.argsort(per_rank - exact, kind="stable")[:n_reads - per_rank.sum()]
    per_rank[rest] += 1
    rank_of = rng.permutation(n_amplicons)          # amplicon -> share rank
    amp_of = np.repeat(np.arange(n_amplicons), per_rank[rank_of])
    reverse = rng.random(n_reads) < 0.5
    starts = amp[amp_of] + np.where(reverse, amplicon_len - read_len, 0)
    order = np.argsort(starts, kind="stable")
    starts, reverse = starts[order], reverse[order]
    # SNV k sits in the amplicon of share rank ranks[k], the same on
    # every seed, between the two ends' reads' inner edges
    n_vars = sum(n for _af, n in snvs)
    ranks = np.round(np.linspace(0, n_amplicons - 1, n_vars)).astype(int)
    ranks = ranks[np.random.default_rng(0).permutation(n_vars)]
    amp_at = np.argsort(rank_of)[ranks]
    lo = amplicon_len - read_len
    pos = amp[amp_at] + lo + rng.integers(0, read_len - lo, n_vars)
    spec, k = [], 0
    for af, count in snvs:
        for _ in range(count):
            ref_b = genome[pos[k]]
            alt_b = ref_b
            while alt_b == ref_b:
                alt_b = BASES[rng.integers(0, 4)]
            spec.append((int(pos[k]), int(alt_b), af))
            k += 1
    seqs = _rows(genome, starts, read_len)
    _carry(rng, seqs, starts, read_len, sorted(spec))
    qlo, qhi = qual_range
    quals = rng.integers(qlo, qhi + 1, seqs.shape, dtype=np.uint8)
    err = rng.random(seqs.shape, dtype=np.float32) < _ERRP32[quals]
    shift = rng.integers(1, 4, int(err.sum()), dtype=np.int64)
    seqs[err] = BASES[(_CODE4[seqs[err]] + shift) % 4]
    flags = np.where(reverse, 16, 0).astype(np.uint16)
    return dict(genome=genome, starts=starts, seqs=seqs, quals=quals,
                flags=flags, snvs=spec)


# ---------------------------------------------------------------------------
# BAM, BAI, FASTA
# ---------------------------------------------------------------------------

def write_fasta(path, chrom, genome, width=60):
    seq = genome.tobytes()
    lines = [seq[i:i + width] for i in range(0, len(seq), width)]
    with open(path, "wb") as fh:
        fh.write(b">" + chrom.encode() + b"\n" + b"\n".join(lines) + b"\n")


def _records(starts, seqs, quals, flags):
    """Fixed-size BAM records of the whole read matrix, [n, rec_len]."""
    n, read_len = seqs.shape
    nseq_bytes = (read_len + 1) // 2
    body_len = 32 + QNAME_LEN + 4 + nseq_bytes + read_len
    recs = np.zeros((n, 4 + body_len), dtype=np.uint8)
    v32 = recs[:, :36].view(np.int32).reshape(n, 9)
    v32[:, 0] = body_len
    v32[:, 1] = 0
    v32[:, 2] = starts
    recs[:, 12] = QNAME_LEN
    recs[:, 13] = 60
    recs[:, 14:16].view(np.uint16)[:, 0] = reg2bin(starts, read_len)
    recs[:, 16:18].view(np.uint16)[:, 0] = 1
    recs[:, 18:20].view(np.uint16)[:, 0] = flags
    v32[:, 5] = read_len
    v32[:, 6] = -1
    v32[:, 7] = -1
    v32[:, 8] = 0
    vals = np.arange(n)
    off = 36
    recs[:, off] = ord("r")
    for d in range(10):
        recs[:, off + 10 - d] = (vals % 10) + ord("0")
        vals = vals // 10
    off += QNAME_LEN
    recs[:, off:off + 4].view(np.uint32)[:, 0] = read_len << 4
    off += 4
    codes = NT16_CODE[seqs]
    if read_len % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    recs[:, off:off + nseq_bytes] = (codes[:, 0::2] << 4) | codes[:, 1::2]
    off += nseq_bytes
    recs[:, off:off + read_len] = quals
    return recs


def reg2bin(beg, read_len):
    """UCSC bin of reads [beg, beg + read_len), vectorized."""
    beg = np.asarray(beg, np.int64)
    end = beg + read_len - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out.astype(np.uint16)


def _deflate(payload: bytes, level: int) -> list:
    """[(block bytes, payload length)]: one BGZF block, or several when
    the payload does not compress (the port's writer splits in halves)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    bsize = len(cdata) + 26
    if bsize > 65536:
        half = len(payload) // 2
        return _deflate(payload[:half], level) + _deflate(payload[half:],
                                                           level)
    head = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66,
                       67, 2, bsize - 1)
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload))
    return [(head + cdata + tail, len(payload))]


def write_bam(path, chrom, chrom_len, starts, seqs, quals, flags, level=6,
              threads=None):
    """reads.bam and reads.bam.bai for coordinate-sorted fixed-length
    reads.  The index is built from the offsets of the records as they
    are laid into blocks."""
    read_len = seqs.shape[1]
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{chrom_len}\n"
            .encode())
    name = chrom.encode() + b"\x00"
    head = (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 1) + struct.pack("<i", len(name)) + name
            + struct.pack("<i", chrom_len))
    recs = _records(starts, seqs, quals, flags)
    rec_len = recs.shape[1]
    stream = memoryview(head + recs.tobytes())
    del recs
    n_blocks = -(-len(stream) // BLOCK_PAYLOAD)
    threads = threads or os.cpu_count() or 1
    with ThreadPoolExecutor(threads) as ex:
        parts = list(ex.map(
            lambda b: _deflate(bytes(stream[b * BLOCK_PAYLOAD:
                                            (b + 1) * BLOCK_PAYLOAD]),
                               level), range(n_blocks)))
    blocks = [blk for part in parts for blk in part]
    plen = np.array([n for _b, n in blocks], np.int64)
    clen = np.array([len(b) for b, _n in blocks], np.int64)
    with open(path, "wb") as fh:
        for b, _n in blocks:
            fh.write(b)
        fh.write(BGZF_EOF)
        fh.flush()
        # on disk before the measured window: no write-back runs in it
        os.fsync(fh.fileno())
    pstart = np.concatenate([[0], np.cumsum(plen)[:-1]])
    cstart = np.concatenate([[0], np.cumsum(clen)[:-1]])
    u = len(head) + np.arange(len(starts) + 1, dtype=np.int64) * rec_len
    voff = _voffsets(u, pstart, cstart, plen)
    _write_bai(str(path) + ".bai", starts, read_len, voff[:-1], voff[1:])


def _voffsets(u, pstart, cstart, plen):
    """Virtual offsets of uncompressed stream positions u as a reader
    reports them: a position at a block boundary belongs to the end of the
    block before it."""
    b = np.searchsorted(pstart, u, side="right") - 1
    within = u - pstart[b]
    back = (within == 0) & (b > 0)
    b = np.where(back, b - 1, b)
    within = np.where(back, plen[b], within)
    return (cstart[b] << 16) | within


def _write_bai(path, starts, read_len, vbeg, vend):
    starts = np.asarray(starts, np.int64)
    bins = reg2bin(starts, read_len).astype(np.int64)
    # chunks: runs of consecutive records in one bin (the indexer joins a
    # record to its bin's last chunk only when that chunk ends where the
    # record begins)
    brk = np.nonzero(np.diff(bins))[0] + 1
    run_lo = np.concatenate([[0], brk])
    run_hi = np.concatenate([brk, [len(bins)]]) - 1
    chunks = {}
    for lo, hi in zip(run_lo, run_hi):
        chunks.setdefault(int(bins[lo]), []).append(
            (int(vbeg[lo]), int(vend[hi])))
    # linear index: the first record overlapping each 16 kb window, then
    # empty windows take the offset before them
    last = starts + read_len - 1
    n_win = int(last.max() >> LINEAR_SHIFT) + 1
    win = np.arange(n_win, dtype=np.int64)
    j = np.searchsorted(last, win << LINEAR_SHIFT, side="left")
    jc = np.minimum(j, len(starts) - 1)
    hit = (j < len(starts)) & ((starts[jc] >> LINEAR_SHIFT) <= win)
    lin = np.where(hit, vbeg[jc], 0).astype(np.int64)
    lin = np.maximum.accumulate(lin)
    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", 1)
    out += struct.pack("<i", len(chunks) + 1)
    for b in sorted(chunks):
        out += struct.pack("<Ii", b, len(chunks[b]))
        for cb, ce in chunks[b]:
            out += struct.pack("<QQ", cb, ce)
    out += struct.pack("<Ii", PSEUDO_BIN, 2)
    out += struct.pack("<QQQQ", int(vbeg[0]), int(vend[-1]), len(starts), 0)
    out += struct.pack("<i", n_win)
    out += lin.astype("<u8").tobytes()
    out += struct.pack("<Q", 0)
    with open(path, "wb") as fh:
        fh.write(out)


def write_sample(dirpath, chrom, reads, level=6, threads=None):
    """ref.fa, reads.bam and reads.bam.bai of one drawn sample."""
    os.makedirs(dirpath, exist_ok=True)
    genome = reads["genome"]
    write_fasta(os.path.join(dirpath, "ref.fa"), chrom, genome)
    write_bam(os.path.join(dirpath, "reads.bam"), chrom, len(genome),
              reads["starts"], reads["seqs"], reads["quals"], reads["flags"],
              level=level, threads=threads)
