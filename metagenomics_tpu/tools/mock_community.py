"""Seeded paired-end short-read mock community (2x150 bp Illumina-like).

Shape follows the CAMI I "low complexity" challenge sample as a metagenome
of ~40 genomes with log-normal abundances, 2x150 bp reads and a ~270 bp
insert; the genomes are random sequence cut to a size that fits one run.
Reads carry the substitution part of golden/make_realdata.py's error model
(0.4% per base; the N calls are left out so that read length stays
uniform and every read passes QC).  Everything is vectorised numpy, so a
million pairs take seconds.

write_fasta writes one interleaved FASTA (mates adjacent), the layout the
assembler's -pe option reads.
"""

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_BLOCK = 1 << 16          # pairs per block: bounds the temporaries


def mock_community(n_pairs, seed, n_genomes=40, read_len=150,
                   insert_mean=270, insert_sd=30, sub_rate=0.004,
                   genome_len=(500_000, 2_000_000), abundance_sigma=1.0):
    """Base codes (0..3) of n_pairs read pairs, shape [2 * n_pairs,
    read_len] uint8, mates on adjacent rows.  Deterministic in `seed`."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(genome_len[0], genome_len[1] + 1, n_genomes)
    offs = np.concatenate([[0], np.cumsum(lens)])
    genomes = rng.integers(0, 4, int(offs[-1]), dtype=np.uint8)
    abundance = rng.lognormal(0.0, abundance_sigma, n_genomes)
    weight = abundance * lens
    g = rng.choice(n_genomes, n_pairs, p=weight / weight.sum())
    ins = np.rint(rng.normal(insert_mean, insert_sd, n_pairs)).astype(np.int64)
    ins = np.clip(ins, read_len, lens[g])
    start = offs[g] + (rng.random(n_pairs) * (lens[g] - ins + 1)).astype(
        np.int64)
    flip = rng.random(n_pairs) < 0.5
    col = np.arange(read_len)
    out = np.empty((2 * n_pairs, read_len), np.uint8)
    for a in range(0, n_pairs, _BLOCK):
        b = min(a + _BLOCK, n_pairs)
        r1 = genomes[start[a:b, None] + col]
        # mate 2: reverse complement of the fragment's last read_len bases
        r2 = 3 - genomes[(start[a:b] + ins[a:b] - 1)[:, None] - col]
        # fragments from the reverse strand swap the mates
        f = flip[a:b, None]
        blk = out[2 * a:2 * b]
        blk[0::2] = np.where(f, r2, r1)
        blk[1::2] = np.where(f, r1, r2)
        err = rng.random(blk.shape) < sub_rate
        blk[err] = (blk[err] + rng.integers(1, 4, int(err.sum()),
                                            dtype=np.uint8)) % 4
    return out


def write_fasta(codes, path):
    """Write code rows as FASTA records named by row number."""
    n, width = codes.shape
    digits = max(1, len(str(n - 1)))
    rec = np.empty((n, 1 + digits + 1 + width + 1), np.uint8)
    rec[:, 0] = ord(">")
    ids = np.arange(n, dtype=np.int64)
    for d in range(digits):
        rec[:, digits - d] = 48 + (ids // 10 ** d) % 10
    rec[:, digits + 1] = ord("\n")
    rec[:, digits + 2:-1] = _ACGT[codes]
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())

