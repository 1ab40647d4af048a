"""The benchmark's reads: a pool of distinct reads made from the seed by a
traffic mix's parameters, written as the FASTQ file the command line reads.

Genome reads follow the error model of wgsim (samtools' read simulator,
https://github.com/lh3/wgsim), whose parameters the mix names, drawn for
the whole pool at once: a chromosome in proportion to its length, a
uniform start; Binomial(`read_length`, `mutation_rate`) variants, each an
indel with probability `indel_fraction` (a deletion or an insertion of
random bases, evenly, of 1 + Geometric(`indel_extend`) bases, at most
MAX_INDEL) or else a substitution by one of the three other bases, at a
uniform position among the first `read_length`; the first `read_length`
bases, reverse-complemented on a fair coin; then each base replaced by one
of the other three with probability `base_error_rate` (wgsim's sequencing
errors). Two departures from wgsim: a read's variants are its own (wgsim
draws them once, on a haplotype that its reads share), and an indel is at
most MAX_INDEL bases. A share 1 - `human_share` of the pool are instead
uniform random bases (reads of no genome, as in host depletion). Names
are the read's number in the pool, NAME_DIGITS digits; every quality is
the mix's `quality` character (wgsim writes one, from its error rate).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from fembench.genome import CHARS

NAME_DIGITS = 8
MAX_INDEL = 8
BLOCK = 1 << 16  # reads a vectorised step handles at once


@dataclasses.dataclass
class Pool:
    """The reads, in pool order. `codes` (n, L) uint8 0..3; for genome reads
    where they came from (`sid`, `pos`, `strand`; sid -1 for random reads),
    the edits drawn (`edits`: sequencing errors, substitutions and indel
    bases, a bound on the read's edit distance from its origin; `indels`:
    indel variants), and the quality character."""

    codes: np.ndarray
    sid: np.ndarray
    pos: np.ndarray
    strand: np.ndarray
    edits: np.ndarray
    indels: np.ndarray
    quality: bytes

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    def names(self, lo: int, hi: int) -> np.ndarray:
        """Reads [lo, hi)'s names as an (n, NAME_DIGITS) array of digit chars."""
        idx = np.arange(lo, hi, dtype=np.int64)[:, None]
        power = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
        return (idx // power % 10 + ord("0")).astype(np.uint8)

    def chars(self, lo: int, hi: int) -> np.ndarray:
        return CHARS[self.codes[lo:hi]]

    def quals(self, lo: int, hi: int) -> bytes:
        return self.quality * ((hi - lo) * self.codes.shape[1])


def genome_reads(rng, flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray, n: int,
                 mix: dict) -> tuple:
    """n reads of the genome whose codes lie at `flat[starts[s]:][:lengths[s]]`:
    (codes, sid, pos, strand, edits, indels)."""
    L = int(mix["read_length"])
    variants = rng.binomial(L, float(mix["mutation_rate"]), size=n)
    most = int(variants.max(initial=0))
    width = L + MAX_INDEL * most  # room for every variant to be a deletion
    sid = rng.choice(lengths.shape[0], size=n, p=lengths / lengths.sum())
    pos = rng.integers(0, lengths[sid] - width)
    buf = np.empty((n, width), np.uint8)
    for lo in range(0, n, BLOCK):
        at = (starts[sid[lo: lo + BLOCK]] + pos[lo: lo + BLOCK])[:, None]
        buf[lo: lo + BLOCK] = flat[at + np.arange(width)]
    edits = np.zeros(n, np.int64)
    indels = np.zeros(n, np.int64)
    col = np.arange(width)[None, :]
    for k in range(most):
        act = np.flatnonzero(variants > k)
        where = rng.integers(0, L, size=act.size)
        indel = rng.random(act.size) < float(mix["indel_fraction"])
        delete = rng.random(act.size) < 0.5
        size = np.minimum(rng.geometric(1.0 - float(mix["indel_extend"]), size=act.size),
                          MAX_INDEL)
        shift = rng.integers(1, 4, size=act.size, dtype=np.uint8)
        rows, w, d = act[indel], where[indel][:, None], size[indel][:, None]
        dele = delete[indel][:, None]
        src = np.where(dele, col + d * (col >= w), col - d * (col >= w + d))
        moved = np.take_along_axis(buf[rows], np.minimum(src, width - 1), axis=1)
        new = ~dele & (col >= w) & (col < w + d)
        moved[new] = rng.integers(0, 4, size=int(new.sum()), dtype=np.uint8)
        buf[rows] = moved
        indels[rows] += 1
        edits[rows] += size[indel]
        rows, w = act[~indel], where[~indel]
        buf[rows, w] = (buf[rows, w] + shift[~indel]) % 4
        edits[rows] += 1
    codes = np.ascontiguousarray(buf[:, :L])
    strand = rng.integers(0, 2, size=n)
    rc = strand == 1
    codes[rc] = 3 - codes[rc, ::-1]
    rate = float(mix["base_error_rate"])
    for lo in range(0, n, BLOCK):
        block = codes[lo: lo + BLOCK]
        err = rng.random(block.shape, dtype=np.float32) < rate
        shift = rng.integers(1, 4, size=block.shape, dtype=np.uint8)
        block[err] = (block[err] + shift[err]) % 4
        edits[lo: lo + BLOCK] += err.sum(1)
    return codes, sid, pos, strand, edits, indels


def make_pool(traffic: dict, flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
              batch_size: int, seed: int) -> Pool:
    """The pool of a traffic mix: at least `pool_reads` reads, rounded up to
    whole batches; `human_share` of them genome reads, the rest random,
    in an order drawn from the seed (every seed: the same counts)."""
    n = -(-int(traffic["pool_reads"]) // batch_size) * batch_size
    L = int(traffic["read_length"])
    quality = traffic["quality"].encode()
    rng = np.random.default_rng([seed, 2])
    n_human = int(round(n * float(traffic["human_share"])))
    human = genome_reads(rng, flat, starts, lengths, n_human, traffic)
    if n_human == n:
        return Pool(*human, quality)
    m = n - n_human
    order = rng.permutation(n)
    other = (rng.integers(0, 4, size=(m, L), dtype=np.uint8), np.full(m, -1),
             np.zeros(m, np.int64), np.zeros(m, np.int64), np.zeros(m, np.int64),
             np.zeros(m, np.int64))
    return Pool(*(np.concatenate([a, b])[order] for a, b in zip(human, other)), quality)


def write_fastq(pool: Pool, path: str) -> int:
    """The pool as a FASTQ file in pool order, a record of NAME_DIGITS + 2
    * read_length + 6 bytes a read, synced to its disk; returns the bytes
    written."""
    L = pool.codes.shape[1]
    at = np.cumsum([0, 1, NAME_DIGITS, 1, L, 3, L])  # @ name \n seq \n+\n qual \n
    written = 0
    with open(path, "wb") as f:
        for lo in range(0, pool.size, BLOCK):
            hi = min(lo + BLOCK, pool.size)
            rec = np.empty((hi - lo, NAME_DIGITS + 2 * L + 6), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, at[1]:at[2]] = pool.names(lo, hi)
            rec[:, at[2]] = ord("\n")
            rec[:, at[3]:at[4]] = pool.chars(lo, hi)
            rec[:, at[4]:at[5]] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, at[5]:at[6]] = pool.quality[0]
            rec[:, at[6]] = ord("\n")
            f.write(rec.tobytes())
            written += rec.size
        f.flush()
        os.fsync(f.fileno())  # written back now, in set-up, not during the window
    return written
