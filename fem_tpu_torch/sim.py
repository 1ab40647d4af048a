"""Synthetic genome / read simulation for tests and benchmarks.

The reference repo ships no fixtures (no test/ directory at all); its paper
validated on simulated + real Illumina reads. We generate deterministic
synthetic genomes and edit-distance-bounded reads (BASELINE.json configs:
E. coli-scale ~4.6 Mb, chr21-scale ~46 Mb, 100 bp single-end reads).

The port's copy of fem_tpu/sim.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(
    length: int,
    num_seqs: int = 1,
    seed: int = 0,
    n_fraction: float = 0.0,
    repeat_fraction: float = 0.0,
    names: List[bytes] | None = None,
) -> List[Tuple[bytes, bytes]]:
    """Returns [(name, seq_bytes)] with optional sprinkled 'N' bases.

    `repeat_fraction` approximates real-genome repeat content (GRCh38 is
    roughly half repetitive): that fraction of each sequence is built by
    re-inserting copies of earlier segments (0.5-2 kb) with ~1% point
    mutations, creating the multi-locus mapping load the ALL-mapping
    guarantee exists for.
    """
    rng = np.random.default_rng(seed)
    out = []
    per = length // num_seqs
    for i in range(num_seqs):
        codes = rng.integers(0, 4, size=per, dtype=np.int8)
        if repeat_fraction > 0:
            target = int(per * repeat_fraction)
            placed = 0
            while placed < target:
                seg_len = int(rng.integers(500, 2000))
                src = int(rng.integers(0, max(per - seg_len, 1)))
                dst = int(rng.integers(0, max(per - seg_len, 1)))
                seg = codes[src : src + seg_len].copy()
                muts = rng.random(seg_len) < 0.01
                seg[muts] = rng.integers(0, 4, size=int(muts.sum()), dtype=np.int8)
                codes[dst : dst + seg_len] = seg
                placed += seg_len
        seq = _BASES[codes.astype(np.int64)].copy()
        if n_fraction > 0:
            mask = rng.random(per) < n_fraction
            seq[mask] = ord("N")
        name = names[i] if names else b"seq%d" % i
        out.append((name, seq.tobytes()))
    return out


def satellite_genome(
    length: int,
    num_seqs: int = 1,
    seed: int = 0,
    satellite_fraction: float = 0.1,
    unit_range: Tuple[int, int] = (24, 180),
    copies_range: Tuple[int, int] = (64, 2048),
    divergence: float = 0.003,
    names: List[bytes] | None = None,
) -> List[Tuple[bytes, bytes]]:
    """Adversarial heavy-tail genome: tandem satellite arrays.

    Real genomes carry satellite/alpha-repeat arrays where a short unit
    tandem-repeats 10^2-10^5 times, so every seed of a read inside the
    array has occurrence frequency ~ the copy number — the workload the
    reference's unbounded k-way occurrence merge (src/filter.c:80-116)
    absorbs naturally and a fixed-capacity device slab does not. This
    generator overwrites `satellite_fraction` of a random genome with
    tandem arrays (unit length and copy number drawn from the given
    ranges, each copy at `divergence` point mutations), producing selected-
    seed frequencies in the 10^2-10^3+ range to exercise the capacity-
    retry ladder and, past its last tier, the exact host fallback.
    """
    rng = np.random.default_rng(seed)
    out = []
    per = length // num_seqs
    for i in range(num_seqs):
        codes = rng.integers(0, 4, size=per, dtype=np.int8)
        target = int(per * satellite_fraction)
        placed = 0
        while placed < target:
            u = int(rng.integers(unit_range[0], unit_range[1] + 1))
            c = int(rng.integers(copies_range[0], copies_range[1] + 1))
            span = min(u * c, target - placed + u, per // 4)
            if span < 2 * u:
                break
            unit = rng.integers(0, 4, size=u, dtype=np.int8)
            dst = int(rng.integers(0, per - span))
            arr = np.tile(unit, -(-span // u))[:span]
            muts = rng.random(span) < divergence
            arr[muts] = rng.integers(0, 4, size=int(muts.sum()), dtype=np.int8)
            codes[dst : dst + span] = arr
            placed += span
        seq = _BASES[codes.astype(np.int64)].copy()
        name = names[i] if names else b"sat%d" % i
        out.append((name, seq.tobytes()))
    return out


def write_fasta(path: str, seqs: List[Tuple[bytes, bytes]], width: int = 80) -> None:
    """`width` bases a line; the full lines of a sequence are written as one
    (rows, width + 1) array whose last column is the newline."""
    with open(path, "wb") as f:
        for name, seq in seqs:
            f.write(b">" + name + b"\n")
            full = len(seq) // width * width
            if full:
                rows = np.empty((full // width, width + 1), np.uint8)
                rows[:, :width] = np.frombuffer(seq, np.uint8, count=full).reshape(-1, width)
                rows[:, width] = ord("\n")
                f.write(rows.data)
            if full < len(seq):
                f.write(seq[full:] + b"\n")


_COMP = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}


def revcomp_bytes(seq: bytes) -> bytes:
    return bytes(_COMP.get(b, 78) for b in reversed(seq))


@dataclasses.dataclass
class SimulatedRead:
    name: bytes
    seq: bytes
    qual: bytes
    sid: int
    pos: int
    strand: int
    num_errors: int


def simulate_reads(
    seqs: List[Tuple[bytes, bytes]],
    num_reads: int,
    read_length: int = 100,
    max_errors: int = 2,
    indel_fraction: float = 0.2,
    seed: int = 1,
) -> List[SimulatedRead]:
    """Draw reads uniformly, apply up to `max_errors` random edits
    (substitutions and, with `indel_fraction`, 1-base indels)."""
    rng = np.random.default_rng(seed)
    reads: List[SimulatedRead] = []
    lengths = np.array([len(s) for _, s in seqs])
    probs = lengths / lengths.sum()
    for ri in range(num_reads):
        sid = int(rng.choice(len(seqs), p=probs))
        seq = seqs[sid][1]
        # Sample with slack so indels still leave `read_length` bases.
        span = read_length + max_errors
        pos = int(rng.integers(0, len(seq) - span))
        fragment = bytearray(seq[pos : pos + span])
        n_err = int(rng.integers(0, max_errors + 1))
        applied = 0
        for _ in range(n_err):
            where = int(rng.integers(0, read_length))
            if rng.random() < indel_fraction and len(fragment) > read_length:
                if rng.random() < 0.5:
                    del fragment[where]
                else:
                    fragment.insert(where, int(_BASES[rng.integers(0, 4)]))
            else:
                old = fragment[where]
                choices = [b for b in _BASES if b != old]
                fragment[where] = int(choices[int(rng.integers(0, len(choices)))])
            applied += 1
        read = bytes(fragment[:read_length])
        strand = int(rng.integers(0, 2))
        if strand:
            read = revcomp_bytes(read)
        reads.append(
            SimulatedRead(
                name=b"read%d" % ri,
                seq=read,
                qual=b"I" * read_length,
                sid=sid,
                pos=pos,
                strand=strand,
                num_errors=applied,
            )
        )
    return reads


def write_fastq(path: str, reads: List[SimulatedRead]) -> None:
    with open(path, "wb") as f:
        for r in reads:
            f.write(b"@" + r.name + b"\n" + r.seq + b"\n+\n" + r.qual + b"\n")
