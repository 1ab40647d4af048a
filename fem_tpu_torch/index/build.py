"""Index construction.

Behavioral spec (src/index.c:57-98): for every reference sequence, hash the
k-mer window starting at each multiple of `step_size` (while the window fits,
src/index.c:65), with ambiguous bases hashed as A (src/utils.h:83-99);
entries are (hash, seqid<<32|position). Entries are stably sorted by hash
and each hash bucket's positions are sorted ascending (src/index.c:74,93);
counts prefix-sum into the 4^k+1 CSR lookup table.

This implementation is vectorized numpy instead of a scalar loop + radix
sort. Because entries are generated in (seqid, position) ascending order, a
single stable argsort by hash leaves every bucket's locations ascending —
the same final layout the reference reaches with its two radix sorts.

The port's copy of fem_tpu/index/build.py.
"""

from __future__ import annotations

import numpy as np

from fem_tpu_torch.index.storage import FemIndex
from fem_tpu_torch.io.fastx import Reference

_CHUNK = 1 << 24


def hash_windows(codes: np.ndarray, kmer_size: int, positions: np.ndarray) -> np.ndarray:
    """Hash k-mers at `positions` of an encoded sequence.

    hash = sum_j code4[p+j] << 2*(k-1-j) with ambiguous bases (code 4)
    treated as A=0 — identical to hash_seed_in_sequence (src/utils.h:83-99).
    Positions must satisfy p + k <= len(codes).

    When positions form a uniform arithmetic progression (the index-build
    case: every step_size bases), the window matrix is k strided slices of
    the code array, so the hash is k shift-or passes with no gather — 23x
    faster than the (m, k) gather @ weights formulation it replaces
    (measured 0.72 s vs 16.5 s for the 15.3 M windows of a 46 Mb genome;
    the gather pass, not the sort, dominated the 1101 s GRCh38-scale
    build recorded in docs/SCALE.md). Non-uniform positions (unit tests,
    arbitrary probes) take the gather path.
    """
    c4 = np.where(codes > 3, 0, codes).astype(np.int32)
    m = positions.shape[0]
    if m >= 2:
        step = int(positions[1] - positions[0])
        uniform = step > 0 and bool(
            (np.diff(positions) == step).all()
        )
    else:
        uniform = m == 1
        step = 1
    if uniform and m:
        lo = int(positions[0])
        hi = lo + int(positions[-1] - positions[0]) + 1
        acc = np.zeros(m, np.int32)
        for j in range(kmer_size):
            acc = (acc << 2) | c4[lo + j : hi + j : step]
        return acc.astype(np.uint32)
    weights = (1 << (2 * np.arange(kmer_size - 1, -1, -1, dtype=np.int64))).astype(
        np.int32
    )
    out = np.empty(m, dtype=np.uint32)
    for lo in range(0, m, _CHUNK):
        p = positions[lo : lo + _CHUNK]
        # (m, k) gather then dot; values < 4^k <= 2^30 so int32 is exact.
        win = c4[p[:, None] + np.arange(kmer_size)]
        out[lo : lo + _CHUNK] = (win @ weights).astype(np.uint32)
    return out


def build_index(reference: Reference, kmer_size: int, step_size: int) -> FemIndex:
    all_hashes = []
    all_locations = []
    for sid in range(reference.num_seqs):
        length = int(reference.lengths[sid])
        if length < kmer_size:
            continue
        positions = np.arange(0, length - kmer_size + 1, step_size, dtype=np.int64)
        hashes = hash_windows(reference.codes_of(sid), kmer_size, positions)
        all_hashes.append(hashes)
        all_locations.append((np.uint64(sid) << np.uint64(32)) | positions.astype(np.uint64))
    if all_hashes:
        hashes = np.concatenate(all_hashes)
        locations = np.concatenate(all_locations)
    else:
        hashes = np.empty(0, dtype=np.uint32)
        locations = np.empty(0, dtype=np.uint64)

    # Stable sort by hash; original order is (seqid, position) ascending, so
    # every bucket's locations come out ascending (matches src/index.c:93).
    order = np.argsort(hashes, kind="stable")
    occurrences = locations[order]

    num_buckets = 1 << (2 * kmer_size)
    counts = np.bincount(hashes.astype(np.int64), minlength=num_buckets).astype(
        np.uint64
    )
    lookup = np.zeros(num_buckets + 1, dtype=np.uint64)
    np.cumsum(counts, out=lookup[1:])
    check_u32_csr(int(lookup[-1]))
    return FemIndex(kmer_size, step_size, lookup.astype(np.uint32), occurrences)


def check_u32_csr(total_occurrences: int) -> None:
    """Loud guard on the u32 CSR ceiling (the reference stores u32 lookup
    rows, src/index.c:77-96; our device tables are u32 too). The recorded
    plan for larger genomes is docs/SCALE.md 'Beyond the u32 CSR
    ceiling' — int64 global build + per-shard-LOCAL u32 offsets."""
    if total_occurrences >= (1 << 32):
        raise ValueError(
            f"occurrence table ({total_occurrences:,} occurrences) exceeds "
            "the uint32 CSR range (2^32-1). A genome this size needs the "
            "coordinate-sharded index with per-shard-LOCAL u32 CSR offsets "
            "(each shard's occurrence count stays < 2^32) and an int64 "
            "global build — see docs/SCALE.md 'Beyond the u32 CSR ceiling' "
            "for the recorded plan. Workarounds today: a larger step_size "
            "(README.md:32 memory/sensitivity trade-off) or splitting the "
            "reference."
        )
