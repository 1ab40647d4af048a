"""Index construction.

Behavioral spec (src/index.c:57-98): for every reference sequence, hash the
k-mer window starting at each multiple of `step_size` (while the window fits,
src/index.c:65), with ambiguous bases hashed as A (src/utils.h:83-99);
entries are (hash, seqid<<32|position). Entries are stably sorted by hash
and each hash bucket's positions are sorted ascending (src/index.c:74,93);
counts prefix-sum into the 4^k+1 CSR lookup table.

This implementation is vectorized numpy instead of a scalar loop + radix
sort: one sort of (hash, window number) keys leaves every bucket's
locations ascending — the same final layout the reference reaches with its
two radix sorts (build_index says how).

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
        return _hash_strided(codes[int(positions[0]) :], kmer_size, step, m)
    c4 = np.where(codes > 3, 0, codes).astype(np.int32)
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


def _hash_strided(codes: np.ndarray, kmer_size: int, step: int, m: int) -> np.ndarray:
    """hash_windows at positions 0, step, ..., (m - 1) * step: k shift-or
    passes over strided slices, in place in one uint32 array."""
    c4 = np.where(codes > 3, np.uint8(0), codes)
    span = (m - 1) * step + 1
    acc = np.zeros(m, np.uint32)
    for j in range(kmer_size):
        acc <<= np.uint32(2)
        acc |= c4[j : j + span : step]
    return acc


def build_index(reference: Reference, kmer_size: int, step_size: int) -> FemIndex:
    """The index of every `step_size`-th k-mer window of every chromosome.

    Window w (numbered in (seqid, position) order) becomes the key
    hash << 32 | w; keys are unique, so one ascending sort of them orders
    the windows by hash and, within a bucket, by (seqid, position): the
    layout of a stable sort by hash (src/index.c:74,93), reached with an
    in-place sort of one uint64 array instead of an indirect stable
    argsort, which dominated the build at GRCh38 scale (docs/SCALE.md r5)
    and needs an index array beside the hashes. The CSR offsets are the first key of
    each bucket, found by binary search; each window's (seqid, position)
    comes back from w (a table of seqids a window, then arithmetic).
    Besides the reference, the build holds the keys and the occurrence
    table, 8 bytes a window each, and the seqid table, 1 byte a window
    while there are at most 256 sequences."""
    lengths = [int(n) for n in reference.lengths]
    counts = np.array([len(range(0, n - kmer_size + 1, step_size)) if n >= kmer_size else 0
                       for n in lengths], np.int64)
    wstart = np.zeros(len(lengths) + 1, np.int64)  # first window of each seqid
    np.cumsum(counts, out=wstart[1:])
    total = int(wstart[-1])
    check_u32_csr(total)  # window numbers fit the key's low 32 bits below

    keys = np.empty(total, np.uint64)
    for sid, m in enumerate(counts):
        if not m:
            continue
        k = keys[wstart[sid] : wstart[sid] + m]
        k[:] = _hash_strided(reference.codes_of(sid), kmer_size, step_size, int(m))
        k <<= np.uint64(32)
        k |= np.arange(wstart[sid], wstart[sid] + m, dtype=np.uint64)
    keys.sort()
    # The seqid of every window, in the smallest type that holds them all.
    sid_of = np.repeat(np.arange(len(lengths), dtype=np.min_scalar_type(len(lengths))), counts)

    num_buckets = 1 << (2 * kmer_size)
    lookup = np.empty(num_buckets + 1, np.uint32)
    for lo in range(0, num_buckets, _CHUNK):
        hs = np.arange(lo, min(lo + _CHUNK, num_buckets), dtype=np.uint64) << np.uint64(32)
        lookup[lo : lo + hs.shape[0]] = np.searchsorted(keys, hs)
    lookup[num_buckets] = total

    # Window w of seqid s at position (w - wstart[s]) * step: its occurrence
    # s << 32 | pos is w * step + base[s], base[s] = s << 32 - wstart[s] * step.
    base = (np.arange(len(lengths), dtype=np.int64) << 32) - wstart[:-1] * step_size
    occurrences = np.empty(total, np.uint64)
    for lo in range(0, total, _CHUNK):
        w = (keys[lo : lo + _CHUNK] & np.uint64(0xFFFFFFFF)).view(np.int64)
        occ = base[sid_of[w]]
        w *= step_size
        occ += w
        occurrences[lo : lo + w.shape[0]] = occ.view(np.uint64)
    return FemIndex(kmer_size, step_size, lookup, occurrences)


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
