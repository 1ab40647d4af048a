"""Coordinate-sharded index: the genome split across devices
(fem_tpu/parallel/sharded_index.py).

For GRCh38-scale genomes the occurrence table (about 8 GB at step 3) and
the reference may outgrow one device. The index therefore splits by
reference coordinate over an `index` grid axis, while reads split over a
`data` axis (SURVEY.md §5.7).

Per shard: its local CSR (lookup and the flat int64 ``sid << 32 | pos``
occurrences of its coordinate window), its reference slice, its owned
ranges and its left-halo starts. Beside them the GLOBAL frequency table,
occurrence count and chromosome lengths: the optimal-prefix q-gram DP and
the frequency sort are decisions over the whole genome. The only
cross-shard communication of a step is the truncation bound's max and the
per-read sums and maxes (ops/step.py:map_core_steps), because the
pigeonhole vote and the greedy dedup never cross a chromosome boundary.

Results come back per (data, index) cell; the host's stable sort by lane
(ops/step.py:accepted_hits) restores the reference's per-read
candidate order, because shards hold ascending coordinate ranges.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from fem_tpu_torch.index.storage import FemIndex
from fem_tpu_torch.io.fastx import Reference
from fem_tpu_torch.ops.types import DeviceIndex, device_index_shard
from fem_tpu_torch.parallel.mesh import DeviceMesh, GridStep

_ROW_BYTES = 64  # the slices' padding rule, kept so they equal the JAX build's
_CHUNK = 1 << 26  # occurrences a pass of the sharded build takes at a time


@dataclasses.dataclass
class ShardedIndex:
    """Host-side per-shard arrays, in the port's layout."""

    num_shards: int
    ranges: List[List[tuple]]  # per shard: [(sid, start, end)] owned ranges
    halo: int  # occurrence/reference overlap beyond owned ranges (bases)
    lookup: np.ndarray  # (n, 4^k + 1) int64 local CSR
    occ: List[np.ndarray]  # per shard: (N_s,) uint64 sid << 32 | pos, CSR order
    ref_flat: List[np.ndarray]  # per shard: (T_s,) uint8 slice with sentinel gaps
    ref_offsets: np.ndarray  # (n, num_seqs) int64: ref_flat[s][off + p] = chrom[p]
    own_start: np.ndarray  # (n, num_seqs) int32 owned [start, end) per sid
    own_end: np.ndarray  # (n, num_seqs) int32 (start == end: none owned)
    halo_lo: np.ndarray  # (n, num_seqs) int32 left-halo slice start, or 2^30
    # where the slice starts at the chromosome start (no unseen left context)
    freq_table: np.ndarray  # (4^k,) int32 global frequencies
    num_occurrences: int  # global
    ref_lengths: np.ndarray  # (num_seqs,) int32 global

    def device_index(self, shard: int, device: torch.device | str) -> DeviceIndex:
        """Shard `shard` as a DeviceIndex on `device`."""
        return device_index_shard(
            self.occ[shard], self.lookup[shard], self.ref_flat[shard],
            self.ref_offsets[shard], self.own_start[shard], self.own_end[shard],
            self.halo_lo[shard], self.freq_table, self.num_occurrences,
            self.ref_lengths, device,
        )


def partition_chromosomes(lengths: np.ndarray, num_shards: int) -> List[List[int]]:
    """Contiguous, in-order partition of whole chromosomes balanced by
    length (kept for diagnostics; `partition_ranges` is what the build
    uses — it also splits inside a chromosome)."""
    total = int(lengths.sum())
    target = total / num_shards
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    remaining = len(lengths)
    for sid, ln in enumerate(lengths):
        cur.append(sid)
        acc += int(ln)
        remaining -= 1
        # Close the group when at target, keeping enough chromosomes for
        # the remaining shards.
        if (
            len(groups) < num_shards - 1
            and acc >= target * (len(groups) + 1) - total / (2 * num_shards)
            and remaining >= (num_shards - 1 - len(groups))
        ):
            groups.append(cur)
            cur = []
    groups.append(cur)
    while len(groups) < num_shards:
        groups.append([])  # tolerate more shards than chromosomes
    return groups


def partition_ranges(lengths: np.ndarray, num_shards: int) -> List[List[tuple]]:
    """Equal-bases contiguous partition of the concatenated genome into
    coordinate ranges, splitting INSIDE chromosomes when needed — so a
    single huge chromosome (GRCh38 chr1, 248 Mb) spreads over shards
    instead of pinning its whole occurrence mass to one device. Returns
    per-shard [(sid, start, end)] pieces, in order, disjoint, covering."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    out: List[List[tuple]] = []
    for k in range(num_shards):
        lo = total * k // num_shards
        hi = total * (k + 1) // num_shards
        pieces = []
        for sid in range(len(lengths)):
            s = max(lo, int(bounds[sid]))
            e = min(hi, int(bounds[sid + 1]))
            if s < e:
                pieces.append((sid, s - int(bounds[sid]), e - int(bounds[sid])))
        out.append(pieces)
    return out


def build_sharded_index(
    index: FemIndex,
    reference: Reference,
    num_shards: int,
    gap: int = 256,
    halo: int = 4096,
) -> ShardedIndex:
    """Shard occurrences + reference by coordinate range with a `halo`
    overlap: shard s stores occurrences and reference for [start - halo,
    end + halo) of each owned piece, so candidate generation, the
    pigeonhole vote, the greedy ±e dedup, and banded verification of every
    OWNED candidate are shard-local (reads longer than halo - 2e are
    rejected by the engine). Candidates outside the owned ranges are dropped
    after dedup (each global candidate is owned exactly once); reads with
    candidates in the first e positions of a mid-chromosome slice go to
    the exact host mapper, since the local dedup fold cannot prove the
    unseen pre-halo carry irrelevant there (ops/candidates.py)."""
    lengths = reference.lengths.astype(np.int64)
    shard_ranges = partition_ranges(lengths, num_shards)
    num_seqs = reference.num_seqs

    own_start = np.zeros((num_shards, num_seqs), np.int32)
    own_end = np.zeros((num_shards, num_seqs), np.int32)
    halo_lo = np.full((num_shards, num_seqs), 2**30, np.int32)
    for s, pieces in enumerate(shard_ranges):
        for sid, rs, re in pieces:
            own_start[s, sid] = rs
            own_end[s, sid] = re
            if rs - halo > 0:
                halo_lo[s, sid] = rs - halo

    # Shard membership by concatenated-genome coordinate: two compares per
    # occurrence per shard. The window may pull in a neighbouring
    # chromosome's tail or head where a cut abuts a chromosome boundary:
    # harmless, those candidates are never owned, and a carry of another
    # sid never suppresses a kept candidate in the greedy fold. The table
    # goes by in chunks, so no whole-table temporary is made: at GRCh38
    # scale (1e9 occurrences) each would be 8 GB of host memory.
    occ_all = np.asarray(index.occurrences, np.uint64)
    glookup = np.asarray(index.lookup, np.int64)
    nbuckets = glookup.shape[0] - 1
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    total = int(lengths.sum())
    cuts = [(total * s // num_shards - halo, total * (s + 1) // num_shards + halo)
            for s in range(num_shards)]
    counts = np.zeros((num_shards, nbuckets), np.int64)
    parts: List[List[np.ndarray]] = [[] for _ in range(num_shards)]
    for lo in range(0, occ_all.shape[0], _CHUNK):
        occ = occ_all[lo : lo + _CHUNK]
        hi = lo + occ.shape[0]
        # The bucket of each occurrence of the chunk, from the CSR.
        b0 = int(np.searchsorted(glookup, lo, side="right")) - 1
        b1 = int(np.searchsorted(glookup, hi, side="left"))
        runs = np.diff(np.clip(glookup[b0 : b1 + 1], lo, hi))
        hash_of = np.repeat(np.arange(b0, b1, dtype=np.int64), runs)
        gpos = bounds[(occ >> np.uint64(32)).astype(np.int64)]
        gpos += (occ & np.uint64(0xFFFFFFFF)).astype(np.int64)
        for s, (cut_lo, cut_hi) in enumerate(cuts):
            mask = (gpos >= cut_lo) & (gpos < cut_hi)
            counts[s] += np.bincount(hash_of[mask], minlength=nbuckets)
            parts[s].append(occ[mask])  # occurrence order kept: bucket-sorted
    lookups = np.zeros((num_shards, nbuckets + 1), np.int64)
    np.cumsum(counts, axis=1, out=lookups[:, 1:])
    del counts
    occs = []
    for s in range(num_shards):
        occs.append(np.concatenate(parts[s]) if parts[s] else np.empty(0, np.uint64))
        parts[s] = None

    # Reference slices (leading and trailing sentinel gaps). Slice [lo, hi)
    # of chromosome `sid` lands at flat position `pos`, so its offset is
    # pos - lo, negative where the slice starts far into the chromosome.
    flats = []
    offsets = np.zeros((num_shards, num_seqs), np.int64)
    for s, pieces in enumerate(shard_ranges):
        spans = [(sid, max(rs - halo, 0), min(re + halo, int(lengths[sid])))
                 for sid, rs, re in pieces]
        size = gap + sum(hi - lo + gap for _, lo, hi in spans)
        size += (-size) % _ROW_BYTES + _ROW_BYTES
        flat = np.full(size, 4, np.uint8)
        pos = gap
        for sid, lo, hi in spans:
            offsets[s, sid] = pos - lo
            flat[pos : pos + hi - lo] = reference.codes_of(sid)[lo:hi]
            pos += hi - lo + gap
        flats.append(flat)

    return ShardedIndex(
        num_shards=num_shards,
        ranges=shard_ranges,
        halo=halo,
        lookup=lookups,
        occ=occs,
        ref_flat=flats,
        ref_offsets=offsets,
        own_start=own_start,
        own_end=own_end,
        halo_lo=halo_lo,
        freq_table=np.diff(index.lookup.astype(np.int32)),
        num_occurrences=index.num_occurrences,
        ref_lengths=reference.lengths.astype(np.int32),
    )


def make_index_sharded_map_fn(
    mesh: DeviceMesh,
    params,
    verify_cap_per_shard: int,
    accept_cap_per_shard: int,
    gather_rows: bool = False,
) -> GridStep:
    """The step over a ("data", "index") grid
    (fem_tpu/parallel/sharded_index.py:make_index_sharded_map_fn): reads
    split over `data`, the index over `index`, the whole mapping step per
    cell, the cells of a data row reduced together between its three
    segments. With `gather_rows` (a grid over processes) lanes stay
    row-local, [0, 2 * Bloc), so a row's segments unpack like a one-row
    batch once the drain has gathered them; otherwise they are globalized
    over the batch."""
    return GridStep(mesh, params, verify_cap_per_shard, accept_cap_per_shard,
                    globalize_lanes=not gather_rows)
