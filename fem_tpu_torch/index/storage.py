"""Index container and binary serialization.

The on-disk format is bit-compatible with the reference index file
(src/index.c:100-168): little-endian
    int32  kmer_size
    int32  step_size
    uint32 lookup_table[4^k + 1]     (CSR offsets into the occurrence table)
    uint64 occurrence_table_size     (size_t)
    uint64 occurrence_table[...]     (seqid << 32 | position, bucket-sorted)

Lookup semantics (src/index.h:22-28): frequency of hash h is
lookup[h+1] - lookup[h]; its occurrences are occ[lookup[h] : lookup[h+1]].
The table is an exact 4^k direct-address map — no probing, no collisions.

The port's copy of fem_tpu/index/storage.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FemIndex:
    kmer_size: int
    step_size: int
    lookup: np.ndarray  # (4^k + 1,) uint32 CSR offsets
    occurrences: np.ndarray  # (n,) uint64: seqid << 32 | position

    @property
    def num_occurrences(self) -> int:
        return int(self.occurrences.shape[0])

    def frequency(self, h: int) -> int:
        return int(self.lookup[h + 1] - self.lookup[h])

    def occurrences_of(self, h: int) -> np.ndarray:
        return self.occurrences[self.lookup[h] : self.lookup[h + 1]]

    def split_sid_pos(self) -> tuple[np.ndarray, np.ndarray]:
        """Occurrence table as (seqid, position) int32 pairs for the device
        (TPU-friendly: avoids emulated 64-bit integer ops)."""
        sid = (self.occurrences >> 32).astype(np.int32)
        pos = (self.occurrences & 0xFFFFFFFF).astype(np.int32)
        return sid, pos


def save_index(index: FemIndex, path: str) -> None:
    with open(path, "wb") as f:
        np.array([index.kmer_size, index.step_size], dtype="<i4").tofile(f)
        index.lookup.astype("<u4", copy=False).tofile(f)
        np.array([index.num_occurrences], dtype="<u8").tofile(f)
        index.occurrences.astype("<u8", copy=False).tofile(f)


def load_index(path: str) -> FemIndex:
    with open(path, "rb") as f:
        k, step = np.fromfile(f, dtype="<i4", count=2)
        lookup = np.fromfile(f, dtype="<u4", count=(1 << (2 * int(k))) + 1)
        (occ_size,) = np.fromfile(f, dtype="<u8", count=1)
        occ = np.fromfile(f, dtype="<u8", count=int(occ_size))
    if occ.shape[0] != occ_size:
        raise IOError(f"truncated index file {path}")
    return FemIndex(int(k), int(step), lookup, occ)
