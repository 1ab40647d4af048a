"""Device-side data structures of the port.

Layout on a GPU (the TPU layouts of fem_tpu/ops/types.py are gather
workarounds and are not carried over):
  * occurrences as one flat int64 key ``sid << 32 | pos`` in CSR order —
    exactly the index file's occurrence table (src/index.h:22-28);
  * the CSR offsets (4^k + 1) as int64, since an index may hold up to
    2^32 - 1 occurrences (the u32 offsets of the index file), and the 4^k
    frequency table as int32 (a bucket holds at most genome / step);
  * the reference as one flat uint8 code array with the 256-base sentinel
    gaps of fastx.read_fasta between and after the chromosomes, so a
    banded window near a boundary reads sentinels, never a neighbour.

One shard of a coordinate-sharded index (parallel/sharded_index.py) has
the same layout over its slice of the genome: its local CSR and
occurrences, its reference slice (whose offsets, pos - lo, can be
negative), and the GLOBAL frequency table and occurrence count, because the
q-gram DP and the frequency sort are decisions over the whole genome.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fem_tpu_torch.config import FemArgs
from fem_tpu_torch.index.storage import FemIndex
from fem_tpu_torch.io.fastx import Reference

# Sentinel chromosome id of invalid (sid, pos) slots: sorts after every
# real chromosome and never equals one (same value as fem_tpu).
SENTINEL_SID = 2**30
# Invalid diagonal / position in the filter-tail slabs.
BIG = 2**30


@dataclasses.dataclass
class DeviceIndex:
    occ: torch.Tensor  # (N,) int64 sid << 32 | pos
    lookup: torch.Tensor  # (4^k + 1,) int64 CSR offsets into occ
    freq_table: torch.Tensor  # (4^k,) int32 lookup[h+1] - lookup[h]
    ref_flat: torch.Tensor  # (T,) uint8 codes with sentinel gaps
    ref_offsets: torch.Tensor  # (S,) int64 chromosome starts in ref_flat
    ref_lengths: torch.Tensor  # (S,) int32 chromosome lengths
    num_occurrences: int  # global: the DP's occurrence-table size
    # A shard of a coordinate-sharded index (None on a whole index): its
    # owned [own_start, own_end) per chromosome, and the start of its left
    # halo per chromosome, or 2^30 where the slice starts at the chromosome.
    own_start: torch.Tensor | None = None  # (S,) int32
    own_end: torch.Tensor | None = None  # (S,) int32
    halo_lo: torch.Tensor | None = None  # (S,) int32

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self.occ, self.lookup, self.freq_table, self.ref_flat,
                      self.ref_offsets, self.ref_lengths, self.own_start,
                      self.own_end, self.halo_lo)
            if t is not None
        )


def _device_index(occ, lookup, ref_flat, ref_offsets, ref_lengths, device,
                  freq_table=None, num_occurrences=None, **shard):
    """The tensors on `device`. A whole index derives `freq_table` and
    `num_occurrences` from its own CSR; a shard passes the global ones, and
    its `own_start`, `own_end` and `halo_lo`."""
    lookup = np.asarray(lookup, np.int64)
    as_t = lambda x: torch.tensor(np.ascontiguousarray(x), device=device)
    if freq_table is None:
        freq_table = np.diff(lookup)
    if num_occurrences is None:
        num_occurrences = np.asarray(occ).shape[0]
    return DeviceIndex(
        occ=as_t(np.asarray(occ).view(np.int64)),
        lookup=as_t(lookup),
        freq_table=as_t(np.asarray(freq_table).astype(np.int32)),
        ref_flat=as_t(np.asarray(ref_flat, np.uint8)),
        ref_offsets=as_t(np.asarray(ref_offsets).astype(np.int64)),
        ref_lengths=as_t(np.asarray(ref_lengths).astype(np.int32)),
        num_occurrences=int(num_occurrences),
        **{k: as_t(np.asarray(v).astype(np.int32)) for k, v in shard.items()},
    )


def device_index_shard(
    occ, lookup, ref_flat, ref_offsets, own_start, own_end, halo_lo,
    freq_table, num_occurrences: int, ref_lengths, device: torch.device | str,
) -> DeviceIndex:
    """One shard of a coordinate-sharded index on `device`: its local
    occurrences (uint64 or int64 ``sid << 32 | pos``) and CSR, its
    reference slice with its offsets, its owned ranges and halo starts,
    beside the global `freq_table`, `num_occurrences` and `ref_lengths`."""
    return _device_index(
        occ, lookup, ref_flat, ref_offsets, ref_lengths, device,
        freq_table=freq_table, num_occurrences=num_occurrences,
        own_start=own_start, own_end=own_end, halo_lo=halo_lo,
    )


def device_index_from_host(
    index: FemIndex, reference: Reference, device: torch.device | str
) -> DeviceIndex:
    return _device_index(
        np.asarray(index.occurrences, np.uint64), index.lookup,
        reference.flat_codes, reference.offsets, reference.lengths, device,
    )


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Static parameters of the mapping step (fields and properties as in
    fem_tpu.ops.types.FilterParams)."""

    kmer_size: int
    step_size: int
    error_threshold: int
    num_additional_qgrams: int
    max_read_length: int  # Lmax: padded read length
    cap_occ: int = 512  # max gathered occurrences per (read, strand, group)
    cap_cand: int = 512  # max candidates carried per (read, strand)
    cap_vote: int = 512  # width of fem_tpu's compacted vote slab; the port's
    # filter-tail kernel sorts the whole cap_occ slab and never reads it

    @classmethod
    def from_args(cls, args: FemArgs, max_read_length: int, **caps) -> "FilterParams":
        return cls(
            kmer_size=args.kmer_size,
            step_size=args.step_size,
            error_threshold=args.error_threshold,
            num_additional_qgrams=args.num_additional_qgrams,
            max_read_length=max_read_length,
            **caps,
        )

    @property
    def num_qgrams(self) -> int:
        return self.error_threshold + 1 + self.num_additional_qgrams

    @property
    def seed_span(self) -> int:
        return -(-self.kmer_size // self.step_size)

    @property
    def max_num_seeds(self) -> int:
        return self.max_read_length - self.kmer_size + 1

    @property
    def max_group_size(self) -> int:
        return -(-self.max_num_seeds // self.step_size)

    @property
    def max_dp_cols(self) -> int:
        """Upper bound on the q-gram DP column count over all lanes."""
        return max(self.max_group_size - self.num_qgrams * self.seed_span + 2, 2)
