"""Candidate generation: occurrence gather + pigeonhole vote + dedup
(fem_tpu/ops/candidates.py, the filter-tail kernel path).

Reference semantics (src/filter.c:80-223). Every (read, strand, group)
lane gathers the occurrence runs of its selected seeds into a cap_occ
slab; the filter tail (ops/filter_tail.py) sorts, votes and folds it.
Parity-critical quirks kept:
  * occurrences whose position precedes the seed's read offset are
    dropped (src/filter.c:89-90,106);
  * after the stable sort by frequency (src/filter.c:204) the last (most
    frequent) seed only contributes diagonals <= the largest (sid, diag)
    of the other seeds (src/filter.c:85);
  * candidates near chromosome edges drop and survivors shift by -e to the
    band start (src/filter.c:133-144).
The slab itself, its 8-aligned layout (so `overflow_occ`, the
capacity-retry flag, is fem_tpu's rule bit for bit), the read-offset drop
and the last-seed truncation are ops/occ_slab.py: a CUDA kernel on the
card, the plain torch version on the CPU.

On a shard of a coordinate-sharded index (fem_tpu/ops/candidates.py's
`index_axis` branches) the seeds sort by their GLOBAL frequency while the
runs come from the shard's local CSR; the last-seed truncation bound is a
maximum over every index shard, so generation splits there:
`candidates_front` returns the shard's own bound, the caller reduces it
over the index axis, and `candidates_back` writes the slab truncated at
the reduced bound (on a whole index `candidates_front` writes it). Reads
whose candidates fall in the first e positions of a slice that starts
mid-chromosome carry the inherent bit (halo risk), and only candidates
inside the shard's owned range survive.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fem_tpu_torch.ops.filter_tail import filter_tail
from fem_tpu_torch.ops.occ_slab import occ_bound, occ_slab
from fem_tpu_torch.ops.seed_select import U32, select_qgrams
from fem_tpu_torch.ops.types import SENTINEL_SID, DeviceIndex, FilterParams


class CandidateResult(NamedTuple):
    cand_sid: torch.Tensor  # (NB, CC) int32
    cand_pos: torch.Tensor  # (NB, CC) int32 band-start positions
    cand_valid: torch.Tensor  # (NB, CC) bool, ascending positions first
    num_candidates: torch.Tensor  # (NB,) int32
    dp_total: torch.Tensor  # (NB,) int64 in [0, 2^32): the uint32 pre-filter counter
    needs_fallback: torch.Tensor  # (NB,) bool — capacity overflow
    inherent_fallback: torch.Tensor  # (NB,) bool — incomplete DP, no tier helps
    mappable: torch.Tensor  # (NB,) bool — passed length/ambiguity guards


class CandidateFront(NamedTuple):
    """What generation holds at the last-seed truncation: the selected
    seeds' runs, `tkey`, this index's (or shard's) bound to be reduced, and
    on a whole index the occurrence slab already truncated at it."""

    lengths: torch.Tensor  # (NB,) int32
    off_s: torch.Tensor  # (NB, G, S) int64 CSR offsets, stable frequency order
    lfreq_s: torch.Tensor  # (NB, G, S) int64 run lengths
    start_s: torch.Tensor  # (NB, G, S) int64 read offsets
    lane_ok: torch.Tensor  # (NB, G) bool
    sid: Optional[torch.Tensor]  # (NB, G, CAP) int32 slab; None on a shard
    diag: Optional[torch.Tensor]  # (NB, G, CAP) int32 slab; None on a shard
    tkey: torch.Tensor  # (NB, G, 1) int64
    overflow_occ: torch.Tensor  # (NB, G) bool
    complete: torch.Tensor  # (NB, G) bool
    degenerate: torch.Tensor  # (NB, G) bool
    mappable: torch.Tensor  # (NB,) bool
    dp_total: torch.Tensor  # (NB,) int64


def generate_candidates(
    codes: torch.Tensor,  # (NB, Lmax) uint8 — reads with strand applied
    lengths: torch.Tensor,  # (NB,) int32
    hashes: torch.Tensor,  # (NB, NSmax) int32 seed hashes
    ambiguous: torch.Tensor,  # (NB,) int32
    index: DeviceIndex,
    params: FilterParams,
) -> CandidateResult:
    """Candidates of a whole index (on a shard, the truncation bound is
    this shard's alone: see candidates_front / candidates_back)."""
    front = candidates_front(codes, lengths, hashes, ambiguous, index, params)
    return candidates_back(front, front.tkey, index, params)


def candidates_front(
    codes: torch.Tensor,  # (NB, Lmax) uint8 — reads with strand applied
    lengths: torch.Tensor,  # (NB,) int32
    hashes: torch.Tensor,  # (NB, NSmax) int32 seed hashes
    ambiguous: torch.Tensor,  # (NB,) int32
    index: DeviceIndex,
    params: FilterParams,
) -> CandidateFront:
    NB = codes.shape[0]
    dev = codes.device
    G = params.step_size
    NG = params.max_group_size
    S = params.num_qgrams
    e = params.error_threshold
    CAP = params.cap_occ

    num_seeds = lengths.long() - params.kmer_size + 1
    min_group = torch.where(num_seeds > 0, num_seeds // G, 0)
    mappable = (
        (num_seeds > 0)
        & (S <= min_group)  # src/filter.c:166-172
        & (ambiguous <= e)  # src/filter.c:180-182
    )

    # ---- per-(lane, group) seed tables: group g holds seeds g, g+step, ...
    NSh = hashes.shape[1]
    g_ids = torch.arange(G, device=dev)
    col = (g_ids[:, None] + torch.arange(NG, device=dev)[None, :] * G).clamp(max=NSh - 1)
    group_hashes = hashes[:, col].long()  # (NB, G, NG)
    group_sizes = ((num_seeds[:, None] - g_ids[None, :]) // G).clamp(min=0)
    freqs = index.freq_table[group_hashes]  # (NB, G, NG)

    # ---- DP selection per (lane, group) -----------------------------------
    sel = select_qgrams(
        freqs.reshape(NB * G, NG), group_sizes.reshape(-1),
        index.num_occurrences, params,
    )
    sel_p = sel.positions.reshape(NB, G, S)  # group coords, traceback order
    dp_total = torch.where(
        mappable[:, None], sel.min_total.reshape(NB, G), 0
    ).sum(dim=1) & U32
    complete = sel.complete.reshape(NB, G)
    degenerate = sel.degenerate.reshape(NB, G)

    # ---- selected seeds' CSR runs, stable-sorted by frequency -------------
    sel_pc = sel_p.clamp(0, NG - 1)
    start = g_ids[None, :, None] + sel_pc * G  # read offset of each seed
    sel_hash = torch.gather(group_hashes, 2, sel_pc)
    off = index.lookup[sel_hash].long()
    lfreq = index.lookup[sel_hash + 1].long() - off  # the (local) run length
    # The sort key is the global frequency, already gathered (on a whole
    # index it equals the run length). Ties keep traceback order, like
    # glibc qsort's stable merge sort on the 3-way comparator
    # (src/utils.h:126-136).
    order = torch.sort(torch.gather(freqs, 2, sel_pc), dim=2, stable=True).indices
    start_s = torch.gather(start, 2, order)
    off_s = torch.gather(off, 2, order)
    lfreq_s = torch.gather(lfreq, 2, order)

    # ---- occurrence gather into CAP slots (8-aligned chunks) --------------
    # On a whole index the lane's own bound is final, and one call writes
    # the slab truncated at it; a shard's bound is reduced over every index
    # shard first, so there the slab waits for candidates_back.
    lane_ok = mappable[:, None] & complete  # (NB, G)
    write = occ_slab if index.halo_lo is None else occ_bound
    slab = write(off_s, lfreq_s, start_s, lane_ok, index.occ, CAP)
    return CandidateFront(lengths, off_s, lfreq_s, start_s, lane_ok, slab.sid, slab.diag,
                          slab.tkey, slab.overflow_occ, complete, degenerate, mappable,
                          dp_total)


def candidates_back(
    front: CandidateFront, tkey: torch.Tensor, index: DeviceIndex, params: FilterParams,
) -> CandidateResult:
    """Generation from the truncation on, given the bound `tkey` reduced
    over every index shard (front.tkey itself on a whole index)."""
    lengths, overflow_occ, complete, degenerate, mappable, dp_total = (
        front.lengths, front.overflow_occ, front.complete, front.degenerate,
        front.mappable, front.dp_total)
    e = params.error_threshold

    # On a shard: the slab, truncated at the reduced bound (src/filter.c:85),
    # and the halo risk (fem_tpu/ops/candidates.py:385-395): a candidate in
    # the first e positions of a slice that starts mid-chromosome may sit
    # within e of one the shard cannot see, so the fold cannot be trusted.
    sid, diag, halo_risk = front.sid, front.diag, None
    if index.halo_lo is not None:
        sid, diag = occ_slab(front.off_s, front.lfreq_s, front.start_s, front.lane_ok,
                             index.occ, params.cap_occ, tkey=tkey)[:2]
        hlo = index.halo_lo[sid.clamp(0, index.halo_lo.shape[0] - 1).long()]
        halo_risk = ((sid != SENTINEL_SID) & (diag >= hlo) & (diag < hlo + e)
                     ).any(dim=2).any(dim=1)

    # ---- sort + vote + dedup fold -----------------------------------------
    cand_sid, cand_pos, overflow_cand = filter_tail(
        sid, diag, params.cap_cand, e, params.num_additional_qgrams,
    )

    # ---- range filter + band-start shift (src/filter.c:133-144) -----------
    ref_len = index.ref_lengths[cand_sid.long().clamp(0, index.ref_lengths.shape[0] - 1)]
    in_range = (cand_pos >= e) & (cand_pos + lengths[:, None] + e < ref_len)
    cand_valid = (cand_sid != SENTINEL_SID) & in_range
    if index.own_start is not None:  # each candidate is owned by one shard
        sid_c = cand_sid.long().clamp(0, index.own_start.shape[0] - 1)
        cand_valid &= (cand_pos >= index.own_start[sid_c]) & (cand_pos < index.own_end[sid_c])
    cand_pos = torch.where(cand_valid, cand_pos - e, cand_pos)

    # Capacity overflow could retry at a bigger shape; an incomplete
    # non-degenerate DP or a halo risk is fixed by none, so it routes to the
    # host mapper.
    needs_fallback = mappable & (overflow_occ.any(dim=1) | overflow_cand)
    inherent = mappable & (~complete & ~degenerate).any(dim=1)
    if halo_risk is not None:
        inherent |= mappable & halo_risk
    num_candidates = cand_valid.sum(dim=1, dtype=torch.int32)
    return CandidateResult(
        cand_sid, cand_pos, cand_valid, num_candidates, dp_total,
        needs_fallback, inherent, mappable,
    )
