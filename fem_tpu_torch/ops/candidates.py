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
Slab slots follow fem_tpu's 8-aligned layout: seed j owns the aligned
8-slot chunks covering its CSR run, so `overflow_occ` (the capacity-retry
flag) is the same rule bit for bit.

On a shard of a coordinate-sharded index (fem_tpu/ops/candidates.py's
`index_axis` branches) the seeds sort by their GLOBAL frequency while the
runs come from the shard's local CSR; the last-seed truncation bound is a
maximum over every index shard, so generation splits there:
`candidates_front` returns the shard's own bound, the caller reduces it
over the index axis, and `candidates_back` finishes with the reduced
bound. Reads whose candidates fall in the first e positions of a slice
that starts mid-chromosome carry the inherent bit (halo risk), and only
candidates inside the shard's owned range survive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fem_tpu_torch.ops.filter_tail import filter_tail
from fem_tpu_torch.ops.seed_select import U32, select_qgrams
from fem_tpu_torch.ops.types import BIG, SENTINEL_SID, DeviceIndex, FilterParams


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
    """What generation holds at the last-seed truncation: the occurrence
    slab, and `tkey`, this index's (or shard's) bound to be reduced."""

    lengths: torch.Tensor  # (NB,) int32
    sid: torch.Tensor  # (NB, G, CAP) int64
    diag: torch.Tensor  # (NB, G, CAP) int64
    slot_valid: torch.Tensor  # (NB, G, CAP) bool
    is_last: torch.Tensor  # (NB, G, CAP) bool: a slot of the most frequent seed
    tkey: torch.Tensor  # (NB, G, 1) int64
    overflow_occ: torch.Tensor  # (NB, G) bool
    complete: torch.Tensor  # (NB, G) bool
    degenerate: torch.Tensor  # (NB, G) bool
    mappable: torch.Tensor  # (NB,) bool
    dp_total: torch.Tensor  # (NB,) int64


def truncation_key(sid, diag, others) -> torch.Tensor:
    """The last-seed truncation bound (src/filter.c:85) as one int64 key a
    (lane, group): the largest sid << 32 | diag over the other seeds'
    valid slots, -1 where there is none. diag of a valid slot lies in
    [0, 2^32), so the key's order is the lexicographic (sid, diag) order,
    and its maximum over index shards is the JAX package's pmax of tsid
    followed by the pmax of tpos at that tsid."""
    return torch.where(others, (sid << 32) | diag, -1).amax(dim=2, keepdim=True)


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
    if CAP % 8:
        raise ValueError("cap_occ must be a multiple of 8")

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
    fc = lfreq_s.clamp(max=CAP + 1)
    srow = off_s & 7  # run start within its aligned 8-slot row
    fc8 = torch.where(fc > 0, ((srow + fc + 7) // 8) * 8, 0)
    pfx8 = torch.cumsum(fc8, dim=2) - fc8  # exclusive, 8-aligned slot starts
    overflow_occ = pfx8[..., -1] + fc8[..., -1] > CAP  # (NB, G)

    t = torch.arange(CAP, device=dev)
    j_of_t = torch.zeros((NB, G, CAP), dtype=torch.int64, device=dev)
    for j in range(1, S):  # owning seed of each slot
        j_of_t += t >= pfx8[..., j, None]

    def of_seed(x):  # (NB, G, S) -> (NB, G, CAP)
        return torch.gather(x, 2, j_of_t)

    rel = t - of_seed(pfx8)  # slot offset from the seed's first aligned row
    srow_t = of_seed(srow)
    lane_ok = mappable[:, None] & complete  # (NB, G)
    slot_valid = (rel >= srow_t) & (rel < srow_t + of_seed(fc)) & lane_ok[..., None]
    occ_i = ((of_seed(off_s) & ~7) + rel).clamp(0, index.occ.shape[0] - 1)
    occ = index.occ[occ_i]
    sid = occ >> 32
    pos = occ & U32
    seed_start = of_seed(start_s)
    slot_valid &= pos >= seed_start  # src/filter.c:89-90
    diag = pos - seed_start
    is_last = j_of_t == S - 1

    tkey = truncation_key(sid, diag, slot_valid & ~is_last)
    return CandidateFront(lengths, sid, diag, slot_valid, is_last, tkey, overflow_occ,
                          complete, degenerate, mappable, dp_total)


def candidates_back(
    front: CandidateFront, tkey: torch.Tensor, index: DeviceIndex, params: FilterParams,
) -> CandidateResult:
    """Generation from the truncation on, given the bound `tkey` reduced
    over every index shard (front.tkey itself on a whole index)."""
    lengths, sid, diag, slot_valid, is_last, _, overflow_occ, complete, degenerate, \
        mappable, dp_total = front
    e = params.error_threshold

    # ---- last-seed truncation (src/filter.c:85) ---------------------------
    slot_valid = slot_valid & (~is_last | (((sid << 32) | diag) <= tkey))

    # Shard halo risk (fem_tpu/ops/candidates.py:385-395): a candidate in
    # the first e positions of a slice that starts mid-chromosome may sit
    # within e of one the shard cannot see, so the fold cannot be trusted.
    halo_risk = None
    if index.halo_lo is not None:
        hlo = index.halo_lo[sid.clamp(0, index.halo_lo.shape[0] - 1)]
        halo_risk = (slot_valid & (diag >= hlo) & (diag < hlo + e)).any(dim=2).any(dim=1)

    # ---- sort + vote + dedup fold -----------------------------------------
    cand_sid, cand_pos, overflow_cand = filter_tail(
        torch.where(slot_valid, sid, SENTINEL_SID).int(),
        torch.where(slot_valid, diag, BIG).int(),
        params.cap_cand, e, params.num_additional_qgrams,
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
