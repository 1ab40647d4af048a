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


def generate_candidates(
    codes: torch.Tensor,  # (NB, Lmax) uint8 — reads with strand applied
    lengths: torch.Tensor,  # (NB,) int32
    hashes: torch.Tensor,  # (NB, NSmax) int32 seed hashes
    ambiguous: torch.Tensor,  # (NB,) int32
    index: DeviceIndex,
    params: FilterParams,
) -> CandidateResult:
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
    lfreq = index.lookup[sel_hash + 1].long() - off
    # Ties keep traceback order, like glibc qsort's stable merge sort on
    # the 3-way comparator (src/utils.h:126-136).
    order = torch.sort(lfreq, dim=2, stable=True).indices
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

    # ---- last-seed truncation (src/filter.c:85) ---------------------------
    others = slot_valid & ~is_last
    tsid = torch.where(others, sid, -1).amax(dim=2, keepdim=True)
    tpos = torch.where(others & (sid == tsid), diag, -1).amax(dim=2, keepdim=True)
    keep_last = (sid < tsid) | ((sid == tsid) & (diag <= tpos))
    slot_valid &= ~is_last | keep_last

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
    cand_pos = torch.where(cand_valid, cand_pos - e, cand_pos)

    # Capacity overflow could retry at a bigger shape; an incomplete
    # non-degenerate DP is fixed by none, so it routes to the host mapper.
    needs_fallback = mappable & (overflow_occ.any(dim=1) | overflow_cand)
    inherent = mappable & (~complete & ~degenerate).any(dim=1)
    num_candidates = cand_valid.sum(dim=1, dtype=torch.int32)
    return CandidateResult(
        cand_sid, cand_pos, cand_valid, num_candidates, dp_total,
        needs_fallback, inherent, mappable,
    )
