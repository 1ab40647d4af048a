"""The occurrence slab: each (read, strand, group) lane's selected seeds'
CSR runs gathered into cap_occ slots, as the filter tail takes them
(src/filter.c:80-106, src/filter.c:85; fem_tpu/ops/candidates.py's slab).

Slots follow fem_tpu's 8-aligned layout: seed j (in stable frequency
order) owns the aligned 8-slot rows covering its run, at most cap_occ + 1
slots of it, from the exclusive prefix `pfx8` of the rows' sizes; a slot
is valid where it lies inside the run, the lane is mappable and its DP
complete, and the occurrence's position is not before the seed's read
offset (src/filter.c:89-90). The last (most frequent) seed only keeps
keys sid << 32 | diag up to the truncation bound `tkey`, the largest key
of the other seeds' valid slots, -1 where there is none (src/filter.c:85).
`overflow_occ` marks a group whose rows pass cap_occ: the capacity-retry
flag.

`occ_slab` and `occ_bound` run the CUDA kernel (csrc/occ_slab.cu) on a
CUDA tensor and the plain torch version beside it on a CPU tensor:
  * `occ_slab(...)`: the lane's own bound, and the slab truncated at it
    (a whole index: one launch a step);
  * `occ_bound(...)`: the bound and `overflow_occ` alone (a shard of a
    coordinate-sharded index, whose bound is reduced over every shard
    before the slab is written);
  * `occ_slab(..., tkey=reduced)`: the slab truncated at a given bound.
Out: (NB, G, CAP) int32 `sid` and `diag`, invalid slots at
(SENTINEL_SID, BIG), an (NB, G) bool `overflow_occ` and the (NB, G, 1)
int64 bound.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fem_tpu_torch import kernels
from fem_tpu_torch.ops.seed_select import U32
from fem_tpu_torch.ops.types import BIG, SENTINEL_SID

# Seeds a group the kernel takes: a warp's or block's table of them lies in
# shared memory (csrc/occ_slab_core.h: occ::kMaxSeeds).
MAX_SEEDS = 128
_OWN, _BOUND_ONLY, _GIVEN = 0, 1, 2  # csrc/occ_slab_core.h: occ::Mode


class OccSlab(NamedTuple):
    sid: Optional[torch.Tensor]  # (NB, G, CAP) int32, SENTINEL_SID where invalid
    diag: Optional[torch.Tensor]  # (NB, G, CAP) int32, BIG where invalid
    overflow_occ: Optional[torch.Tensor]  # (NB, G) bool; None with a given bound
    tkey: torch.Tensor  # (NB, G, 1) int64: the bound the slab was truncated at


def truncation_key(sid, diag, others) -> torch.Tensor:
    """The last-seed truncation bound (src/filter.c:85) as one int64 key a
    (lane, group): the largest sid << 32 | diag over the other seeds'
    valid slots, -1 where there is none. diag of a valid slot lies in
    [0, 2^32), so the key's order is the lexicographic (sid, diag) order,
    and its maximum over index shards is the JAX package's pmax of tsid
    followed by the pmax of tpos at that tsid."""
    return torch.where(others, (sid << 32) | diag, -1).amax(dim=2, keepdim=True)


def occ_slab_plain(off_s, lfreq_s, start_s, lane_ok, occ, cap: int,
                   tkey: Optional[torch.Tensor] = None) -> OccSlab:
    """Plain torch version: the whole (NB, G, CAP) slab in int64, then the
    bound and the truncation over it."""
    NB, G, S = off_s.shape
    dev = off_s.device
    fc = lfreq_s.clamp(max=cap + 1)
    srow = off_s & 7  # run start within its aligned 8-slot row
    fc8 = torch.where(fc > 0, ((srow + fc + 7) // 8) * 8, 0)
    pfx8 = torch.cumsum(fc8, dim=2) - fc8  # exclusive, 8-aligned slot starts
    overflow_occ = pfx8[..., -1] + fc8[..., -1] > cap  # (NB, G)

    t = torch.arange(cap, device=dev)
    j_of_t = torch.zeros((NB, G, cap), dtype=torch.int64, device=dev)
    for j in range(1, S):  # owning seed of each slot
        j_of_t += t >= pfx8[..., j, None]

    def of_seed(x):  # (NB, G, S) -> (NB, G, CAP)
        return torch.gather(x, 2, j_of_t)

    rel = t - of_seed(pfx8)  # slot offset from the seed's first aligned row
    srow_t = of_seed(srow)
    slot_valid = (rel >= srow_t) & (rel < srow_t + of_seed(fc)) & lane_ok[..., None]
    occ_i = ((of_seed(off_s) & ~7) + rel).clamp(0, occ.shape[0] - 1)
    o = occ[occ_i]
    sid = o >> 32
    pos = o & U32
    seed_start = of_seed(start_s)
    slot_valid &= pos >= seed_start  # src/filter.c:89-90
    diag = pos - seed_start
    is_last = j_of_t == S - 1

    if tkey is None:
        tkey = truncation_key(sid, diag, slot_valid & ~is_last)
    else:
        overflow_occ = None
    slot_valid &= ~is_last | (((sid << 32) | diag) <= tkey)  # src/filter.c:85
    return OccSlab(torch.where(slot_valid, sid, SENTINEL_SID).int(),
                   torch.where(slot_valid, diag, BIG).int(), overflow_occ, tkey)


def _occ_slab_cuda(off_s, lfreq_s, start_s, lane_ok, occ, cap: int, mode: int,
                   tkey: Optional[torch.Tensor] = None) -> OccSlab:
    NB, G, S = off_s.shape
    dev = off_s.device
    sid = diag = None
    if mode != _BOUND_ONLY:
        sid = torch.empty((NB, G, cap), dtype=torch.int32, device=dev)
        diag = torch.empty_like(sid)
    overflow = tkey_out = None
    if mode != _GIVEN:
        overflow = torch.empty((NB, G), dtype=torch.bool, device=dev)
        tkey_out = torch.empty((NB, G, 1), dtype=torch.int64, device=dev)
    if NB * G == 0:
        return OccSlab(sid, diag, overflow, tkey if tkey is not None else tkey_out)
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = kernels.library().fem_occ_slab(
        off_s.data_ptr(), lfreq_s.data_ptr(), start_s.data_ptr(), lane_ok.data_ptr(),
        occ.data_ptr(), occ.shape[0], NB * G, S, cap, mode, ptr(tkey),
        ptr(sid), ptr(diag), ptr(overflow), ptr(tkey_out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check_launch(rc, "occ_slab")
    kernels.count_launch("occ_slab", (cap, NB))
    return OccSlab(sid, diag, overflow, tkey if tkey is not None else tkey_out)


def _checked(off_s, lfreq_s, start_s, lane_ok, occ, cap: int,
             tkey: Optional[torch.Tensor]) -> None:
    if cap < 8 or cap % 8:
        raise ValueError(f"cap_occ must be a positive multiple of 8, got {cap}")
    if off_s.dim() != 3 or not (off_s.shape == lfreq_s.shape == start_s.shape):
        raise ValueError("occ_slab takes three (NB, G, S) seed tables of one shape")
    NB, G, S = off_s.shape
    if not 1 <= S <= MAX_SEEDS:
        raise ValueError(f"occ_slab takes 1 to {MAX_SEEDS} seeds a group, got {S}")
    if any(x.dtype != torch.int64 for x in (off_s, lfreq_s, start_s, occ)):
        raise TypeError("occ_slab takes int64 seed tables and occurrences")
    if lane_ok.dtype != torch.bool or lane_ok.shape != (NB, G):
        raise ValueError("occ_slab takes an (NB, G) bool lane_ok")
    if occ.dim() != 1:
        raise ValueError("occ_slab takes a flat occurrence table")
    if tkey is not None and (tkey.dtype != torch.int64 or tkey.shape != (NB, G, 1)):
        raise ValueError("occ_slab takes an (NB, G, 1) int64 bound")
    tensors = [off_s, lfreq_s, start_s, lane_ok, occ] + ([tkey] if tkey is not None else [])
    if any(x.device != off_s.device for x in tensors):
        raise ValueError("occ_slab's inputs lie on different devices")
    if off_s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"occ_slab runs on cpu or cuda, not {off_s.device}")
    if off_s.device.type == "cuda" and not all(x.is_contiguous() for x in tensors):
        raise ValueError("occ_slab takes contiguous tensors")


def occ_slab(
    off_s: torch.Tensor,  # (NB, G, S) int64 CSR offsets, stable frequency order
    lfreq_s: torch.Tensor,  # (NB, G, S) int64 run lengths
    start_s: torch.Tensor,  # (NB, G, S) int64 read offsets
    lane_ok: torch.Tensor,  # (NB, G) bool: mappable lane, complete DP
    occ: torch.Tensor,  # (N,) int64 sid << 32 | pos
    cap: int,
    tkey: Optional[torch.Tensor] = None,  # (NB, G, 1) int64 given bound
) -> OccSlab:
    """The slab, truncated at the lane's own bound or at a given one."""
    _checked(off_s, lfreq_s, start_s, lane_ok, occ, cap, tkey)
    if off_s.device.type == "cpu":
        return occ_slab_plain(off_s, lfreq_s, start_s, lane_ok, occ, cap, tkey)
    return _occ_slab_cuda(off_s, lfreq_s, start_s, lane_ok, occ, cap,
                          _OWN if tkey is None else _GIVEN, tkey)


def occ_bound(off_s, lfreq_s, start_s, lane_ok, occ, cap: int) -> OccSlab:
    """The lane's own bound and `overflow_occ`, with no slab (sid and diag
    None): a shard's first call, before its bound is reduced."""
    _checked(off_s, lfreq_s, start_s, lane_ok, occ, cap, None)
    if off_s.device.type == "cpu":
        return occ_slab_plain(off_s, lfreq_s, start_s, lane_ok, occ, cap)._replace(
            sid=None, diag=None)
    return _occ_slab_cuda(off_s, lfreq_s, start_s, lane_ok, occ, cap, _BOUND_ONLY)
