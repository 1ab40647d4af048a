"""The step's range filter and its two compactions (fem_tpu/pipeline/
engine.py `map_core`; src/filter.c:133-144).

The verify slab: each read-strand lane's filter-tail list (ascending, the
sentinels last) goes through the range filter (not the sentinel, at or
past e, the band's end inside the chromosome, and on a shard of a
coordinate-sharded index inside the shard's owned range); the lanes'
passing candidates, shifted by -e to their band starts, fill `cap` slots
lane-major and in ascending position, which the emitter's mapping order
relies on. The accept slab: the slots banded Myers accepted, in slab order,
into `acc_cap` slots. Slots past each total hold 0. A lane is whole (`ok`)
where its verify span ends within `cap` and its accept span within
`acc_cap`: the two truncations cut a prefix of lanes, and a read retries
unless both its lanes are whole.

`verify_slab` and `accept_slab` run the CUDA kernels (csrc/compact.cu: a
lane a warp or a block, an exclusive scan of the lane counts, no pass over
every slot) on CUDA tensors, and the plain torch versions beside them on
CPU tensors. `range_filter` is the plain range filter alone, for
`generate_candidates`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fem_tpu_torch import kernels
from fem_tpu_torch.ops.types import SENTINEL_SID, DeviceIndex


class VerifySlab(NamedTuple):
    sid: torch.Tensor  # (cap,) int32
    pos: torch.Tensor  # (cap,) int32 band starts
    lane: torch.Tensor  # (cap,) int32 row of the reads both strands
    num_candidates: torch.Tensor  # (NB,) int32 a lane's passing candidates
    offset: torch.Tensor  # (NB,) int64 exclusive prefix of num_candidates
    total: torch.Tensor  # () int64, not cut at cap


class AcceptSlab(NamedTuple):
    lane: torch.Tensor  # (acc_cap,) int32
    sid: torch.Tensor  # (acc_cap,) int32
    pos: torch.Tensor  # (acc_cap,) int32
    ed: torch.Tensor  # (acc_cap,) int32
    end: torch.Tensor  # (acc_cap,) int32
    n_accepted: torch.Tensor  # () int64, not cut at acc_cap
    ok: torch.Tensor  # (NB,) bool: both the lane's spans within their caps


def _scatter(size: int, slot: torch.Tensor, ok: torch.Tensor, values: torch.Tensor):
    """out[slot[i]] = values[i] where ok[i], into a zeroed (size,) tensor:
    rejected entries go to one extra dump slot that is cut off (torch
    raises on an out-of-bounds index where JAX drops the write)."""
    out = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
    out.scatter_(0, torch.where(ok, slot, size), values)
    return out[:size]


def range_filter(cand_sid, cand_pos, lengths, index: DeviceIndex, e: int):
    """Plain range filter (src/filter.c:133-144) of (NB, CC) lists: the
    band starts (shifted by -e where valid), the (NB, CC) validity and the
    (NB,) int32 counts."""
    ref_len = index.ref_lengths[cand_sid.long().clamp(0, index.ref_lengths.shape[0] - 1)]
    in_range = (cand_pos >= e) & (cand_pos + lengths[:, None] + e < ref_len)
    valid = (cand_sid != SENTINEL_SID) & in_range
    if index.own_start is not None:  # each candidate is owned by one shard
        sid_c = cand_sid.long().clamp(0, index.own_start.shape[0] - 1)
        valid &= (cand_pos >= index.own_start[sid_c]) & (cand_pos < index.own_end[sid_c])
    return torch.where(valid, cand_pos - e, cand_pos), valid, valid.sum(dim=1, dtype=torch.int32)


def verify_slab_plain(cand_sid, cand_pos, lengths, index: DeviceIndex, e: int,
                      cap: int) -> VerifySlab:
    """Plain version: the range filter, a prefix sum over every slot and
    three scatters."""
    pos, valid, num = range_filter(cand_sid, cand_pos, lengths, index, e)
    NB, CC = valid.shape
    flat = valid.reshape(-1)
    order = torch.cumsum(flat, 0) - 1
    to_slab = flat & (order < cap)
    # Each slot's lane, without repeat_interleave (which may size its
    # output with a host read).
    lane_of = (torch.arange(NB * CC, device=valid.device) // CC).int()
    ends = torch.cumsum(num, 0)
    return VerifySlab(_scatter(cap, order, to_slab, cand_sid.reshape(-1)),
                      _scatter(cap, order, to_slab, pos.reshape(-1)),
                      _scatter(cap, order, to_slab, lane_of), num, ends - num, flat.sum())


def accept_slab_plain(slab: VerifySlab, accepted: torch.Tensor, ed: torch.Tensor,
                      end: torch.Tensor, acc_cap: int) -> AcceptSlab:
    """Plain version: a prefix sum over the slab, five scatters, and the
    accepted hits a lane by an add a slot."""
    cap = slab.sid.shape[0]
    order = torch.cumsum(accepted, 0) - 1
    to_acc = accepted & (order < acc_cap)
    ok_v = torch.cumsum(slab.num_candidates, 0) <= cap
    acc_per_lane = torch.zeros(slab.num_candidates.shape[0], dtype=torch.int64,
                               device=accepted.device)
    acc_per_lane.index_add_(0, slab.lane.long(), accepted.long())
    ok_a = torch.cumsum(acc_per_lane, 0) <= acc_cap
    return AcceptSlab(*(_scatter(acc_cap, order, to_acc, x)
                        for x in (slab.lane, slab.sid, slab.pos, ed, end)),
                      accepted.sum(), ok_v & ok_a)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _buffer(rows: int, cap: int, nb: int, device) -> torch.Tensor:
    """The kernel's int32 buffer: `rows` slab rows of `cap` (rounded up to
    whole int64 words), then its scan's state, at most a word a lane and
    the ticket (cpt::slab_words, cpt::state_words)."""
    return torch.empty(((rows * cap + 1) & ~1) + 2 * (nb + 1), dtype=torch.int32, device=device)


def _verify_slab_cuda(cand_sid, cand_pos, lengths, index: DeviceIndex, e: int,
                      cap: int) -> VerifySlab:
    NB, CC = cand_sid.shape
    dev = cand_sid.device
    buf = _buffer(3, cap, NB, dev)
    num = torch.empty(NB, dtype=torch.int32, device=dev)
    off = torch.empty(NB, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    rc = kernels.library().fem_verify_slab(
        cand_sid.data_ptr(), cand_pos.data_ptr(), lengths.data_ptr(),
        index.ref_lengths.data_ptr(), index.ref_lengths.shape[0], _ptr(index.own_start),
        _ptr(index.own_end), NB, CC, e, cap, buf.data_ptr(), num.data_ptr(), off.data_ptr(),
        total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check_launch(rc, "verify_slab")
    kernels.count_launch("verify_slab", (CC, NB))
    return VerifySlab(buf[:cap], buf[cap : 2 * cap], buf[2 * cap : 3 * cap], num, off, total)


def _accept_slab_cuda(slab: VerifySlab, accepted, ed, end, acc_cap: int,
                      width: int) -> AcceptSlab:
    NB = slab.num_candidates.shape[0]
    dev = accepted.device
    buf = _buffer(5, acc_cap, NB, dev)
    ok = torch.empty(NB, dtype=torch.bool, device=dev)
    n_acc = torch.empty((), dtype=torch.int64, device=dev)
    rc = kernels.library().fem_accept_slab(
        slab.sid.data_ptr(), slab.pos.data_ptr(), ed.data_ptr(), end.data_ptr(),
        accepted.data_ptr(), slab.num_candidates.data_ptr(), slab.offset.data_ptr(), NB,
        width, slab.sid.shape[0], acc_cap, buf.data_ptr(), ok.data_ptr(), n_acc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check_launch(rc, "accept_slab")
    kernels.count_launch("accept_slab", (width, NB))
    rows = [buf[k * acc_cap : (k + 1) * acc_cap] for k in range(5)]
    return AcceptSlab(*rows, n_acc, ok)


def _device(tensors, name: str):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}'s inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return dev


def verify_slab(
    cand_sid: torch.Tensor,  # (NB, CC) int32 filter-tail lists, sentinels last
    cand_pos: torch.Tensor,  # (NB, CC) int32 their diagonals
    lengths: torch.Tensor,  # (NB,) int32 read lengths
    index: DeviceIndex,
    error_threshold: int,
    cap: int,
) -> VerifySlab:
    """The range filter and the verify slab of `cap` slots."""
    if cand_sid.dim() != 2 or cand_sid.shape != cand_pos.shape or cap < 1:
        raise ValueError("verify_slab takes two (NB, CC) lists of one shape and cap >= 1")
    if any(t.dtype != torch.int32 for t in (cand_sid, cand_pos, lengths)):
        raise TypeError("verify_slab takes int32 lists and lengths")
    if lengths.shape != (cand_sid.shape[0],):
        raise ValueError("verify_slab takes an (NB,) lengths")
    owned = [index.own_start, index.own_end] if index.own_start is not None else []
    dev = _device([cand_sid, cand_pos, lengths, index.ref_lengths] + owned, "verify_slab")
    if dev.type == "cpu":
        return verify_slab_plain(cand_sid, cand_pos, lengths, index, error_threshold, cap)
    return _verify_slab_cuda(cand_sid, cand_pos, lengths, index, error_threshold, cap)


def accept_slab(slab: VerifySlab, accepted: torch.Tensor, ed: torch.Tensor,
                end: torch.Tensor, acc_cap: int, width: int) -> AcceptSlab:
    """The accept slab of `acc_cap` slots from the verify slab and Myers'
    (cap,) `accepted`, `ed` and `end`; `width` is the lists' cap_cand,
    which sets the kernel's threads a lane."""
    if accepted.dtype != torch.bool or any(t.dtype != torch.int32 for t in (ed, end)):
        raise TypeError("accept_slab takes a bool accepted and int32 ed and end")
    if not (accepted.shape == ed.shape == end.shape == slab.sid.shape) or acc_cap < 1:
        raise ValueError("accept_slab takes one (cap,) result a verify slot and acc_cap >= 1")
    dev = _device(list(slab) + [accepted, ed, end], "accept_slab")
    if dev.type == "cpu":
        return accept_slab_plain(slab, accepted, ed, end, acc_cap)
    return _accept_slab_cuda(slab, accepted, ed, end, acc_cap, width)
