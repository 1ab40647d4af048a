"""The device step and its host<->device formats (fem_tpu/pipeline/engine.py
`map_core`, `pack_outputs` and `packed_in`).

`map_core_steps` is one batch's mapping step, both strands, as a
generator that stops where the cells of a grid's data row meet
(parallel/mesh.py:GridStep drives it on every device count); `map_core`
runs it on one whole index. `pack_input` / `unpack_input` are a batch's
one upload, `pack_result` / `unpack_result` its one result copy, and
`accepted_hits` the hits the host emits from it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fem_tpu_torch.ops.candidates import candidates_back, candidates_front
from fem_tpu_torch.ops.compact import accept_slab, verify_slab
from fem_tpu_torch.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu_torch.ops.types import DeviceIndex, FilterParams
from fem_tpu_torch.ops.verify import verify_candidates


def map_core(
    index: DeviceIndex,
    codes: torch.Tensor,  # (B, Lmax) uint8
    lengths: torch.Tensor,  # (B,) int32
    params: FilterParams,
    verify_cap: int,
    accept_cap: int = 4096,
) -> dict:
    """The per-batch mapping step, both strands, on a whole index. Returns
    device tensors: the accepted hits compacted in slab order (lane-major,
    ascending band start), the per-lane counters of fem_tpu's map_core, and
    the per-read fallback bits and masked counter sums that fem_tpu's
    pack_outputs derives."""
    steps = map_core_steps(index, codes, lengths, params, verify_cap, accept_cap)
    value = None
    while True:  # one cell: every reduction is the value itself
        try:
            _, value = steps.send(value)
        except StopIteration as stop:
            return stop.value


def map_core_steps(
    index: DeviceIndex,
    codes: torch.Tensor,  # (B, Lmax) uint8
    lengths: torch.Tensor,  # (B,) int32
    params: FilterParams,
    verify_cap: int,
    accept_cap: int = 4096,
):
    """map_core as a generator, for one cell of a grid: at each point
    where the cells of a data row meet it yields (op, value) and takes back
    the reduced value (the caller's reduce hook:
    parallel/mesh.py:GridReducer). An op is "max" or "sum" over the index
    shards of the cell's data row; a point that carries several reductions
    yields a tuple of ops and a tuple of values, one each. No device work
    lies between the reductions of one point, so a grid cuts the step
    there (parallel/mesh.py:GridStep). Returns map_core's dict.

    The points (fem_tpu/parallel/sharded_index.py:302-319): the last-seed
    truncation bound (a max, in the middle of generation); then the
    per-read candidate counts (sum) with the fallback, inherent and retry
    bits (max), so that a read that overflows any shard retries whole and
    is counted by no shard. The fallback bits and the counter sums over the
    kept reads come after them. `total_candidates` is the cell's own
    verify-slab total: fem_tpu's sharded program sums it over the grid, and
    no reader of either package reads it from a grid."""
    e = params.error_threshold
    B = codes.shape[0]
    neg = reverse_complement(codes, lengths)
    both = torch.cat([codes, neg])  # (2B, Lmax)
    lens2 = torch.cat([lengths, lengths])
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)
    front = candidates_front(both, lens2, hashes, amb, index, params)
    tkey = yield "max", front.tkey
    tail = candidates_back(front, tkey, index, params)

    # The range filter and the verify slab, lane-major and in ascending
    # position: the emitter's mapping order relies on it. Only the first
    # `total` slots hold a candidate; Myers skips the rest, which come back
    # not accepted. Then the accepted hits into the accept slab. A read is
    # fully covered iff both its lanes' spans end within both caps (the two
    # truncations cut a prefix of lanes); the rest are mapped again exactly.
    slab = verify_slab(tail.cand_sid, tail.cand_pos, lens2, index, e, verify_cap)
    vres = verify_candidates(index, slab.sid, slab.pos, slab.lane, both, lens2, e,
                             used=slab.total)
    acc_cap = max(accept_cap, 8)
    acc = accept_slab(slab, vres.accepted, vres.edit_distance, vres.end_offset, acc_cap,
                      params.cap_cand)
    retry = ~(acc.ok[:B] & acc.ok[B:])

    num_candidates, (needs_fallback, inherent_fallback, retry) = yield ("sum", "max"), (
        slab.num_candidates, (tail.needs_fallback, tail.inherent_fallback, retry))

    # Per-read fallback bits and the counter sums over the other reads
    # (fem_tpu pack_outputs); dp sums in int64, so no 16/16 split.
    inherent = inherent_fallback[:B] | inherent_fallback[B:]
    fb = needs_fallback[:B] | needs_fallback[B:] | retry | inherent
    keep = ~torch.cat([fb, fb])
    out = {
        "slab_overflow": (slab.total > verify_cap) | (acc.n_accepted > acc_cap),
        "retry": retry,
        "a_lane": acc.lane,
        "a_sid": acc.sid,
        "a_pos": acc.pos,
        "a_ed": acc.ed,
        "a_end": acc.end,
        "n_accepted": acc.n_accepted,
        "num_candidates": num_candidates,
        "dp_total": tail.dp_total,
        "needs_fallback": needs_fallback,
        "inherent_fallback": inherent_fallback,
        "total_candidates": slab.total,
        "fb": fb,
        "inherent": inherent,
        "sum_nc": (num_candidates.long() * keep).sum(),
        "sum_dp": (tail.dp_total * keep).sum(),
    }
    return out


_HOST_FIELDS = ("a_lane", "a_sid", "a_pos", "a_ed", "a_end", "fb", "inherent")
_HOST_SCALARS = ("n_accepted", "sum_nc", "sum_dp")


def pack_result(out: dict) -> torch.Tensor:
    """The fields the host needs as one int64 tensor, for one copy."""
    parts = [torch.stack([out[k] for k in _HOST_SCALARS]).long()]
    parts += [out[k].long() for k in _HOST_FIELDS]
    return torch.cat(parts)


def pack_input(codes: np.ndarray, lengths: np.ndarray, batch_size: int,
               pin_memory: bool = False) -> torch.Tensor:
    """One batch as its (batch_size, Lmax + 4) uint8 upload, fem_tpu's
    `packed_in` (fem_tpu/pipeline/engine.py:759-768): a row holds a read's
    codes, then its length as 4 little-endian bytes; the rows past the
    batch's reads are empty reads (codes 4, length 0). With `pin_memory`
    the rows are written straight into pinned host memory, from which the
    upload goes without another copy."""
    n, Lmax = codes.shape
    if n > batch_size:
        raise ValueError(f"{n} reads do not fit a batch of {batch_size}")
    out = torch.empty((batch_size, Lmax + 4), dtype=torch.uint8, pin_memory=pin_memory)
    packed = out.numpy()
    packed[:n, :Lmax] = codes
    packed[n:, :Lmax] = 4
    packed[:, Lmax:] = 0
    packed[:n, Lmax:] = np.asarray(lengths[:n], "<i4").view(np.uint8).reshape(n, 4)
    return out


def unpack_input(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pack_input`'s (B, Lmax) codes (a view) and (B,) int32 lengths, on
    the packed tensor's device."""
    lb = packed[:, -4:].int()
    lengths = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    return packed[:, :-4], lengths


def unpack_result(flat: np.ndarray, acc_cap: int, num_reads: int, nseg: int = 1) -> dict:
    """`pack_result`'s layout on the host: `flat` holds `nseg` segments
    (a grid's cells, data-row-major), each of `num_reads` reads. The header
    values come back per segment, (nseg,); the hit fields and the per-read
    bits concatenated over the segments, (nseg * acc_cap,) and
    (nseg * num_reads,) bool."""
    w = len(_HOST_SCALARS) + (len(_HOST_FIELDS) - 2) * acc_cap + 2 * num_reads
    if flat.shape[0] != nseg * w:
        raise ValueError(f"{flat.shape[0]} values are not {nseg} segments of {w}")
    segs = flat.reshape(nseg, w)
    host = {k: segs[:, j].copy() for j, k in enumerate(_HOST_SCALARS)}
    o = len(_HOST_SCALARS)
    for k in _HOST_FIELDS:
        n = num_reads if k in ("fb", "inherent") else acc_cap
        host[k] = segs[:, o : o + n].reshape(-1)
        o += n
    host["fb"] = host["fb"].astype(bool)
    host["inherent"] = host["inherent"].astype(bool)
    # Hits past the accept slots were dropped; their reads carry fb.
    host["n_accepted"] = np.minimum(host["n_accepted"], acc_cap)
    return host


def accepted_hits(host: dict, acc_cap: int):
    """The accepted hits of unpacked segments, each segment cut to its
    count, stable-sorted by lane (fem_tpu/pipeline/engine.py
    `_accepted_arrays`): on a grid the segments of one read come from
    several cells, and stability keeps each lane's hits in the cells' order,
    which is ascending reference order. Returns (lane, sid, pos, ed, end)."""
    counts = host["n_accepted"]
    keep = np.concatenate(
        [np.arange(int(c)) + j * acc_cap for j, c in enumerate(counts)]).astype(np.int64)
    cols = [host[k][keep] for k in ("a_lane", "a_sid", "a_pos", "a_ed", "a_end")]
    if counts.shape[0] > 1:
        order = np.argsort(cols[0], kind="stable")
        cols = [c[order] for c in cols]
    return tuple(cols)
