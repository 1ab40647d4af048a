"""The batched mapping engine on one CUDA device (fem_tpu/pipeline/engine.py,
tier 0).

Reads are batched; both strands go through one device step (hash ->
q-gram DP -> candidate filter -> banded Myers), and the small set of
accepted hits comes back to the host in one copy for traceback and SAM
emission by the native emitter (native/). Reads that exceed a device
capacity (occurrence slab, candidate list, verify or accept slots) or hit
an inherent limit (incomplete DP) are mapped by the exact host mapper, so
the ALL-mappings guarantee survives fixed capacities. There is no device
retry ladder yet: capacity overflow goes straight to the host mapper.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from fem_tpu_torch.config import FemArgs
from fem_tpu_torch.index.storage import FemIndex
from fem_tpu_torch.io.fastx import ReadBatch, Reference
from fem_tpu_torch.native import NativeCpuMapper, NativeEmitter
from fem_tpu_torch.ops.candidates import generate_candidates
from fem_tpu_torch.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu_torch.ops.types import DeviceIndex, FilterParams, device_index_from_host
from fem_tpu_torch.ops.verify import verify_candidates
from fem_tpu_torch.stats import MappingStats

# map_core's stages in order, as named to a StageTimer.
STAGES = ("hash", "candidates", "verify_slab", "verify", "accept")


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 10000  # reads per device batch (src/FEM_map.c:151)
    cap_occ: int = 256  # occurrence slots per (read, strand, group)
    cap_cand: int = 256  # candidates carried per (read, strand)
    verify_per_read: float = 16  # verify slots per read-strand lane (avg)
    accept_per_read: float = 4  # accepted-hit slots per read (avg)


def _scatter(size: int, slot: torch.Tensor, ok: torch.Tensor, values: torch.Tensor):
    """out[slot[i]] = values[i] where ok[i], into a zeroed (size,) tensor:
    rejected entries go to one extra dump slot that is cut off (torch
    raises on an out-of-bounds index where JAX drops the write)."""
    out = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
    out.scatter_(0, torch.where(ok, slot, size), values)
    return out[:size]


def map_core(
    index: DeviceIndex,
    codes: torch.Tensor,  # (B, Lmax) uint8
    lengths: torch.Tensor,  # (B,) int32
    params: FilterParams,
    verify_cap: int,
    accept_cap: int = 4096,
    mark=None,
) -> dict:
    """The per-batch mapping step, both strands. Returns device tensors:
    the accepted hits compacted in slab order (lane-major, ascending band
    start), the per-lane counters of fem_tpu's map_core, and the per-read
    fallback bits and masked counter sums that fem_tpu's pack_outputs
    derives. `mark(stage)`, when given, is called as each stage ends."""
    mark = mark or (lambda stage: None)
    e = params.error_threshold
    B = codes.shape[0]
    neg = reverse_complement(codes, lengths)
    both = torch.cat([codes, neg])  # (2B, Lmax)
    lens2 = torch.cat([lengths, lengths])
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)
    mark("hash")
    cand = generate_candidates(both, lens2, hashes, amb, index, params)
    mark("candidates")

    # Compact valid candidates into the verify slab, lane-major and in
    # ascending position: the emitter's mapping order relies on it.
    NB, CC = cand.cand_valid.shape
    flat_valid = cand.cand_valid.reshape(-1)
    order = torch.cumsum(flat_valid, 0) - 1
    total = flat_valid.sum()
    to_slab = flat_valid & (order < verify_cap)
    lane_of = torch.arange(NB, device=codes.device, dtype=torch.int32).repeat_interleave(CC)
    v_lane = _scatter(verify_cap, order, to_slab, lane_of)
    v_sid = _scatter(verify_cap, order, to_slab, cand.cand_sid.reshape(-1))
    v_pos = _scatter(verify_cap, order, to_slab, cand.cand_pos.reshape(-1))
    mark("verify_slab")
    # Only the first `total` slots hold a candidate; the rest are skipped
    # and come back not accepted.
    vres = verify_candidates(index, v_sid, v_pos, v_lane, both, lens2, e, used=total)
    mark("verify")
    accepted = vres.accepted

    acc_cap = max(accept_cap, 8)
    a_order = torch.cumsum(accepted, 0) - 1
    n_accepted = accepted.sum()
    to_acc = accepted & (a_order < acc_cap)

    def compact(x):
        return _scatter(acc_cap, a_order, to_acc, x)

    # A read is fully covered iff both lanes' candidate spans end within
    # verify_cap and both lanes' accepted hits within acc_cap (the two
    # truncations cut a prefix of lanes); the rest are mapped again exactly.
    ok_v = torch.cumsum(cand.cand_valid.sum(dim=1), 0) <= verify_cap
    acc_per_lane = torch.zeros(NB, dtype=torch.int64, device=codes.device)
    acc_per_lane.index_add_(0, v_lane.long(), accepted.long())
    ok_a = torch.cumsum(acc_per_lane, 0) <= acc_cap
    ok_lane = ok_v & ok_a
    retry = ~(ok_lane[:B] & ok_lane[B:])

    # Per-read fallback bits and the counter sums over the other reads
    # (fem_tpu pack_outputs); dp sums in int64, so no 16/16 split.
    inherent = cand.inherent_fallback[:B] | cand.inherent_fallback[B:]
    fb = cand.needs_fallback[:B] | cand.needs_fallback[B:] | retry | inherent
    keep = ~torch.cat([fb, fb])
    out = {
        "slab_overflow": (total > verify_cap) | (n_accepted > acc_cap),
        "retry": retry,
        "a_lane": compact(v_lane),
        "a_sid": compact(v_sid),
        "a_pos": compact(v_pos),
        "a_ed": compact(vres.edit_distance),
        "a_end": compact(vres.end_offset),
        "n_accepted": n_accepted,
        "num_candidates": cand.num_candidates,
        "dp_total": cand.dp_total,
        "needs_fallback": cand.needs_fallback,
        "inherent_fallback": cand.inherent_fallback,
        "total_candidates": total,
        "fb": fb,
        "inherent": inherent,
        "sum_nc": (cand.num_candidates.long() * keep).sum(),
        "sum_dp": (cand.dp_total * keep).sum(),
    }
    mark("accept")
    return out


_HOST_FIELDS = ("a_lane", "a_sid", "a_pos", "a_ed", "a_end", "fb", "inherent")
_HOST_SCALARS = ("n_accepted", "sum_nc", "sum_dp")


def to_host(out: dict) -> dict:
    """The fields the host needs, in one device-to-host copy."""
    parts = [torch.stack([out[k] for k in _HOST_SCALARS]).long()]
    parts += [out[k].long() for k in _HOST_FIELDS]
    flat = torch.cat(parts).cpu().numpy()
    host = dict(zip(_HOST_SCALARS, (int(x) for x in flat[:3])))
    o = 3
    for k in _HOST_FIELDS:
        n = out[k].shape[0]
        host[k] = flat[o : o + n]
        o += n
    host["fb"] = host["fb"].astype(bool)
    host["inherent"] = host["inherent"].astype(bool)
    # Hits past the accept slots were dropped; their reads carry fb.
    host["n_accepted"] = min(host["n_accepted"], host["a_lane"].shape[0])
    return host


class StageTimer:
    """CUDA events at each map_core stage boundary; `ms` sums per stage."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ms = {s: 0.0 for s in STAGES}
        self._events: list = []

    def start(self) -> None:
        self._events = [("start", self._record())]

    def _record(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def mark(self, stage: str) -> None:
        self._events.append((stage, self._record()))

    def collect(self) -> None:
        """Add the timed stages of the last batch (synchronizes)."""
        self._events[-1][1].synchronize()
        for (_, a), (stage, b) in zip(self._events, self._events[1:]):
            self.ms[stage] += a.elapsed_time(b)
        self._events = []


class MappingEngine:
    def __init__(
        self,
        args: FemArgs,
        reference: Reference,
        index: FemIndex,
        config: EngineConfig | None = None,
        *,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.args = args
        self.reference = reference
        self.config = config or EngineConfig()
        self.dindex = device_index_from_host(index, reference, self.device)
        self._native = NativeEmitter(reference, args.error_threshold)
        self._cpu_mapper = NativeCpuMapper(args, reference, index)
        self._fallback_lock = threading.Lock()
        self.fallback_reads = 0
        self.stage_timer: StageTimer | None = None

    def _caps(self) -> Tuple[int, int]:
        c = self.config
        verify_cap = int(2 * c.batch_size * c.verify_per_read)
        accept_cap = max(int(2 * c.batch_size * c.accept_per_read), 64)
        return verify_cap, accept_cap

    def submit_batch(self, batch: ReadBatch):
        """Run the device step on one batch; the result stays on the device
        until `_drain` copies it back."""
        c = self.config
        n = batch.num_reads
        if n > c.batch_size:
            raise ValueError(f"batch of {n} reads exceeds batch_size {c.batch_size}")
        codes = torch.from_numpy(np.ascontiguousarray(batch.codes[:n])).to(self.device)
        lengths = torch.from_numpy(
            np.ascontiguousarray(batch.lengths[:n], np.int32)
        ).to(self.device)
        params = FilterParams.from_args(
            self.args, codes.shape[1], cap_occ=c.cap_occ, cap_cand=c.cap_cand,
        )
        verify_cap, accept_cap = self._caps()
        timer = self.stage_timer
        if timer is not None:
            timer.start()
        out = map_core(
            self.dindex, codes, lengths, params, verify_cap, accept_cap,
            mark=timer.mark if timer is not None else None,
        )
        return batch, out

    def _map_read_fallback(self, name, seq, qual) -> Tuple[List[bytes], MappingStats]:
        """Exact host mapping of one read by the in-process C++ mapper."""
        with self._fallback_lock:
            self.fallback_reads += 1
        blob, st = self._cpu_mapper.map_reads([name], [seq], [qual])
        stats = MappingStats(*(int(x) for x in st))
        return ([blob] if blob else []), stats

    def _drain(self, pending) -> Tuple[List[bytes], MappingStats]:
        """Copy one batch's result to the host, emit its covered reads and
        map its fallback reads exactly on the host, spliced back in read
        order."""
        batch, out = pending
        host = to_host(out)
        if self.stage_timer is not None:
            self.stage_timer.collect()
        n = batch.num_reads
        fb = host["fb"]
        fb_idx = np.flatnonzero(fb)
        want_per_read = fb_idx.size > 0
        segs, stats = self._emit_native(batch, host, want_per_read)
        stats.num_reads = n - int(fb_idx.size)
        for i in fb_idx:
            segs[i], s = self._map_read_fallback(
                batch.names[i], batch.seqs[i], batch.quals[i]
            )
            stats += s
        if want_per_read:
            return [r for rsegs in segs for r in rsegs], stats
        return segs, stats

    def _emit_native(
        self, batch: ReadBatch, host: dict, want_per_read: bool
    ) -> Tuple[list, MappingStats]:
        """Counters from the device sums and one native call for the
        mapping sort, traceback and SAM formatting."""
        n = batch.num_reads
        stats = MappingStats(
            num_candidates=host["sum_nc"],
            num_candidates_without_additional_qgram_filter=host["sum_dp"],
        )
        k = host["n_accepted"]
        a_lane = host["a_lane"][:k]
        read_id = a_lane % n
        # Generation order per read: + strand then - strand, each ascending
        # (src/map.c:29-49); a stable sort by read id keeps exactly that.
        order = np.argsort(read_id, kind="stable")
        order = order[~host["fb"][read_id[order]]]  # fallback reads re-map
        read_id = read_id[order]
        map_counts = np.bincount(read_id, minlength=n).astype(np.int32)
        stats.num_mappings = int(map_counts.sum())
        stats.num_mapped_reads = int((map_counts > 0).sum())
        res = self._native.emit(
            batch,
            map_counts,
            (a_lane[order] >= n).astype(np.uint8),
            host["a_ed"][:k][order].astype(np.uint8),
            host["a_sid"][:k][order].astype(np.int32),
            host["a_pos"][:k][order].astype(np.int64),
            host["a_end"][:k][order].astype(np.int32),
            want_read_ends=want_per_read,
        )
        if want_per_read:
            blob, ends = res
            segs, prev = [], 0
            for r in range(n):
                e_ = int(ends[r])
                segs.append([blob[prev:e_]] if e_ > prev else [])
                prev = e_
            return segs, stats
        return ([res] if res else []), stats

    def map_batch(self, batch: ReadBatch) -> Tuple[List[bytes], MappingStats]:
        """Map one read batch synchronously: SAM chunks in read order + stats."""
        return self._drain(self.submit_batch(batch))

    def map_stream(
        self, batches: Iterable[ReadBatch]
    ) -> Iterator[Tuple[List[bytes], MappingStats]]:
        """Map a stream of batches one at a time, in order."""
        for batch in batches:
            if batch.num_reads:
                yield self.map_batch(batch)
