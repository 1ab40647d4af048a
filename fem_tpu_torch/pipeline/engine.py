"""The batched mapping engine (fem_tpu/pipeline/engine.py), on one CUDA
device or on a grid of them (parallel/).

Reads are batched; both strands go through one device step (hash ->
q-gram DP -> candidate filter -> banded Myers), and the small set of
accepted hits comes back to the host in one copy for traceback and SAM
emission by the native emitter (native/). The device step has fixed
capacities (occurrence slab, candidate list, verify and accept slots). A
read that exceeds one is mapped again on the next rung of the
capacity-retry ladder (`TierConfig`: a smaller batch with bigger
capacities), and past the last rung by the exact host mapper; a read that
hits an inherent limit (incomplete DP) goes to the host mapper at once.
So the ALL-mappings guarantee survives fixed capacities.

On one device the step runs as a `StepProgram` per (tier, Lmax), the
counterpart of fem_tpu's one `jax.jit` program per shape: every batch is
padded to its tier's batch size and goes up as one packed buffer, and on
a card the step is one replay of a CUDA graph captured at the key's first
dispatch. `map_stream` keeps `depth` batches in flight: the device step of
every batch runs on the engine's one CUDA stream and ends in a
non-blocking copy of the packed result into pinned host memory, followed
by a recorded event; drain threads wait on that event only, then emit. In
the unordered stream capacity-overflow reads gather in a retry pool and go
out again as pipelined tier-1 batches; `watermark_reads` is the longest
stream prefix whose records the consumer has had, retries included.

On a grid (`EngineConfig.mesh`: reads over a data axis; `.index_mesh`:
also the index split by coordinate over an index axis) the step runs as a
`GridProgram` per (tier, Lmax), the counterpart of fem_tpu's jitted
sharded program: every batch is padded to its tier's batch size and split
evenly over the data rows; each cell maps its row's reads against its
shard and packs a segment of its own, and on a card each cell's step is a
CUDA graph a segment between the reductions of its data row. The drain
reads every segment. A grid that spans processes (parallel/multihost.py)
joins each data row's cells over torch.distributed; its drains then run
on the consumer thread, in stream order, because every process must issue
the same collectives in the same order.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fem_tpu_torch import kernels
from fem_tpu_torch.config import FemArgs
from fem_tpu_torch.core.encoding import encode
from fem_tpu_torch.index.storage import FemIndex
from fem_tpu_torch.io.fastx import ReadBatch, Reference
from fem_tpu_torch.native import NativeCpuMapper, NativeEmitter
from fem_tpu_torch.ops.candidates import candidates_back, candidates_front
from fem_tpu_torch.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu_torch.ops.types import DeviceIndex, FilterParams, device_index_from_host
from fem_tpu_torch.ops.verify import verify_candidates
from fem_tpu_torch.stats import MappingStats
from fem_tpu_torch.utils.metrics import span

# map_core's stages in order, as named to a StageTimer.
STAGES = ("hash", "candidates", "verify_slab", "verify", "accept")

# Tier 0's occurrence slots a (read, strand, group) where the index is
# light, and the width the default ladder above it is derived from.
BASE_CAP_OCC = 256


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """One rung of the capacity-retry ladder: the shapes of one device step.

    Reads whose occurrence, candidate, verify or accept demand exceeds a
    tier's capacities are mapped again at the next tier (smaller batch,
    bigger capacities); past the last tier the exact host mapper takes
    over. That is how fixed capacities keep the reference's unbounded
    merge (src/filter.c:80-131) on heavy-tailed occurrence distributions
    (satellite repeats: seed frequencies 10^3-10^5)."""

    batch_size: int
    cap_occ: int
    cap_cand: int
    verify_per_read: float  # verify slots = int(2 * batch_size * value)
    accept_per_read: float


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 10000  # reads per device batch (src/FEM_map.c:151)
    cap_occ: int | None = None  # occurrence slots per (read, strand, group);
    # None = derived from the index's bucket occupancy (tier0_cap_occ)
    cap_cand: int = 256  # candidates carried per (read, strand)
    verify_per_read: float = 16  # verify slots per read-strand lane (avg)
    accept_per_read: float = 4  # accepted-hit slots per read (avg)
    pipeline_depth: int = 4  # batches in flight (device + drain threads)
    tiers: tuple[TierConfig, ...] | None = None  # retry ladder above tier 0;
    # None = derived from the caps above (MappingEngine._default_tiers).
    # () turns device retries off: overflow reads go to the host mapper.
    mesh: object | None = None  # parallel.mesh.DeviceMesh ("data",): reads
    # split over its devices, the whole index on each
    index_mesh: object | None = None  # DeviceMesh ("data", "index"): the
    # index also split by reference coordinate (parallel/sharded_index.py)


def engine_config_from_jax(fields: dict, device: torch.device | str = "cuda") -> EngineConfig:
    """The port's EngineConfig from a fem_tpu EngineConfig given as plain
    values (`dataclasses.asdict`, or the fields as they are), its
    TierConfigs included. A JAX mesh (`mesh`, `index_mesh`, or its shape)
    comes across as a grid of the same shape, (n_dp,) or (n_dp, n_ip),
    whose every entry is `device`. The fields the port does not have
    (cap_vote, aggregate_fetch, use_pallas, serialize_dispatch) are dropped."""
    from fem_tpu_torch.parallel.mesh import make_index_mesh, make_mesh

    def keep(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in names}

    def shape(m):  # a jax Mesh (its .shape maps axis -> size) or a shape
        return tuple(m.shape.values()) if hasattr(m, "shape") else tuple(m)

    kept = keep(EngineConfig, fields)
    if kept.get("tiers") is not None:
        kept["tiers"] = tuple(
            TierConfig(**keep(TierConfig, t if isinstance(t, dict) else dataclasses.asdict(t)))
            for t in kept["tiers"])
    if kept.get("mesh") is not None:
        (n,) = shape(kept["mesh"])
        kept["mesh"] = make_mesh([device] * n)
    if kept.get("index_mesh") is not None:
        n_dp, n_ip = shape(kept["index_mesh"])
        kept["index_mesh"] = make_index_mesh([device] * (n_dp * n_ip), n_ip)
    return EngineConfig(**kept)


def tier0_cap_occ(occurrences: int, kmer_size: int, num_qgrams: int,
                  ceiling: int | None = None) -> int:
    """Tier 0's occurrence slots a (read, strand, group) for an index of
    `occurrences` k-mers (a coordinate-sharded grid: its largest cell's)
    and S = `num_qgrams` seeds a group.

    A group's slot demand is the sum over its S seeds of each seed's run
    rounded out to whole 8-slot rows (ops/occ_slab.py). At lam = occurrences
    / 4^k a bucket, a seed takes lam + 8 slots on average, and the rows'
    rounding adds to the spread: S (lam + 8) + 4.5 sqrt(S (lam + 11)),
    rounded up to 64 slots, leaves about 1e-5 of reads over where buckets
    are near-Poisson (the benchmark's synthetic 3.0 Gb genome: none of its
    reads over at 576). A real genome's buckets are heavy-tailed, so lam
    is a mean that repeats push up while the seed DP picks rarer seeds;
    reads over the cap go up the exact ladder either way. Never below
    BASE_CAP_OCC, which every light index keeps (chr21 at e=5 asks 104),
    and above it never past `ceiling`, tier 1's cap_occ, so that a group
    tier 0 cannot hold still has a bigger rung."""
    lam = occurrences / 4**kmer_size
    demand = num_qgrams * (lam + 8) + 4.5 * math.sqrt(num_qgrams * (lam + 11))
    cap = -(-math.ceil(demand) // 64) * 64
    if ceiling is not None:
        cap = min(cap, ceiling)
    return max(BASE_CAP_OCC, cap)


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
    """The per-batch mapping step, both strands, on a whole index. Returns
    device tensors: the accepted hits compacted in slab order (lane-major,
    ascending band start), the per-lane counters of fem_tpu's map_core, and
    the per-read fallback bits and masked counter sums that fem_tpu's
    pack_outputs derives. `mark(stage)`, when given, is called as each
    stage ends."""
    steps = map_core_steps(index, codes, lengths, params, verify_cap, accept_cap, mark)
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
    mark=None,
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
    mark = mark or (lambda stage: None)
    e = params.error_threshold
    B = codes.shape[0]
    neg = reverse_complement(codes, lengths)
    both = torch.cat([codes, neg])  # (2B, Lmax)
    lens2 = torch.cat([lengths, lengths])
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)
    mark("hash")
    front = candidates_front(both, lens2, hashes, amb, index, params)
    tkey = yield "max", front.tkey
    cand = candidates_back(front, tkey, index, params)
    mark("candidates")

    # Compact valid candidates into the verify slab, lane-major and in
    # ascending position: the emitter's mapping order relies on it.
    NB, CC = cand.cand_valid.shape
    flat_valid = cand.cand_valid.reshape(-1)
    order = torch.cumsum(flat_valid, 0) - 1
    total = flat_valid.sum()
    to_slab = flat_valid & (order < verify_cap)
    # Each slot's lane, without repeat_interleave (which may size its
    # output with a host read, and a CUDA graph captures no host read).
    lane_of = (torch.arange(NB * CC, device=codes.device) // CC).int()
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

    num_candidates, (needs_fallback, inherent_fallback, retry) = yield ("sum", "max"), (
        cand.num_candidates, (cand.needs_fallback, cand.inherent_fallback, retry))

    # Per-read fallback bits and the counter sums over the other reads
    # (fem_tpu pack_outputs); dp sums in int64, so no 16/16 split.
    inherent = inherent_fallback[:B] | inherent_fallback[B:]
    fb = needs_fallback[:B] | needs_fallback[B:] | retry | inherent
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
        "num_candidates": num_candidates,
        "dp_total": cand.dp_total,
        "needs_fallback": needs_fallback,
        "inherent_fallback": inherent_fallback,
        "total_candidates": total,
        "fb": fb,
        "inherent": inherent,
        "sum_nc": (num_candidates.long() * keep).sum(),
        "sum_dp": (cand.dp_total * keep).sum(),
    }
    mark("accept")
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


class StageTimer:
    """CUDA-event times of map_core's stages, summed per stage in `ms`:
    tier 0 under `ms[0]`, all retry tiers together under `ms[1]`. A batch's
    events travel with it from `begin` to `collect`, so batches in flight
    do not mix; retry batches submitted from drain threads share the
    stream, so their kernels can fall between a tier-0 batch's events. A
    graph's replay has no stage edges: it times the eager step
    (`MappingEngine.eager_step`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ms = {t: {s: 0.0 for s in STAGES} for t in (0, 1)}
        self.batches = {0: 0, 1: 0}
        self._lock = threading.Lock()

    def _record(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def begin(self) -> list:
        """A new batch's event list, with its start recorded."""
        return [("start", self._record())]

    def mark(self, events: list, stage: str) -> None:
        events.append((stage, self._record()))

    def collect(self, events: list, tier: int) -> None:
        """Add one finished batch's stage times."""
        events[-1][1].synchronize()
        key = min(tier, 1)
        with self._lock:
            self.batches[key] += 1
            for (_, a), (stage, b) in zip(events, events[1:]):
                self.ms[key][stage] += a.elapsed_time(b)


class StepProgram:
    """The device step at one (tier, Lmax): the port of fem_tpu's
    `_make_device_fn` (fem_tpu/pipeline/engine.py:363-378), one per key
    like its `_fn_for` (:703-707). Its body decodes the packed input
    (`pack_input`), runs map_core and packs the result (`pack_result`).

    On a card the body is captured once into a CUDA graph over a static
    input and output, in a memory pool of its own. A dispatch copies the
    packed batch into the input, replays the graph and copies the output
    to fresh pinned host memory: three enqueues on the engine's stream,
    under the program's lock so that dispatches from several threads do not
    interleave. The first dispatch runs the body eagerly on the engine's
    stream (the warm-up: the kernel library loads, the allocator fills, the
    kernels launch and are counted as they are) and that is its result;
    the capture follows, on a private stream, under the engine's capture
    lock and in thread-local mode, so that drain threads waiting on their
    events meanwhile do not break it. A capture or a replay that fails
    raises: nothing falls back to the eager path. The capture runs every
    wrapper once and launches nothing, so it records the launches
    (`kernels.recording_launches`) and each replay adds them.

    With `eager` (the engine's `eager_step`) and on the CPU, the body runs
    eagerly at every dispatch, on the same padded, packed input."""

    def __init__(self, key: tuple, index: DeviceIndex, params: FilterParams,
                 verify_cap: int, accept_cap: int, device: torch.device,
                 stream, capture_lock: threading.Lock):
        self.key = key
        self.index, self.params = index, params
        self.verify_cap, self.accept_cap = verify_cap, accept_cap
        self.device, self.stream, self._capture_lock = device, stream, capture_lock
        self.lock = threading.Lock()
        self.graph = None
        self.static_in = self.static_out = None
        self.launches = None  # Counter of (kernel, shape) a replay launches
        self.capture_s = None  # seconds the capture took
        self.pool_bytes = None  # device memory of the graph's pool, at its capture
        self.dispatches = 0
        self.replays = 0

    def body(self, packed: torch.Tensor, mark=None) -> torch.Tensor:
        codes, lengths = unpack_input(packed)
        return pack_result(map_core(self.index, codes, lengths, self.params,
                                    self.verify_cap, self.accept_cap, mark))

    def run(self, packed: torch.Tensor, eager: bool = False, timer=None):
        """Dispatch one packed batch (`pack_input`'s, in pinned memory on a
        card) without waiting for it: (the result on the host, the events
        a drain waits on, the StageTimer events)."""
        with span("fem::step.dispatch"):
            with self.lock:
                self.dispatches += 1
            if self.stream is None:  # the CPU
                return self.body(packed), [], None
            events = None
            with self.lock, torch.cuda.stream(self.stream):
                if eager or self.graph is None:
                    inp = packed.to(self.device, non_blocking=True)
                    if timer is not None:
                        events = timer.begin()
                    out = self.body(inp, (lambda st: timer.mark(events, st))
                                    if timer is not None else None)
                else:
                    self.static_in.copy_(packed, non_blocking=True)
                    self.graph.replay()
                    self.replays += 1
                    kernels.add_launches(self.launches)
                    out = self.static_out
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self.stream)
                if self.graph is None and not eager:
                    self._capture(inp)
            return host, [ready], events

    def _capture(self, static_in: torch.Tensor) -> None:
        """Capture the body over `static_in` (the warm-up's input, which
        the graph keeps)."""
        with span("fem::step.capture"), self._capture_lock:
            t0 = time.perf_counter()
            side = torch.cuda.Stream(self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                with kernels.recording_launches() as rec, torch.cuda.graph(
                        graph, stream=side, capture_error_mode="thread_local"):
                    out = self.body(static_in)
            except Exception as exc:
                raise RuntimeError(
                    f"CUDA graph capture of the step at (tier, Lmax) = {self.key} "
                    f"failed: {exc}") from exc
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = _pool_bytes(graph.pool())
        self.graph, self.static_in, self.static_out, self.launches = graph, static_in, out, rec

    def describe(self) -> dict:
        """GridProgram.describe's keys, for the one device as one cell."""
        return {"key": list(self.key), "dispatches": self.dispatches, "replays": self.replays,
                "cells": [{"cell": [0, 0], "device": str(self.device),
                           "segments": int(self.graph is not None),
                           "capture_s": self.capture_s,
                           "graph_MiB": None if self.pool_bytes is None else self.pool_bytes / 2**20,
                           "replays": self.replays}]}


class _CellGraphs:
    """One grid cell's CUDA graphs: a graph a segment, in one memory pool,
    replayed in the order they were captured."""

    def __init__(self, cell: tuple, device: torch.device):
        self.cell, self.device = cell, device
        self.graphs: list = []
        self.pool = None
        self.launches = collections.Counter()  # (kernel, shape) a replay launches
        self.capture_s = 0.0
        self.pool_bytes = None


class GridProgram:
    """The grid's step at one (tier, Lmax): the port of fem_tpu's jitted
    sharded program (`jax.jit(shard_map(...))`,
    fem_tpu/parallel/mesh.py:37-81 and parallel/sharded_index.py:244-349),
    one per key like its `_fn_for` (fem_tpu/pipeline/engine.py:618-707). Its
    input is the batch padded to the tier's batch size and split evenly over
    the data axis (fem_tpu/pipeline/engine.py:759-768, then P(DATA_AXIS)):
    row d is the packed rows [d * Bloc, (d + 1) * Bloc), uploaded once to
    each device that holds a cell of it.

    `step` (parallel/mesh.py:GridStep) cuts each cell's step into segments
    at the points where a row's cells meet: one segment a cell on a data
    grid, three on an index grid. On a card each segment of each cell is
    captured into a CUDA graph on the cell's device, a cell's segments in
    one memory pool. A dispatch copies the rows into the static inputs,
    replays segment k of every cell on its device's stream, reduces the
    values the cells stopped at eagerly (GridReducer, over
    torch.distributed where the grid spans processes: gloo cannot be
    captured, and nothing needs it to be) into the static tensors segment
    k + 1 reads, and so on; last, each cell's packed result goes to one
    pinned host buffer. The program's lock is held from the first upload to
    the last result copy: drain threads submit retries too, and the static
    buffers must never see two batches interleaved.

    As StepProgram's, the key's first dispatch runs eagerly on the engine's
    streams and is its result; the capture follows, on private streams, in
    thread-local mode, under the engine's capture lock. A capture that
    fails raises, and so does one whose kernels differ from the eager
    dispatch's (`kernels.recording_launches`); each replay adds the
    launches every cell's capture recorded. With `eager` (the engine's
    `eager_step`) and on the CPU the same segments run eagerly."""

    def __init__(self, key: tuple, step, indexes: dict, streams: dict,
                 capture_lock: threading.Lock):
        self.key, self.step, self.indexes = key, step, indexes
        self.streams, self._capture_lock = streams, capture_lock
        self.lock = threading.Lock()
        # (row, device) pairs this process uploads: one a row and device.
        self.rows = list(dict.fromkeys((d, dev) for d, _, dev in step.cells))
        self.cells = [_CellGraphs((d, i), dev) for d, i, dev in step.cells]
        self.captured = False
        self.dispatches = 0
        self.replays = 0
        self._static_rows: dict = {}
        self._points: list = []  # [(op, the cells' values)] where segment k stops
        self._sends: list = []  # the cells' static inputs of segment k + 1
        self._outs: list = []  # each cell's packed result

    def run(self, rows: dict, eager: bool = False):
        """Dispatch one padded batch, `rows` {d: row d's packed reads} (in
        pinned memory on a card), without waiting for it: (every cell's
        packed result in one host buffer, in `mesh.local_cells()` order,
        the events a drain waits on)."""
        with span("fem::step.dispatch"):
            if not self.streams:  # the CPU
                with self.lock:
                    self.dispatches += 1
                outs = self.step.run(self.indexes,
                                     {(d, dev): rows[d] for d, dev in self.rows}, {})
                return torch.cat([pack_result(out) for out in outs]), []
            devs = [c.device for c in self.cells]
            with self.lock:
                self.dispatches += 1
                if eager or not self.captured:
                    on_dev = {}
                    for d, dev in self.rows:
                        with torch.cuda.stream(self.streams[dev]):
                            on_dev[d, dev] = rows[d].to(dev, non_blocking=True)
                    with kernels.recording_launches() as warm:
                        outs = self.step.run(self.indexes, on_dev, self.streams)
                    kernels.add_launches(warm)
                    for k, dev in enumerate(devs):
                        with torch.cuda.stream(self.streams[dev]):
                            outs[k] = pack_result(outs[k])
                else:
                    for d, dev in self.rows:
                        with torch.cuda.stream(self.streams[dev]):
                            self._static_rows[d, dev].copy_(rows[d], non_blocking=True)
                    self._replay(devs)
                    outs = self._outs
                w = outs[0].numel()
                host = torch.empty(len(outs) * w, dtype=torch.int64, pin_memory=True)
                for k, (seg, dev) in enumerate(zip(outs, devs)):
                    with torch.cuda.stream(self.streams[dev]):
                        host[k * w : (k + 1) * w].copy_(seg, non_blocking=True)
                ready = []
                for stream in self.streams.values():
                    ready.append(torch.cuda.Event())
                    ready[-1].record(stream)
                if not (eager or self.captured):
                    self._capture(on_dev, warm)
            return host, ready

    def _replay(self, devs: list) -> None:
        from fem_tpu_torch.parallel.mesh import streams_of

        for k in range(len(self.cells[0].graphs)):
            for cell in self.cells:
                with torch.cuda.stream(self.streams[cell.device]):
                    cell.graphs[k].replay()
            if k < len(self._points):
                op, values = self._points[k]
                with streams_of(self.streams, *devs):
                    self.step.reduce(op, values, out=self._sends[k])
        self.replays += 1
        for cell in self.cells:
            kernels.add_launches(cell.launches)

    def _capture(self, static_rows: dict, warm: collections.Counter) -> None:
        """Capture every cell's segments over `static_rows` (the warm-up's
        uploads, which the graphs keep). Between two segments nothing is
        reduced: the captured kernels did not run. Each cell's next segment
        reads static tensors of the values' structure, which a replay's
        reductions write."""
        from fem_tpu_torch.parallel.mesh import static_like

        step = self.step
        with span("fem::step.capture"), self._capture_lock:
            sides = {dev: torch.cuda.Stream(dev) for dev in self.streams}
            gens = [step.cell_steps(d, self.indexes[d, i], static_rows[d, dev])
                    for d, i, dev in step.cells]
            sends = [None] * len(gens)
            try:
                while True:
                    asks = []
                    for cell, g, value in zip(self.cells, gens, sends):
                        graph = torch.cuda.CUDAGraph()
                        t0 = time.perf_counter()
                        with kernels.recording_launches() as rec, torch.cuda.graph(
                                graph, pool=cell.pool, stream=sides[cell.device],
                                capture_error_mode="thread_local"):
                            op, v = step.advance(g, value)
                            asks.append((op, pack_result(v) if op is None else v))
                        cell.capture_s += time.perf_counter() - t0
                        cell.pool = graph.pool()
                        cell.graphs.append(graph)
                        cell.launches.update(rec)
                    op = step.lockstep(asks)
                    if op is None:
                        break
                    values = [v for _, v in asks]
                    self._points.append((op, values))
                    sends = [static_like(v) for v in values]
                    self._sends.append(sends)
            except Exception as exc:
                raise RuntimeError(
                    f"CUDA graph capture of the grid step at (tier, Lmax) = {self.key} "
                    f"failed: {exc}") from exc
            for cell in self.cells:
                cell.pool_bytes = _pool_bytes(cell.pool)
        captured = sum((c.launches for c in self.cells), collections.Counter())
        if captured != warm:
            raise RuntimeError(
                f"the grid step's graphs at (tier, Lmax) = {self.key} launch {dict(captured)}, "
                f"its eager dispatch launched {dict(warm)}")
        self._static_rows = static_rows
        self._outs = [v for _, v in asks]
        self.captured = True

    def describe(self) -> dict:
        """The key, dispatches and replays, and each cell's segments,
        capture seconds, graph MiB and replays."""
        return {"key": list(self.key), "dispatches": self.dispatches, "replays": self.replays,
                "cells": [{"cell": list(c.cell), "device": str(c.device),
                           "segments": len(c.graphs), "capture_s": c.capture_s,
                           "graph_MiB": None if c.pool_bytes is None else c.pool_bytes / 2**20,
                           "replays": self.replays} for c in self.cells]}


def _pool_bytes(pool) -> int:
    """Device memory the caching allocator holds in `pool` (a graph's)."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


class Pending(NamedTuple):
    """A dispatched batch: what `submit_batch` hands to a drain."""

    batch: ReadBatch
    flat: torch.Tensor  # pack_result's segments on the host (pinned on a card)
    ready: list  # torch.cuda.Events recorded after the copies (none on the CPU)
    tier: int
    seq: int | None  # stream position of a tier-0 batch
    origins: list | None  # a pooled retry batch: its reads' origin seqs
    events: list | None  # StageTimer events of this batch
    trace: tuple | None  # while tracing: (its fem::submit span's id, its batch id)


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
        self.args = args
        self.reference = reference
        self.config = config or EngineConfig()
        if self.config.mesh is not None and self.config.index_mesh is not None:
            raise ValueError("EngineConfig takes a mesh or an index_mesh, not both")
        self.grid = self.config.index_mesh or self.config.mesh  # None: one device
        devices = [torch.device(device)] if self.grid is None else self.grid.local_devices()
        for dev in devices:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {dev} requested but CUDA is not available")
        self.device = devices[0]
        self._cross = self.grid is not None and self.grid.crosses_processes
        # One compute stream per device: every device step and every result
        # copy is enqueued on it, from whichever thread submits.
        self._streams = {}
        for dev in devices:
            if dev.type == "cuda":
                self._streams[dev] = torch.cuda.Stream(dev)
                self._streams[dev].wait_stream(torch.cuda.current_stream(dev))
        self._stream = self._streams.get(self.device)
        self._cell_index: dict = {}  # (d, i) -> DeviceIndex of a grid's cell
        if self.config.index_mesh is not None:
            occurrences = self._init_sharded_index(index)
            self.dindex = None
        else:
            occurrences = index.num_occurrences
            self.dindex = device_index_from_host(index, reference, self.device)
            if self.grid is not None:  # the whole index once per device
                on = {self.device: self.dindex}
                for d, i, dev in self.grid.local_cells():
                    if dev not in on:
                        on[dev] = device_index_from_host(index, reference, dev)
                    self._cell_index[d, i] = on[dev]
        self._native = NativeEmitter(reference, args.error_threshold)
        self._cpu_mapper = NativeCpuMapper(args, reference, index)
        self._fallback_lock = threading.Lock()
        self.fallback_reads = 0  # reads mapped by the host mapper
        # Capacity-retry ladder (tier 0 = the EngineConfig caps themselves).
        if self.config.tiers is None:
            self.tiers = self._default_tiers()
        else:
            self.tiers = tuple(self.config.tiers)
        # Tier 0's cap_occ: the config's, or derived from the index once.
        self.tier0_cap_occ = self.config.cap_occ
        if self.tier0_cap_occ is None:
            self.tier0_cap_occ = tier0_cap_occ(occurrences, args.kmer_size, args.num_qgrams,
                                               self.tiers[0].cap_occ if self.tiers else None)
        self.retried_reads = 0  # reads mapped again at tier >= 1
        self.tier_dispatches = 0  # device steps at tier >= 1: the retry tax
        # a heavy-tailed genome pays (the reference's unbounded merge pays
        # none, src/filter.c:80-131)
        self.dispatches_by_tier = collections.Counter()  # the same by tier
        # Stream-mode retry pool and completion watermark (for checkpoints).
        self._pool_lock = threading.Lock()
        self._retry_pool: list | None = None  # set inside map_stream
        self._seq = 0
        self._batch_state: Dict[int, list] = {}  # seq -> [reads, outstanding, drained]
        self._watermark_seq = 0
        self._watermark_reads = 0
        self.consumed_reads = 0
        self.stage_timer: StageTimer | None = None  # one device only; needs eager_step
        # The step programs by (tier, Lmax): StepPrograms on one device,
        # GridPrograms on a grid. `eager_step` runs their bodies eagerly on
        # the card, the counterpart of jax.disable_jit(), for what a graph's
        # replay never calls: the StageTimer's events and wrappers of the
        # kernels' call sites.
        self.programs: Dict[tuple, "StepProgram | GridProgram"] = {}
        self.eager_step = False
        self._programs_lock = threading.Lock()
        self._capture_lock = threading.Lock()

    def report(self) -> dict:
        """What the engine did and holds, for a caller to serialize:
        retried, dispatched and host-mapped reads, each device's peak
        memory, each step program (its key, dispatches and replays, and each
        cell's segments, capture seconds, graph MiB and replays), and each
        grid cell's index (occurrences, reference bytes, bytes in all)."""
        cells = {(0, 0): self.dindex} if self.dindex is not None else self._cell_index
        return {
            "tier0_cap_occ": self.tier0_cap_occ,
            "tier0_cap_occ_derived": self.config.cap_occ is None,
            "retried_reads": self.retried_reads,
            "tier_dispatches": self.tier_dispatches,
            "dispatches_by_tier": {str(t): n for t, n in sorted(self.dispatches_by_tier.items())},
            "fallback_reads": self.fallback_reads,
            "peak_device_bytes": {str(d): torch.cuda.max_memory_allocated(d)
                                  for d in sorted(self._streams, key=str)},
            "programs": [p.describe() for _, p in sorted(self.programs.items())],
            "cells": [{"cell": list(key), "occurrences": int(ix.occ.numel()),
                       "ref_bytes": int(ix.ref_flat.numel()), "nbytes": ix.nbytes()}
                      for key, ix in sorted(cells.items())],
        }

    def _init_sharded_index(self, index: FemIndex) -> int:
        """Each cell's shard on its device, once per (device, shard).
        Returns the largest shard's occurrences (every process sees every
        shard's)."""
        from fem_tpu_torch.parallel.sharded_index import build_sharded_index

        _, n_ip = self._mesh_shape()
        sh = build_sharded_index(index, self.reference, n_ip)
        self._sharded_halo = sh.halo
        on = {}
        for d, i, dev in self.grid.local_cells():
            if (dev, i) not in on:
                on[dev, i] = sh.device_index(i, dev)
            self._cell_index[d, i] = on[dev, i]
        return max(len(o) for o in sh.occ)

    def _mesh_shape(self) -> Tuple[int, int]:
        """(data shards, index shards)."""
        grid = self.config.index_mesh or self.config.mesh
        return (1, 1) if grid is None else tuple(grid.grid.shape)

    def _default_tiers(self) -> tuple:
        """The retry ladder above tier 0 when the config names none: about
        8x the caps at a batch of at most 512, then a 64-read heavy-tail
        tier. A cap_occ left to the index counts as BASE_CAP_OCC here, so
        the ladder keeps its shapes whatever tier 0 derives.

        FEM_TPU_TIERS overrides it: "none" for no ladder, or
        semicolon-separated rungs of
        "batch:cap_occ:cap_cand:verify_per_read:accept_per_read", the
        tuning knob for heavy-tailed genomes where the retry tax dominates."""
        c = self.config
        cap_occ = BASE_CAP_OCC if c.cap_occ is None else c.cap_occ
        n_dp, _ = self._mesh_shape()

        def align(b):  # batch must split evenly over the data axis
            return max(-(-b // n_dp) * n_dp, n_dp)

        def cap8(x):  # occurrence slabs are 8-slot-chunk aligned
            return -(-x // 8) * 8

        env = os.environ.get("FEM_TPU_TIERS")
        if env == "none":
            return ()
        if env:
            rungs = []
            try:
                for spec in env.split(";"):
                    b, occ, cand, vpr, apr = (int(x) for x in spec.split(":"))
                    if min(b, occ, cand, vpr, apr) < 1:
                        raise ValueError("all fields must be >= 1")
                    rungs.append(TierConfig(
                        batch_size=align(b), cap_occ=cap8(occ), cap_cand=cap8(cand),
                        verify_per_read=vpr, accept_per_read=apr,
                    ))
            except ValueError as exc:
                raise ValueError(
                    f"FEM_TPU_TIERS={env!r} is malformed ({exc}); expected "
                    "semicolon-separated rungs of "
                    "'batch:cap_occ:cap_cand:verify_per_read:accept_per_read'"
                ) from exc
            return tuple(rungs)

        t1 = TierConfig(
            batch_size=align(min(c.batch_size, 512)),
            cap_occ=cap8(max(8 * cap_occ, 512)),
            cap_cand=cap8(max(8 * c.cap_cand, 512)),
            verify_per_read=max(int(4 * c.verify_per_read), 32),
            accept_per_read=max(int(4 * c.accept_per_read), 16),
        )
        t2 = TierConfig(
            batch_size=align(min(c.batch_size, 64)),
            cap_occ=max(cap8(8 * t1.cap_occ), 4096),
            cap_cand=max(cap8(8 * t1.cap_cand), 4096),
            verify_per_read=max(8 * t1.verify_per_read, 2048),
            accept_per_read=max(8 * t1.accept_per_read, 512),
        )
        return (t1, t2)

    def _tier(self, tier: int) -> TierConfig:
        if tier == 0:
            c = self.config
            return TierConfig(
                batch_size=c.batch_size, cap_occ=self.tier0_cap_occ, cap_cand=c.cap_cand,
                verify_per_read=c.verify_per_read, accept_per_read=c.accept_per_read,
            )
        return self.tiers[tier - 1]

    @staticmethod
    def _caps(tc: TierConfig) -> Tuple[int, int]:
        """(verify slots, accept slots) of one device step at this tier."""
        verify_cap = int(2 * tc.batch_size * tc.verify_per_read)
        accept_cap = max(int(2 * tc.batch_size * tc.accept_per_read), 64)
        return verify_cap, accept_cap

    def _cell_caps(self, tc: TierConfig) -> Tuple[int, int]:
        """(verify slots, accept slots) of one cell of a grid: the step's
        over the cells (fem_tpu/pipeline/engine.py:629-652)."""
        verify_cap, accept_cap = self._caps(tc)
        n_dp, n_ip = self._mesh_shape()
        return verify_cap // (n_dp * n_ip), max(accept_cap // (n_dp * n_ip), 8)

    def _segment_reads(self, tier: int) -> int:
        """Reads in one segment of a dispatch's result: every dispatch is
        padded to its tier's batch size, which a grid splits evenly over
        its data rows."""
        n_dp, _ = self._mesh_shape()
        return self._tier(tier).batch_size // n_dp

    def _program(self, tier: int, Lmax: int):
        """The step program of (tier, Lmax), made at its first use: a
        StepProgram on one device, a GridProgram on a grid."""
        key = (tier, Lmax)
        with self._programs_lock:
            prog = self.programs.get(key)
            if prog is None:
                tc = self._tier(tier)
                params = FilterParams.from_args(
                    self.args, Lmax, cap_occ=tc.cap_occ, cap_cand=tc.cap_cand)
                if self.grid is None:
                    prog = StepProgram(key, self.dindex, params, *self._caps(tc), self.device,
                                       self._stream, self._capture_lock)
                else:
                    prog = GridProgram(key, self._grid_step(params, tc), self._cell_index,
                                       self._streams, self._capture_lock)
                self.programs[key] = prog
        return prog

    def _packed(self, batch: ReadBatch, tc: TierConfig) -> torch.Tensor:
        """The batch padded to the tier's batch size and packed
        (`pack_input`, into pinned memory on a card); the native reader's
        `packed` buffer as it is, where it has that shape and is pinned on
        a card."""
        pin = bool(self._streams)
        packed = batch.packed
        if (packed is None or tuple(packed.shape) != (tc.batch_size, batch.codes.shape[1] + 4)
                or (pin and not packed.is_pinned())):
            with span("fem::pack"):
                packed = pack_input(batch.codes[: batch.num_reads], batch.lengths,
                                    tc.batch_size, pin)
        return packed

    def submit_batch(self, batch: ReadBatch, tier: int = 0, origins: list | None = None):
        """Enqueue the device step of one batch and the copy of its result,
        without waiting for either; pair with `drain_batch`. `tier` selects
        the capacity rung: 0 = the config's own caps, >= 1 = the retry
        ladder for reads that overflowed a smaller tier. The batch is padded
        to the tier's batch size and packed (`_packed`) and goes to the
        (tier, Lmax) step program, on a grid split evenly over the data
        rows. Drain threads call this too (retries); the program enters the
        engine's streams itself: the current stream is per thread."""
        tc = self._tier(tier)
        n = batch.num_reads
        if n > tc.batch_size:
            raise ValueError(
                f"batch of {n} reads exceeds batch_size {tc.batch_size} of tier {tier}")
        timer = self.stage_timer
        if (self.grid is None and timer is not None and self._stream is not None
                and not self.eager_step):
            raise ValueError("a StageTimer times the eager step: set engine.eager_step")
        with span("fem::submit", tier=tier, reads=n) as sp:
            if tier > 0:
                with self._fallback_lock:
                    self.tier_dispatches += 1
                    self.dispatches_by_tier[tier] += 1
            if self.grid is not None:
                flat, ready = self._submit_grid(batch, tier, tc)
                events = None
            else:
                flat, ready, events = self._program(tier, batch.codes.shape[1]).run(
                    self._packed(batch, tc), self.eager_step, timer)
            return self._register_pending(batch, flat, ready, tier, origins, events, sp)

    def _submit_grid(self, batch: ReadBatch, tier: int, tc: TierConfig):
        """One step over the grid's cells in this process, through the
        (tier, Lmax) GridProgram: the batch padded to the tier's batch size
        and split into n_dp rows of batch_size / n_dp reads, as fem_tpu's
        sharded program takes it; each cell's packed result copied into
        one host buffer (segments in `local_cells` order), an event a
        device after its copies."""
        Lmax = batch.codes.shape[1]
        n_dp, _ = self._mesh_shape()
        if self.config.index_mesh is not None:
            e = self.args.error_threshold
            if Lmax + 2 * e > self._sharded_halo:
                # Owned candidates' verification bands must stay inside the
                # shard's [start - halo, end + halo) slice.
                raise ValueError(
                    f"read length {Lmax} exceeds the sharded-index halo "
                    f"({self._sharded_halo}); rebuild with a larger halo")
        if tc.batch_size % n_dp:
            raise ValueError(f"batch size {tc.batch_size} not divisible by data mesh {n_dp}")
        Bloc = tc.batch_size // n_dp
        packed = self._packed(batch, tc)
        prog = self._program(tier, Lmax)
        return prog.run({d: packed[d * Bloc : (d + 1) * Bloc] for d, _ in prog.rows},
                        self.eager_step)

    def _grid_step(self, params: FilterParams, tc: TierConfig):
        """The grid's step at these shapes, cut into its segments
        (parallel/mesh.py:GridStep)."""
        verify_cap, accept_cap = self._cell_caps(tc)
        if self.config.index_mesh is not None:
            from fem_tpu_torch.parallel.sharded_index import make_index_sharded_map_fn

            return make_index_sharded_map_fn(
                self.grid, params, verify_cap, accept_cap, gather_rows=self._cross)
        from fem_tpu_torch.parallel.mesh import make_sharded_map_fn

        return make_sharded_map_fn(self.grid, params, verify_cap, accept_cap)

    def _register_pending(self, batch, flat, ready, tier, origins, events, sp) -> Pending:
        seq = None
        if tier == 0:
            with self._pool_lock:
                seq = self._seq
                self._seq += 1
                self._batch_state[seq] = [batch.num_reads, 0, False]
        trace = None
        if sp.id is not None:  # a retry batch's id: its submit span's, negated
            trace = (sp.id, seq if tier == 0 else -sp.id)
            sp.tag(batch=trace[1])
        return Pending(batch, flat, ready, tier, seq, origins, events, trace)

    def _map_read_fallback(self, name, seq, qual) -> Tuple[List[bytes], MappingStats]:
        """Exact host mapping of one read by the in-process C++ mapper."""
        with self._fallback_lock:
            self.fallback_reads += 1
        blob, st = self._cpu_mapper.map_reads([name], [seq], [qual])
        stats = MappingStats(*(int(x) for x in st))
        return ([blob] if blob else []), stats

    def drain_batch(self, pending: Pending) -> Tuple[List[bytes], MappingStats]:
        if self._cross:
            return self._drain_cross_host(pending)
        return self._drain(pending, per_read=False)

    def _drain_stream(self, pending: Pending):
        """Stream-mode drain: completion marks (batch drained, retry
        resolved, watermark advance) are DEFERRED into `acks` closures that
        map_stream runs only after the consumer has pulled the NEXT item,
        i.e. after it had the chance to write this one's records. Marking
        at drain time (drain threads run up to pipeline_depth batches ahead
        of the consumer) would let a checkpoint taken right after a crash
        skip drained-but-unwritten reads on resume."""
        acks: list = []
        if self._cross:
            recs, stats = self._drain_cross_host(pending, acks=acks)
        else:
            recs, stats = self._drain(pending, per_read=False, acks=acks)
        # Stream position: original (tier-0) batches advance it; retry
        # batches re-emit reads already counted by their origin batch.
        nreads = pending.batch.num_reads if pending.tier == 0 else 0
        return recs, stats, acks, nreads

    def _drain(self, pending: Pending, per_read: bool, acks: list | None = None):
        """Wait for one dispatched batch's result, emit its covered reads,
        and route its overflow reads (the device's per-read fallback bits)
        onward: inherent-limit reads to the host mapper at once, capacity
        reads to the next tier: pooled for a pipelined retry in stream
        mode, mapped synchronously otherwise, with their records spliced
        back in read order. With `per_read`, returns one record list per
        read."""
        batch, flat, ready, tier, seq, origins, events, trace = pending
        cause, bid = trace or (None, None)
        with span("fem::drain", cause=cause, batch=bid, tier=tier, reads=batch.num_reads):
            with span("fem::drain.wait"):
                for ev in ready:
                    ev.synchronize()
                if events is not None:
                    self.stage_timer.collect(events, tier)
            n = batch.num_reads
            n_dp, n_ip = self._mesh_shape()
            Bloc = self._segment_reads(tier)
            acc_cap = self._cell_caps(self._tier(tier))[1]
            with span("fem::drain.unpack"):
                host = unpack_result(flat.numpy(), acc_cap, Bloc, n_dp * n_ip)
                hits = accepted_hits(host, acc_cap)
            # Segments are data-row-major; a row's index shards carry identical
            # per-read values (reduced in the step): keep index shard 0's.
            first = slice(0, n_dp * n_ip, n_ip)
            fb = host["fb"].reshape(n_dp, n_ip, Bloc)[:, 0].reshape(-1)
            inh = host["inherent"].reshape(n_dp, n_ip, Bloc)[:, 0].reshape(-1)
            fb_idx = np.flatnonzero(fb[:n])
            inh_idx = fb_idx[inh[fb_idx]]  # no capacity tier can fix these
            cap_idx = fb_idx[~inh[fb_idx]]
            # Stream mode, tier 0: capacity reads wait in the retry pool and
            # come out as items of their own; otherwise their records are
            # spliced in here, like the inherent reads' always are.
            pooled = tier == 0 and self._retry_pool is not None and bool(self.tiers)
            splice = inh_idx.size > 0 or (cap_idx.size > 0 and not pooled)

            with span("fem::emit", reads=n - int(fb_idx.size)):
                blob, ends, stats = self._emit_native(
                    batch, hits, n_dp * Bloc, fb, int(host["sum_nc"][first].sum()),
                    int(host["sum_dp"][first].sum()), per_read or splice)
            # A read is counted by whichever drain finally emits it.
            stats.num_reads = n - int(fb_idx.size)

            replaced: Dict[int, list] = {}  # read -> its records from elsewhere
            if inh_idx.size:
                with span("fem::host_map", reads=int(inh_idx.size)):
                    for i in inh_idx:
                        replaced[int(i)], s = self._map_read_fallback(
                            batch.names[i], batch.seqs[i], batch.quals[i]
                        )
                        stats += s
            reads = [(batch.names[i], batch.seqs[i], batch.quals[i]) for i in cap_idx]
            if pooled:
                with self._pool_lock:
                    self._batch_state[seq][1] = len(reads)
                    self._retry_pool.extend((seq, *r) for r in reads)
            elif reads:
                fb_segs, fb_stats = self._map_reads_at_tier(reads, tier + 1)
                replaced.update(zip((int(i) for i in cap_idx), fb_segs))
                stats += fb_stats

            def mark():
                with self._pool_lock:
                    for s0 in origins or ():
                        st = self._batch_state.get(s0)
                        if st is not None:
                            st[1] -= 1
                    if seq is not None:
                        self._batch_state[seq][2] = True
                self._advance_watermark()

            if acks is None:
                mark()
            else:
                acks.append(mark)

            with span("fem::splice"):
                return _splice(blob, ends, replaced, per_read), stats

    def _drain_cross_host(self, pending: Pending, acks: list | None = None):
        """Drain on a grid that spans processes (fem_tpu/pipeline/engine.py
        `_drain_cross_host`): each data row's segments are all-gathered over
        the processes of the row, and the row's owner (round-robin over
        them) emits its reads; counters cover the owned reads and are summed
        over the processes at the end of the stream
        (multihost.allreduce_stats). The owned rows' fallback bitmaps are
        all-gathered over every process, so each derives the same list of
        capacity-overflow reads and joins the same tier dispatches, in the
        same order; inherent reads go to the row owner's host mapper, and
        reads past the last tier round-robin over the processes."""
        from fem_tpu_torch.parallel.multihost import allgather_bitmaps, gather_rows

        batch, flat, ready, tier, seq, origins, events, trace = pending
        cause, bid = trace or (None, None)
        with span("fem::drain", cause=cause, batch=bid, tier=tier, reads=batch.num_reads):
            for ev in ready:
                ev.synchronize()
            mesh = self.grid
            n = batch.num_reads
            n_dp, n_ip = self._mesh_shape()
            Bloc = self._segment_reads(tier)
            acc_cap = self._cell_caps(self._tier(tier))[1]
            rows = gather_rows(mesh, flat.reshape(len(mesh.local_cells()), -1))
            me = mesh.rank
            fb_own = np.zeros(n_dp * Bloc, bool)
            inh_own = np.zeros(n_dp * Bloc, bool)
            owned = {}
            for d in sorted(rows):
                if mesh.row_owner(d) != me:
                    continue
                owned[d] = host = unpack_result(rows[d].reshape(-1), acc_cap, Bloc, n_ip)
                fb_own[d * Bloc : (d + 1) * Bloc] = host["fb"][:Bloc]
                inh_own[d * Bloc : (d + 1) * Bloc] = host["inherent"][:Bloc]
            fb_all, inh_all = allgather_bitmaps(fb_own, inh_own)

            records: List[bytes] = []
            stats = MappingStats()
            for d, host in owned.items():
                lo = d * Bloc
                n_row = min(max(n - lo, 0), Bloc)
                if n_row == 0:
                    continue
                rb = ReadBatch(batch.names[lo : lo + n_row], batch.seqs[lo : lo + n_row],
                               batch.quals[lo : lo + n_row], batch.codes[lo : lo + n_row],
                               batch.lengths[lo : lo + n_row])
                fb, inh = host["fb"][:Bloc], host["inherent"][:Bloc]
                fb_idx = np.flatnonzero(fb[:n_row])
                inh_idx = fb_idx[inh[fb_idx]]
                with span("fem::emit", reads=n_row - int(fb_idx.size)):
                    blob, ends, st = self._emit_native(
                        rb, accepted_hits(host, acc_cap), Bloc, fb, int(host["sum_nc"][0]),
                        int(host["sum_dp"][0]), inh_idx.size > 0)
                st.num_reads = n_row - int(fb_idx.size)
                replaced = {}
                for i in inh_idx:  # the row owner host-maps its inherent reads
                    replaced[int(i)], s = self._map_read_fallback(
                        rb.names[i], rb.seqs[i], rb.quals[i])
                    st += s
                records.extend(_splice(blob, ends, replaced, False))
                stats += st

            # Capacity retry, collectively: the same list on every process.
            cap_idx = np.flatnonzero(fb_all[:n] & ~inh_all[:n])
            reads = [(batch.names[i], batch.seqs[i], batch.quals[i]) for i in cap_idx]
            if reads and tier < len(self.tiers):
                with self._fallback_lock:
                    self.retried_reads += len(reads)
                B_t = self._tier(tier + 1).batch_size
                for lo in range(0, len(reads), B_t):
                    r2, s2 = self._drain_cross_host(
                        self.submit_batch(self._subbatch(reads[lo : lo + B_t]), tier + 1))
                    records.extend(r2)
                    stats += s2
            elif reads:
                nproc = dist.get_world_size()
                for j, (nm, sq, ql) in enumerate(reads):
                    if j % nproc == me:
                        r, s = self._map_read_fallback(nm, sq, ql)
                        records.extend(r)
                        stats += s

            def mark():
                if seq is not None:
                    with self._pool_lock:
                        self._batch_state[seq][2] = True
                self._advance_watermark()

            if acks is None:
                mark()
            else:
                acks.append(mark)
            return records, stats

    def _advance_watermark(self) -> None:
        with self._pool_lock:
            while True:
                st = self._batch_state.get(self._watermark_seq)
                if st is None or not st[2] or st[1] > 0:
                    break
                self._watermark_reads += st[0]
                del self._batch_state[self._watermark_seq]
                self._watermark_seq += 1

    @property
    def watermark_reads(self) -> int:
        """Reads in the longest fully-emitted stream prefix: the safe
        resume offset for checkpointing (deferred retries included)."""
        return self._watermark_reads

    def _subbatch(self, reads) -> ReadBatch:
        """A device batch from [(name, seq, qual)] triples."""
        lengths = np.array([len(sq) for _, sq, _ in reads], np.int32)
        Lmax = max(128, -(-int(lengths.max()) // 32) * 32)
        codes = np.full((len(reads), Lmax), 4, np.uint8)
        for i, (_, sq, _) in enumerate(reads):
            codes[i, : len(sq)] = encode(sq)
        return ReadBatch(
            [nm for nm, _, _ in reads], [sq for _, sq, _ in reads],
            [ql for _, _, ql in reads], codes, lengths,
        )

    def _map_reads_at_tier(self, reads, tier):
        """Map `reads` [(name, seq, qual)] again at the given retry tier,
        synchronously (the exact host mapper past the last tier). Returns
        one record list per read and their recomputed stats."""
        stats = MappingStats()
        per = []
        if tier > len(self.tiers):
            with span("fem::host_map", reads=len(reads)):
                for nm, sq, ql in reads:
                    r, s = self._map_read_fallback(nm, sq, ql)
                    per.append(r)
                    stats += s
            return per, stats
        with self._fallback_lock:
            self.retried_reads += len(reads)
        B_t = self._tier(tier).batch_size
        with span("fem::retry.sync", tier=tier, reads=len(reads)):
            for lo in range(0, len(reads), B_t):
                sub = self._subbatch(reads[lo : lo + B_t])
                segs, s = self._drain(self.submit_batch(sub, tier), per_read=True)
                per.extend(segs)
                stats += s
        return per, stats

    def _emit_native(self, batch: ReadBatch, hits: tuple, B: int, fb: np.ndarray,
                     sum_nc: int, sum_dp: int, want_ends: bool):
        """Counters from the device sums and one native call for the
        mapping sort, traceback and SAM formatting: (SAM blob of the covered
        reads in read order, per-read end offsets into it or None, stats).
        `hits` are `accepted_hits`' arrays over lanes [0, 2B) (B >= the
        batch's reads: a grid pads it), `fb` the (B,) fallback bits. Drain
        threads call it side by side: the native call releases the
        interpreter lock."""
        n = batch.num_reads
        stats = MappingStats(
            num_candidates=sum_nc, num_candidates_without_additional_qgram_filter=sum_dp,
        )
        a_lane, a_sid, a_pos, a_ed, a_end = hits
        read_id = a_lane % B
        # Generation order per read: + strand then - strand, each ascending
        # (src/map.c:29-49); a stable sort by read id keeps exactly that.
        order = np.argsort(read_id, kind="stable")
        order = order[~fb[read_id[order]]]  # fallback reads re-map
        read_id = read_id[order]
        map_counts = np.bincount(read_id, minlength=B)[:n].astype(np.int32)
        stats.num_mappings = int(map_counts.sum())
        stats.num_mapped_reads = int((map_counts > 0).sum())
        res = self._native.emit(
            batch,
            map_counts,
            (a_lane[order] >= B).astype(np.uint8),
            a_ed[order].astype(np.uint8),
            a_sid[order].astype(np.int32),
            a_pos[order].astype(np.int64),
            a_end[order].astype(np.int32),
            want_read_ends=want_ends,
        )
        blob, ends = res if want_ends else (res, None)
        return blob, ends, stats

    def map_batch(self, batch: ReadBatch) -> Tuple[List[bytes], MappingStats]:
        """Map one read batch synchronously: SAM chunks in read order
        (capacity-overflow reads are mapped again on higher tiers and their
        records spliced back in place) + stats."""
        return self.drain_batch(self.submit_batch(batch))

    def map_stream(
        self, batches: Iterable[ReadBatch], depth: int | None = None,
        ordered: bool = False,
    ) -> Iterator[Tuple[List[bytes], MappingStats]]:
        """Map a stream of batches keeping `depth` batches in flight
        (default: the config's pipeline_depth): batch N + 1's device step
        is enqueued while drain threads wait for, emit and hand over batch
        N (the reference's reader/mapper/writer overlap,
        src/FEM_map.c:174-198).

        With `ordered`, capacity-overflow reads are mapped again
        synchronously inside each batch's drain and their records spliced
        back in read order, so the output is an exact read-order prefix at
        every yield: what checkpoint/resume needs to truncate and resume
        without losing or doubling a record. It serializes only the (rare)
        overflow reads; the unordered stream pipelines them instead.

        Unordered: capacity-overflow reads of drained batches gather in a
        retry pool and go out again as pipelined tier-1 batches (deeper
        tiers run synchronously inside those drains), so heavy-tailed
        genomes keep the pipeline full. Original batches yield in
        submission order with overflow reads' records left out; retry
        batches yield as extra (records, stats) items. Record set and
        counter totals are exact, the reference's unordered t>1 emission
        contract (src/FEM_map.c:182-189). An exception in a drain thread
        is raised to the consumer and ends the stream."""
        depth = depth or self.config.pipeline_depth
        pool: list = []
        # Across processes every drain issues collectives (row gathers,
        # bitmaps, tier dispatches): drains run on this, the consumer,
        # thread in stream order, and retries stay inside them.
        self._retry_pool = None if (ordered or self._cross) else pool
        retry_B = self._tier(1).batch_size if self._retry_pool is not None and self.tiers else 0
        self.consumed_reads = 0  # stream position of the last consumed item

        def consume(item):
            # Completion marks run only after the consumer pulls the NEXT
            # item: by then it has had the chance to persist this one's
            # records, so the checkpoint watermark never runs ahead of the
            # output file (see _drain_stream). `consumed_reads` advances
            # BEFORE the yield: it is the stream position INCLUDING the
            # item the consumer is handling (in ordered mode, the exact
            # read count whose records the consumer will have written once
            # it has processed the item).
            recs, stats, acks, nreads = item
            self.consumed_reads += nreads
            yield recs, stats
            for a in acks:
                a()

        q: deque = deque()
        try:
            with ThreadPoolExecutor(max_workers=max(2, depth)) as ex:

                def flush_retries(min_fill: int):
                    while True:
                        with self._pool_lock:
                            if len(pool) < max(min_fill, 1):
                                return
                            take = pool[:retry_B]
                            del pool[:retry_B]
                        with span("fem::retry.flush", tier=1, reads=len(take)) as sp:
                            rb = self._subbatch([r[1:] for r in take])
                            with self._fallback_lock:
                                self.retried_reads += rb.num_reads
                            pending = self.submit_batch(
                                rb, tier=1, origins=[r[0] for r in take])
                            sp.tag(batch=pending.trace and pending.trace[1])
                            q.append(ex.submit(self._drain_stream, pending))

                def drain_later(pending):
                    if self._cross:
                        return _Later(self._drain_stream, pending)
                    return ex.submit(self._drain_stream, pending)

                def oldest():
                    with span("fem::stream.wait"):
                        return q.popleft().result()

                feed = iter(batches)
                while True:
                    with span("fem::feed.wait"):
                        batch = next(feed, None)
                    if batch is None:
                        break
                    if not batch.num_reads:
                        continue
                    q.append(drain_later(self.submit_batch(batch)))
                    if retry_B:
                        flush_retries(retry_B)
                    while len(q) > depth:
                        yield from consume(oldest())
                while q or pool:
                    while q:
                        yield from consume(oldest())
                    if retry_B:
                        flush_retries(1)
        finally:
            self._retry_pool = None


class _Later:
    """A future run when its result is read, on the reading thread."""

    def __init__(self, fn, *args):
        self._fn, self._args = fn, args

    def result(self):
        return self._fn(*self._args)


def _splice(blob: bytes, ends, replaced: dict, per_read: bool) -> list:
    """Records of a batch: the emitter's blob holds the covered reads'
    records in read order and nothing for a fallback read (ends[r] is read
    r's end in it, None when not asked for); `replaced` maps a read to its
    records from elsewhere. One record list per read with `per_read`, else
    record chunks in read order."""
    if ends is None:
        return [blob] if blob else []
    starts = np.concatenate([[0], ends[:-1]])
    if per_read:
        segs = [[blob[a:b]] if b > a else [] for a, b in zip(starts.tolist(), ends.tolist())]
        for i, recs in replaced.items():
            segs[i] = recs
        return segs
    chunks, prev = [], 0
    for i in sorted(replaced):  # cut the blob only where records go in
        chunks.append(blob[prev : int(starts[i])])
        chunks.extend(replaced[i])
        prev = int(ends[i])
    chunks.append(blob[prev:])
    return [c for c in chunks if c]
