"""The batched mapping engine (fem_tpu/pipeline/engine.py), on one CUDA
device or on a grid of them (parallel/).

Reads are batched; both strands go through one device step (hash ->
q-gram DP -> candidate filter -> banded Myers, ops/step.py), and the small
set of accepted hits comes back to the host in one copy for traceback and
SAM emission by the native emitter (native/). The device step has fixed
capacities (occurrence slab, candidate list, verify and accept slots). A
read that exceeds one is mapped again on the next rung of the
capacity-retry ladder (`TierConfig`: a smaller batch with bigger
capacities), and past the last rung by the exact host mapper; a read that
hits an inherent limit (incomplete DP) goes to the host mapper at once.
So the ALL-mappings guarantee survives fixed capacities.

The engine always runs on a grid: `EngineConfig.mesh` splits reads over a
data axis, `.index_mesh` also splits the index by coordinate over an index
axis, and with neither the one device is a grid of one cell. The step runs
as a `GridProgram` per (tier, Lmax), the counterpart of fem_tpu's one
jitted program per shape: every batch is padded to its tier's batch size
and split evenly over the data rows; each cell maps its row's reads
against its shard and packs a segment of its own, and on a card each
cell's step is a CUDA graph a segment between the reductions of its data
row (one segment where the row is one cell), captured at the key's first
dispatch. `map_stream` keeps `depth` batches in flight: the device step of
every batch runs on the engine's CUDA streams and ends in a non-blocking
copy of the packed segments into pinned host memory, followed by a
recorded event a stream; drain threads wait on those events only, then
emit. In the unordered stream capacity-overflow reads gather in a retry
pool and go out again as pipelined tier-1 batches; `watermark_reads` is
the longest stream prefix whose records the consumer has had, retries
included. A grid that spans processes (parallel/multihost.py) joins each
data row's cells over torch.distributed; its drains then run on the
consumer thread, in stream order, because every process must issue the
same collectives in the same order.
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
from fem_tpu_torch.ops.step import accepted_hits, pack_input, pack_result, unpack_result
from fem_tpu_torch.ops.types import FilterParams, device_index_from_host
from fem_tpu_torch.parallel.mesh import make_mesh, make_sharded_map_fn, static_like, streams_of
from fem_tpu_torch.parallel.multihost import allgather_bitmaps, gather_rows
from fem_tpu_torch.parallel.sharded_index import build_sharded_index, make_index_sharded_map_fn
from fem_tpu_torch.stats import MappingStats
from fem_tpu_torch.utils.metrics import span

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
    each device that holds a cell of it. One device is a grid of one cell:
    one row, one upload, one segment, one result copy.

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

    The key's first dispatch runs eagerly on the engine's streams (the
    warm-up: the kernel library loads, the allocator fills, the kernels
    launch and are counted as they are) and is its result; the capture
    follows, on private streams, in thread-local mode, under the engine's
    capture lock, so that drain threads waiting on their events meanwhile
    do not break it. A capture that fails raises, and so does one whose
    kernels differ from the eager dispatch's (`kernels.recording_launches`):
    nothing falls back to the eager path. The capture launches nothing, so
    each replay adds the launches every cell's capture recorded. With
    `eager` (the engine's `eager_step`) and on the CPU the same segments
    run eagerly, on the same padded, packed input."""

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
        # One device is a data grid of one cell.
        self.grid = self.config.index_mesh or self.config.mesh or make_mesh([device])
        devices = self.grid.local_devices()
        for dev in devices:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {dev} requested but CUDA is not available")
        self.device = devices[0]
        self._cross = self.grid.crosses_processes
        # One compute stream per device: every device step and every result
        # copy is enqueued on it, from whichever thread submits.
        self._streams = {}
        for dev in devices:
            if dev.type == "cuda":
                self._streams[dev] = torch.cuda.Stream(dev)
                self._streams[dev].wait_stream(torch.cuda.current_stream(dev))
        self._cell_index: dict = {}  # (d, i) -> DeviceIndex of the grid's cell
        if self.config.index_mesh is not None:
            occurrences = self._init_sharded_index(index)
        else:
            occurrences = index.num_occurrences
            on = {}  # the whole index once per device
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
        # The step programs by (tier, Lmax). `eager_step` runs their
        # segments eagerly on the card, the counterpart of
        # jax.disable_jit(), for what a graph's replay never calls: wrappers
        # of the kernels' call sites.
        self.programs: Dict[tuple, GridProgram] = {}
        self.eager_step = False
        self._programs_lock = threading.Lock()
        self._capture_lock = threading.Lock()

    def report(self) -> dict:
        """What the engine did and holds, for a caller to serialize:
        retried, dispatched and host-mapped reads, each device's peak
        memory, each step program (its key, dispatches and replays, and each
        cell's segments, capture seconds, graph MiB and replays), and each
        grid cell's index (occurrences, reference bytes, bytes in all)."""
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
                      for key, ix in sorted(self._cell_index.items())],
        }

    def _init_sharded_index(self, index: FemIndex) -> int:
        """Each cell's shard on its device, once per (device, shard).
        Returns the largest shard's occurrences (every process sees every
        shard's)."""
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
        return tuple(self.grid.grid.shape)

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
        """The step program of (tier, Lmax), made at its first use."""
        key = (tier, Lmax)
        with self._programs_lock:
            prog = self.programs.get(key)
            if prog is None:
                tc = self._tier(tier)
                params = FilterParams.from_args(
                    self.args, Lmax, cap_occ=tc.cap_occ, cap_cand=tc.cap_cand)
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
        to the tier's batch size and packed (`_packed`), split into n_dp rows
        of batch_size / n_dp reads, as fem_tpu's sharded program takes it,
        and goes to the (tier, Lmax) GridProgram, which copies each cell's
        packed result into one host buffer (segments in `local_cells`
        order) and records an event a device after its copies. Drain
        threads call this too (retries); the program enters the engine's
        streams itself: the current stream is per thread."""
        tc = self._tier(tier)
        n = batch.num_reads
        if n > tc.batch_size:
            raise ValueError(
                f"batch of {n} reads exceeds batch_size {tc.batch_size} of tier {tier}")
        Lmax = batch.codes.shape[1]
        if (self.config.index_mesh is not None
                and Lmax + 2 * self.args.error_threshold > self._sharded_halo):
            # Owned candidates' verification bands must stay inside the
            # shard's [start - halo, end + halo) slice.
            raise ValueError(
                f"read length {Lmax} exceeds the sharded-index halo "
                f"({self._sharded_halo}); rebuild with a larger halo")
        n_dp, _ = self._mesh_shape()
        if tc.batch_size % n_dp:
            raise ValueError(f"batch size {tc.batch_size} not divisible by data mesh {n_dp}")
        Bloc = tc.batch_size // n_dp
        with span("fem::submit", tier=tier, reads=n) as sp:
            if tier > 0:
                with self._fallback_lock:
                    self.tier_dispatches += 1
                    self.dispatches_by_tier[tier] += 1
            packed = self._packed(batch, tc)
            prog = self._program(tier, Lmax)
            flat, ready = prog.run({d: packed[d * Bloc : (d + 1) * Bloc] for d, _ in prog.rows},
                                   self.eager_step)
            return self._register_pending(batch, flat, ready, tier, origins, sp)

    def _grid_step(self, params: FilterParams, tc: TierConfig):
        """The grid's step at these shapes, cut into its segments
        (parallel/mesh.py:GridStep)."""
        verify_cap, accept_cap = self._cell_caps(tc)
        if self.config.index_mesh is not None:
            return make_index_sharded_map_fn(
                self.grid, params, verify_cap, accept_cap, gather_rows=self._cross)
        return make_sharded_map_fn(self.grid, params, verify_cap, accept_cap)

    def _register_pending(self, batch, flat, ready, tier, origins, sp) -> Pending:
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
        return Pending(batch, flat, ready, tier, seq, origins, trace)

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
        batch, flat, ready, tier, seq, origins, trace = pending
        cause, bid = trace or (None, None)
        with span("fem::drain", cause=cause, batch=bid, tier=tier, reads=batch.num_reads):
            with span("fem::drain.wait"):
                for ev in ready:
                    ev.synchronize()
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
        batch, flat, ready, tier, seq, origins, trace = pending
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
