"""Several processes: independent workers, or one grid over torch.distributed
(fem_tpu/parallel/multihost.py).

The reference's scaling unit is a pthread worker consuming disjoint read
batches with a replicated read-only index and a stats-only merge at join
(src/FEM_map.c:145,182-212). Here the unit is a process, in one of two
modes:

* **independent** (the CLI's `map -t N`, or `--coordinator` without
  `--index-shards`): each process streams a disjoint, deterministic subset
  of the read file (`shard_batches`) over its own devices, writes its own
  SAM shard, and the five counters are summed at the end
  (`allreduce_stats` when the processes share a process group, the parent's
  merge for `-t` workers). No communication while mapping.
* **global mesh** (`--coordinator` with `--index-shards`): one
  ("data", "index") grid over every process's devices (`global_index_mesh`),
  the index split by coordinate across it. Every process consumes the same
  batch stream; each data row's index shards meet in the step's reductions
  and the row gathers (parallel/mesh.py, pipeline/engine.py), and the row's
  owner emits its reads.

The backend is chosen from the grid: NCCL when every rank owns cards of
its own, gloo on the CPU and where ranks share a card (NCCL refuses two
ranks on one GPU). A backend that fails to start raises; no other is tried.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from fem_tpu_torch.parallel.mesh import DATA_AXIS, INDEX_AXIS, DeviceMesh, collective


@dataclasses.dataclass
class HostContext:
    num_hosts: int
    host_id: int
    initialized: bool = False  # a torch.distributed process group is up
    backend: str | None = None


def local_entries(device: str, count: Optional[int], num_hosts: int = 1,
                  host_id: int = 0) -> list:
    """The grid entries this process uses: `count` of them (default: every
    card, or one entry on the CPU). `device` "cpu" or "cuda:k" names one
    device for all of them; "cuda" deals this process's entries out over
    the cards, host h taking h * count, h * count + 1, ... modulo their
    number, so they repeat a card only where there are too few."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * (count or 1)
    cards = torch.cuda.device_count()
    count = count or cards
    return [torch.device("cuda", (host_id * count + j) % cards) for j in range(count)]


def choose_backend(entries: list, num_hosts: int) -> tuple[str, str]:
    """(backend, why) for ranks that each use `entries` (this process's)."""
    if entries[0].type != "cuda":
        return "gloo", "grid entries on the CPU"
    cards = torch.cuda.device_count()
    if len(set(entries)) < len(entries) or num_hosts * len(entries) > cards:
        return "gloo", (f"ranks share a card ({num_hosts} ranks x {len(entries)} entries "
                        f"on {cards} card(s)); NCCL refuses two ranks on one GPU")
    return "nccl", f"every rank owns its own card(s) of {cards}"


def initialize(coordinator: Optional[str], num_hosts: int, host_id: int,
               local_devices: Optional[list] = None) -> HostContext:
    """The context of this process. `num_hosts <= 1` is the single process,
    so single-process runs take the exact same code path. Without a
    `coordinator`, one of `num_hosts` independent workers (`map -t N`): no
    process group, the parent merges SAM shards and counters. With one
    (host:port), `init_process_group` over tcp://coordinator, on the backend
    `choose_backend` picks for `local_devices`; a `[dist]` line says which."""
    if num_hosts <= 1:
        return HostContext(1, 0)
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host id {host_id} is not in [0, {num_hosts})")
    if coordinator is None:
        return HostContext(num_hosts, host_id)
    backend, why = choose_backend(local_devices or [torch.device("cpu")], num_hosts)
    print(f"[dist] rank {host_id} of {num_hosts}: backend {backend} ({why}), "
          f"tcp://{coordinator}", file=sys.stderr)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_hosts, rank=host_id)
    if backend == "nccl":
        torch.cuda.set_device(local_devices[0])
    return HostContext(num_hosts, host_id, True, backend)


def finalize(ctx: HostContext) -> None:
    if ctx.initialized and dist.is_initialized():
        dist.destroy_process_group()


def shard_batches(batches: Iterable, ctx: HostContext) -> Iterator:
    """Deterministic interleaved batch assignment: host h maps batches
    h, h+N, h+2N, ... — disjoint, order-stable, and resumable with the
    same arithmetic the checkpoint file uses."""
    for i, b in enumerate(batches):
        if i % ctx.num_hosts == ctx.host_id:
            yield b


def shard_path(path: str, ctx: HostContext) -> str:
    """Per-host SAM shard name. Each shard carries the full header, so
    shards are independently valid SAM files; `samtools cat`-style
    concatenation (or any record-set consumer) merges them."""
    if ctx.num_hosts == 1 or path == "-":
        return path
    return f"{path}.host{ctx.host_id:04d}"


def allreduce_stats(stats, ctx: HostContext):
    """Sum the five MappingStats counters over all processes (the
    reference's per-thread stats rollup at join, src/FEM_map.c:200-212)."""
    from fem_tpu_torch.stats import MappingStats

    if not ctx.initialized:
        return stats
    t = torch.tensor([stats.num_reads, stats.num_mapped_reads,
                      stats.num_candidates_without_additional_qgram_filter,
                      stats.num_candidates, stats.num_mappings], dtype=torch.int64)
    collective(t, lambda x: dist.all_reduce(x, dist.ReduceOp.SUM), None)
    return MappingStats(*(int(x) for x in t))


def allreduce_min(value: int, ctx: HostContext) -> int:
    """Min of an integer over all processes (the common resume position of
    a global-mesh run, where every step is collective)."""
    if not ctx.initialized:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    collective(t, lambda x: dist.all_reduce(x, dist.ReduceOp.MIN), None)
    return int(t[0])


def barrier(ctx: HostContext) -> None:
    if ctx.initialized:
        dist.barrier()


def local_data_mesh(entries: list) -> DeviceMesh:
    """This process's entries as one data axis (independent mode)."""
    arr = np.empty(len(entries), dtype=object)
    arr[:] = list(entries)
    return DeviceMesh(arr, (DATA_AXIS,))


def global_index_mesh(n_index_shards: int, entries: list, ctx: HostContext) -> DeviceMesh:
    """The ("data", "index") grid over every process's entries (each
    process has as many). As in the JAX package (multihost.py:152-175) each
    data row interleaves the processes: entry l of process p is cell
    (l * n_proc + p) of the grid in row-major order, so the index axis,
    whose reductions and row gathers are the only collectives of a step,
    crosses processes. A row's processes share one process group, made here
    on every process in the same order."""
    n_proc = ctx.num_hosts if ctx.initialized else 1
    me = ctx.host_id if ctx.initialized else 0
    L = len(entries)
    total = n_proc * L
    if total % n_index_shards:
        raise ValueError(f"{total} devices not divisible by {n_index_shards} index shards")
    n_dp = total // n_index_shards
    owners = np.repeat(np.arange(n_proc), L).reshape(n_proc, L).T.reshape(n_dp, n_index_shards)
    slot = np.tile(np.arange(L), n_proc).reshape(n_proc, L).T.reshape(n_dp, n_index_shards)
    devices = np.empty(owners.shape, dtype=object)
    for d, i in np.ndindex(owners.shape):
        devices[d, i] = entries[slot[d, i]] if owners[d, i] == me else None
    row_groups = None
    if n_proc > 1:
        row_groups = []
        for d in range(n_dp):
            ranks = tuple(sorted(set(owners[d].tolist())))
            for rg in row_groups:
                if rg[0] == ranks:
                    rg[2].append(d)
                    break
            else:
                group = None if len(ranks) in (1, n_proc) else dist.new_group(list(ranks))
                row_groups.append((ranks, group, [d]))
    return DeviceMesh(devices, (DATA_AXIS, INDEX_AXIS), owners=owners, rank=me,
                      row_groups=row_groups)


def gather_rows(mesh: DeviceMesh, segs: torch.Tensor) -> dict:
    """All-gather, over the processes of each data row, the packed
    segments of the row's cells; `segs` holds this process's cells'
    segments in `mesh.local_cells()` order, in host memory. Returns
    {row: (n_ip, segment) array} for every row this process has a cell in."""
    cells = mesh.local_cells()
    n_ip = mesh.grid.shape[1]
    out = {}
    for ranks, group, rows in mesh.row_groups:
        if mesh.rank not in ranks:
            continue
        mine = torch.zeros((len(rows), n_ip, segs.shape[1]), dtype=torch.int64)
        for (d, i, _), seg in zip(cells, segs):
            if d in rows:
                mine[rows.index(d), i] = seg
        parts = [torch.empty_like(mine) for _ in ranks]
        if len(ranks) > 1:
            collective(mine, lambda t: _all_gather(parts, t, group), group)
        else:
            parts = [mine]
        for r, d in enumerate(rows):
            out[d] = np.stack([parts[ranks.index(mesh.owner(d, i))][r, i].numpy()
                               for i in range(n_ip)])
    return out


def _all_gather(parts: list, t: torch.Tensor, group) -> None:
    # `collective` hands over `t` on the backend's device; the outputs
    # follow it there and back.
    if t.device != parts[0].device:
        on = [torch.empty_like(t) for _ in parts]
        dist.all_gather(on, t, group=group)
        for p, o in zip(parts, on):
            p.copy_(o)
    else:
        dist.all_gather(parts, t, group=group)


def allgather_bitmaps(fb_own: np.ndarray, inh_own: np.ndarray):
    """OR the processes' owned-row fallback and inherent bitmaps into the
    global per-read bitmaps (every process then sees every row's flags)."""
    both = torch.from_numpy(np.stack([fb_own, inh_own]).astype(np.uint8))
    parts = [torch.empty_like(both) for _ in range(dist.get_world_size())]
    collective(both, lambda t: _all_gather(parts, t, None), None)
    g = torch.stack(parts).amax(dim=0).numpy().astype(bool)
    return g[0], g[1]
