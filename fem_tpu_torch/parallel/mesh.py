"""Device grids: the mapping step over several devices (fem_tpu/parallel/mesh.py).

The reference scales with N pthread workers over disjoint 10k-read batches
sharing a read-only index, merging only per-thread counters at join
(src/FEM_map.c:145,182-212). The JAX package maps that onto a device mesh;
here a `DeviceMesh` is a numpy grid of `torch.device`s with axis names:
`(n_dp,)` over ("data",), where reads split over the data axis and every
device holds the whole index, or `(n_dp, n_ip)` over ("data", "index"),
where the index is also split by reference coordinate
(parallel/sharded_index.py). A grid may name one card more than once.

`map_grid` runs `map_core_steps` for every cell of the grid this process
holds, in lockstep: each cell's work is enqueued on its device's stream (so
cells on different cards overlap, cells on one card run in turn), and at
each reduction across index shards the cells' values meet in a
`GridReducer`, the reduce hook of the step, which also joins the other
processes' cells of a data row over `torch.distributed` when the grid spans
processes (parallel/multihost.py builds such grids).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fem_tpu_torch.pipeline.engine import map_core_steps, pack_result

DATA_AXIS = "data"
INDEX_AXIS = "index"


@dataclasses.dataclass
class DeviceMesh:
    """A grid of devices. `devices[d, i]` is the device of cell (d, i) when
    this process holds it, None when another process does; `owners` gives
    each cell's process rank (None: every cell is this process's). A grid
    over several processes carries, per data row, the ranks in the row and
    the process group that joins them (`row_groups`)."""

    devices: np.ndarray  # object array of torch.device | None
    axis_names: tuple
    owners: np.ndarray | None = None  # int ranks, devices' shape
    rank: int = 0
    row_groups: list | None = None  # [(ranks, group or None, rows)], one per rank set

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d grid with axes {self.axis_names}")
        for dev in self.devices.flat:
            if dev is not None and dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"grid names {dev} but CUDA is not available")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def grid(self) -> np.ndarray:
        """The devices as (n_dp, n_ip)."""
        return self.devices.reshape(self.devices.shape[0], -1)

    @property
    def crosses_processes(self) -> bool:
        return self.owners is not None and bool((self.owners != self.rank).any())

    def owner(self, d: int, i: int) -> int:
        return self.rank if self.owners is None else int(self.owners.reshape(self.grid.shape)[d, i])

    def local_cells(self) -> list:
        """[(d, i, device)] of the cells this process holds, row-major."""
        g = self.grid
        return [(d, i, g[d, i]) for d in range(g.shape[0]) for i in range(g.shape[1])
                if self.owner(d, i) == self.rank]

    def row_owner(self, d: int) -> int:
        """The process that emits data row d: round-robin over the row's
        processes (fem_tpu/pipeline/engine.py:_drain_cross_host)."""
        procs = sorted({self.owner(d, i) for i in range(self.grid.shape[1])})
        return procs[d % len(procs)]

    def local_devices(self) -> list:
        """This process's distinct devices, in grid order."""
        out = []
        for _, _, dev in self.local_cells():
            if dev not in out:
                out.append(dev)
        return out


def make_mesh(devices: Sequence[torch.device | str], axis: str = DATA_AXIS) -> DeviceMesh:
    """A one-axis grid over `devices`."""
    return DeviceMesh(_device_array(devices), (axis,))


def make_index_mesh(devices: Sequence[torch.device | str], n_index: int) -> DeviceMesh:
    """A (data, index) grid: `devices` row-major, `n_index` to a row."""
    if len(devices) % n_index:
        raise ValueError(f"{len(devices)} devices not divisible by {n_index} index shards")
    return DeviceMesh(_device_array(devices).reshape(-1, n_index), (DATA_AXIS, INDEX_AXIS))


def _device_array(devices) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr


def collective(tensor: torch.Tensor, fn: Callable, group) -> torch.Tensor:
    """Run the collective fn(t) on `tensor`, in place, on the group's
    backend: gloo takes the data in host memory (it has no all_gather on
    CUDA tensors; its all_reduce is staged the same way, so every gloo
    collective here has one path), NCCL on the card."""
    backend = dist.get_backend(group)
    want = torch.device("cpu") if backend == "gloo" else torch.device("cuda", torch.cuda.current_device())
    if tensor.device == want:
        fn(tensor)
        return tensor
    staged = tensor.to(want)
    fn(staged)
    tensor.copy_(staged)
    return tensor


_ROW_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


class GridReducer:
    """The reduce hook of `map_core_steps` on a grid: "max" and "sum" over
    the cells of each data row (its index shards), "sum_all" over every
    cell of the grid. A value is a tensor or a tuple of tensors, reduced as
    one int64 vector; each cell gets the reduced value on its own device."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.cells = mesh.local_cells()
        self.n_dp, self.n_ip = mesh.grid.shape

    def __call__(self, op: str, values: list) -> list:
        alone = op == "sum_all" and self.n_dp * self.n_ip == 1
        if (op != "sum_all" and self.n_ip == 1) or alone:
            return values  # a row of one cell, or a grid of one
        parts = [_flatten(v) for v in values]
        common = self.cells[0][2]
        if op == "sum_all":
            total = sum(p.to(common).sum() for p in parts).reshape(1)
            if self.mesh.crosses_processes:
                collective(total, lambda t: dist.all_reduce(t, dist.ReduceOp.SUM), None)
            return [_unflatten(total.to(p.device).expand_as(p), v) for p, v in zip(parts, values)]
        fill = torch.iinfo(torch.int64).min if op == "max" else 0
        rows = torch.full((self.n_dp, parts[0].numel()), fill, dtype=torch.int64, device=common)
        for (d, _, _), p in zip(self.cells, parts):
            p = p.to(common)
            rows[d] = torch.maximum(rows[d], p) if op == "max" else rows[d] + p
        if self.mesh.crosses_processes:
            for ranks, group, row_ids in self.mesh.row_groups:
                if self.mesh.rank in ranks and len(ranks) > 1:
                    sub = rows[row_ids]
                    collective(sub, lambda t: dist.all_reduce(t, _ROW_OPS[op], group), group)
                    rows[row_ids] = sub
        return [_unflatten(rows[d].to(p.device), v) for (d, _, _), p, v in zip(self.cells, parts, values)]


def _flatten(value) -> torch.Tensor:
    ts = value if isinstance(value, tuple) else (value,)
    return torch.cat([t.reshape(-1).long() for t in ts])


def _unflatten(flat: torch.Tensor, like):
    ts = like if isinstance(like, tuple) else (like,)
    out, o = [], 0
    for t in ts:
        out.append(flat[o : o + t.numel()].reshape(t.shape).to(t.dtype))
        o += t.numel()
    return tuple(out) if isinstance(like, tuple) else out[0]


def _streams_of(streams: dict, *devs) -> contextlib.ExitStack:
    """The engine's stream current on each of `devs` (each device has a
    current stream of its own): work and copies between them go on those
    streams, and a copy between two devices waits for both."""
    stack = contextlib.ExitStack()
    for dev in dict.fromkeys(devs):
        if streams.get(dev) is not None:
            stack.enter_context(torch.cuda.stream(streams[dev]))
    return stack


def map_grid(
    mesh: DeviceMesh,
    indexes: dict,  # (d, i) -> DeviceIndex of cell (d, i)'s shard, on its device
    codes: np.ndarray,  # (n_dp * Bloc, Lmax) uint8, reads of row d at [d*Bloc, (d+1)*Bloc)
    lengths: np.ndarray,  # (n_dp * Bloc,) int32
    *,
    params,
    verify_cap: int,  # per cell
    accept_cap: int,  # per cell
    globalize_lanes: bool,
    upload: Callable,  # upload(array, device) -> tensor on device
    streams: dict,  # device -> torch.cuda.Stream (absent on the CPU)
) -> list:
    """One mapping step over this process's cells: their packed results
    (`pack_result`), in `mesh.local_cells()` order, each on its device's
    stream. Every cell runs `map_core_steps` on its row's reads and its
    shard; the steps go in lockstep, meeting at each reduction in a
    GridReducer. With `globalize_lanes`, a cell's accepted lanes are
    renumbered over the whole batch (fem_tpu/parallel/mesh.py:61-66):
    strand * (n_dp * Bloc) + d * Bloc + (l - strand * Bloc); otherwise they
    stay row-local, in [0, 2 * Bloc)."""
    cells = mesh.local_cells()
    n_dp = mesh.grid.shape[0]
    Bloc = codes.shape[0] // n_dp
    rows = {}  # (d, device) -> (codes, lengths) on the device
    gens = []
    for d, i, dev in cells:
        with _streams_of(streams, dev):
            if (d, dev) not in rows:
                sl = slice(d * Bloc, (d + 1) * Bloc)
                rows[d, dev] = (upload(codes[sl], dev), upload(lengths[sl], dev))
            gens.append(map_core_steps(indexes[d, i], *rows[d, dev], params, verify_cap,
                                       accept_cap))
    reduce = GridReducer(mesh)
    sends = [None] * len(gens)
    outs = [None] * len(gens)
    while True:
        asks = []
        for k, (g, (_, _, dev)) in enumerate(zip(gens, cells)):
            with _streams_of(streams, dev):
                try:
                    asks.append(g.send(sends[k]))
                except StopIteration as stop:
                    outs[k] = stop.value
        if not asks:
            break
        if len(asks) != len(gens) or len({op for op, _ in asks}) != 1:
            raise RuntimeError("grid cells left lockstep")
        with _streams_of(streams, *(dev for _, _, dev in cells)):
            sends = reduce(asks[0][0], [v for _, v in asks])
    segs = []
    for (d, _, dev), out in zip(cells, outs):
        with _streams_of(streams, dev):
            if globalize_lanes:
                lane = out["a_lane"]
                strand = (lane >= Bloc).to(lane.dtype)
                out["a_lane"] = strand * (n_dp * Bloc) + d * Bloc + (lane - strand * Bloc)
            segs.append(pack_result(out))
    return segs


def make_sharded_map_fn(mesh: DeviceMesh, params, verify_cap_per_shard: int,
                        accept_cap: int):
    """The data-parallel step (fem_tpu/parallel/mesh.py:make_sharded_map_fn):
    reads split over the data axis, the whole index on every device, lanes
    globalized, `total_candidates` summed over the grid. Returns
    fn(indexes, codes, lengths, upload=..., streams=...) -> map_grid's list.
    A data grid stays in one process (fem_tpu/pipeline/engine.py:294-300)."""
    if mesh.crosses_processes:
        raise ValueError(
            "cross-host pure data parallelism uses the independent multi-host mode "
            "(one engine per host); a cross-host mesh is only for the coordinate-sharded index")

    def fn(indexes, codes, lengths, *, upload, streams):
        return map_grid(mesh, indexes, codes, lengths, params=params,
                        verify_cap=verify_cap_per_shard, accept_cap=accept_cap,
                        globalize_lanes=True, upload=upload, streams=streams)

    return fn
