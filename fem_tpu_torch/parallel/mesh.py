"""Device grids: the mapping step over several devices (fem_tpu/parallel/mesh.py).

The reference scales with N pthread workers over disjoint 10k-read batches
sharing a read-only index, merging only per-thread counters at join
(src/FEM_map.c:145,182-212). The JAX package maps that onto a device mesh;
here a `DeviceMesh` is a numpy grid of `torch.device`s with axis names:
`(n_dp,)` over ("data",), where reads split over the data axis and every
device holds the whole index, or `(n_dp, n_ip)` over ("data", "index"),
where the index is also split by reference coordinate
(parallel/sharded_index.py). A grid may name one card more than once,
and one device alone is a data grid of one cell.

A `GridStep` runs `map_core_steps` for every cell of the grid this
process holds, in lockstep, cut into segments at the points where the
cells of a data row meet: none on a data grid (a cell's step is one
segment), the truncation bound's max and the per-read sums and maxes on an
index grid (three segments). Each cell's work is enqueued on its device's
stream (so cells on different cards overlap, cells on one card run in
turn), and between segments the cells' values meet in a `GridReducer`,
which also joins the other processes' cells of a data row over
`torch.distributed` when the grid spans processes (parallel/multihost.py
builds such grids). The engine runs the segments eagerly, or captures each
into a CUDA graph and replays them (pipeline/engine.py:GridProgram).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fem_tpu_torch.ops.step import map_core_steps, unpack_input

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
    the cells of each data row (its index shards); a tuple of ops reduces a
    tuple of values, one each. A value is a tensor or a tuple of tensors,
    reduced as one int64 vector; each cell gets the reduced value on its
    own device, or written into `out` (a cell's static tensors of the same
    structure: pipeline/engine.py:GridProgram)."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.cells = mesh.local_cells()
        self.n_dp, self.n_ip = mesh.grid.shape
        self.needed = self.n_ip > 1  # a row of one cell needs no reduction

    def __call__(self, op, values: list, out: list | None = None) -> list:
        if isinstance(op, tuple):
            parts = [self(o, [v[j] for v in values],
                          None if out is None else [x[j] for x in out])
                     for j, o in enumerate(op)]
            return [tuple(p[c] for p in parts) for c in range(len(values))]
        reduced = self._rows(op, values)
        if out is None:
            return reduced
        for dst, src in zip(out, reduced):
            _copy_into(dst, src)
        return out

    def _rows(self, op: str, values: list) -> list:
        parts = [_flatten(v) for v in values]
        common = self.cells[0][2]
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


def _copy_into(dst, src) -> None:
    if isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_into(a, b)
    else:
        dst.copy_(src)


def static_like(value):
    """Tensors of `value`'s structure, shapes, types and devices, for a
    graph to read and a reduction to write (uninitialized: no kernel)."""
    if isinstance(value, tuple):
        return tuple(static_like(v) for v in value)
    return torch.empty_like(value)


def streams_of(streams: dict, *devs) -> contextlib.ExitStack:
    """The engine's stream current on each of `devs` (each device has a
    current stream of its own): work and copies between them go on those
    streams, and a copy between two devices waits for both."""
    stack = contextlib.ExitStack()
    for dev in dict.fromkeys(devs):
        if streams.get(dev) is not None:
            stack.enter_context(torch.cuda.stream(streams[dev]))
    return stack


class GridStep:
    """The mapping step over this process's cells of `mesh` at one shape.
    Cell (d, i) maps its data row's packed reads (`pack_input`'s rows d *
    Bloc to (d + 1) * Bloc of the padded batch) against its shard; the
    cells go in lockstep, cut into segments at the points where a row's
    cells meet (`advance`), reduced between them by a GridReducer. With
    `globalize_lanes` and more than one data row, a cell's accepted lanes
    are renumbered over the whole batch (fem_tpu/parallel/mesh.py:61-66):
    strand * (n_dp * Bloc) + d * Bloc + (l - strand * Bloc); otherwise they
    stay row-local, in [0, 2 * Bloc), which on one row is the same."""

    def __init__(self, mesh: DeviceMesh, params, verify_cap: int, accept_cap: int,
                 globalize_lanes: bool):
        self.mesh, self.params = mesh, params
        self.verify_cap, self.accept_cap = verify_cap, accept_cap  # per cell
        self.globalize_lanes = globalize_lanes
        self.cells = mesh.local_cells()
        self.reduce = GridReducer(mesh)

    def cell_steps(self, d: int, index, packed: torch.Tensor):
        """Cell (d, .)'s step on its row's packed reads, as a generator of
        map_core_steps' points; returns map_core's dict with the lanes
        globalized. Every op on the device runs inside a `send`."""
        codes, lengths = unpack_input(packed)
        out = yield from map_core_steps(index, codes, lengths, self.params,
                                        self.verify_cap, self.accept_cap)
        n_dp = self.mesh.grid.shape[0]
        if self.globalize_lanes and n_dp > 1:
            Bloc = codes.shape[0]
            lane = out["a_lane"]
            strand = (lane >= Bloc).to(lane.dtype)
            out["a_lane"] = strand * (n_dp * Bloc) + d * Bloc + (lane - strand * Bloc)
        return out

    def advance(self, gen, value) -> tuple:
        """Run one segment of a cell's step: from `value` (the reduced
        value of the last point, None at the start) to the next point whose
        reduction the grid needs, (op, value) there; or (None, map_core's
        dict) at the end. A point the grid need not reduce (a row of one
        cell) gets its own value back at once."""
        try:
            while True:
                op, value = gen.send(value)
                if self.reduce.needed:
                    return op, value
        except StopIteration as stop:
            return None, stop.value

    def lockstep(self, asks: list):
        """The op all cells stopped at (None: all at the end), or raise."""
        ops = {op for op, _ in asks}
        if len(ops) != 1:
            raise RuntimeError(f"grid cells left lockstep: {ops}")
        return ops.pop()

    def run(self, indexes: dict, rows: dict, streams: dict) -> list:
        """The step eagerly: `indexes` maps (d, i) to cell (d, i)'s shard,
        `rows` (d, device) to row d's packed reads on that device. Returns
        each cell's map_core dict, in `mesh.local_cells()` order, on its
        device's stream."""
        gens = [self.cell_steps(d, indexes[d, i], rows[d, dev]) for d, i, dev in self.cells]
        devs = [dev for _, _, dev in self.cells]
        sends = [None] * len(gens)
        while True:
            asks = []
            for g, s, dev in zip(gens, sends, devs):
                with streams_of(streams, dev):
                    asks.append(self.advance(g, s))
            op = self.lockstep(asks)
            if op is None:
                return [v for _, v in asks]
            with streams_of(streams, *devs):
                sends = self.reduce(op, [v for _, v in asks])


def make_sharded_map_fn(mesh: DeviceMesh, params, verify_cap_per_shard: int,
                        accept_cap: int) -> GridStep:
    """The data-parallel step (fem_tpu/parallel/mesh.py:make_sharded_map_fn):
    reads split over the data axis, the whole index on every device, lanes
    globalized; no reduction, so a cell's step is one segment. A data grid
    stays in one process (fem_tpu/pipeline/engine.py:294-300)."""
    if mesh.crosses_processes:
        raise ValueError(
            "cross-host pure data parallelism uses the independent multi-host mode "
            "(one engine per host); a cross-host mesh is only for the coordinate-sharded index")
    return GridStep(mesh, params, verify_cap_per_shard, accept_cap, globalize_lanes=True)
