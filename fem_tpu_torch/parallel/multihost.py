"""Independent worker processes: the part of fem_tpu/parallel/multihost.py
that needs no collective.

The reference's scaling unit is a pthread worker consuming disjoint read
batches with a replicated read-only index and a stats-only merge at join
(src/FEM_map.c:145,182-212). Here that unit is a process (the CLI's
`map -t N`): each streams a disjoint, deterministic subset of the read
file, writes its own SAM shard and stats file, and the parent merges
both. There is no communication between the processes.

The collectives (`allreduce_*`, `barrier`) and the meshes of the JAX
package need `torch.distributed` and come with the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator


@dataclasses.dataclass
class HostContext:
    num_hosts: int
    host_id: int


def initialize(num_hosts: int, host_id: int) -> HostContext:
    """The context of one of `num_hosts` independent processes; a
    `num_hosts <= 1` context is the single process, so single-process runs
    take the exact same code path."""
    if num_hosts <= 1:
        return HostContext(1, 0)
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host id {host_id} is not in [0, {num_hosts})")
    return HostContext(num_hosts, host_id)


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
