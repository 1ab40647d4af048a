"""Observability: timers, per-batch metrics, structured stats (the port's
copy of fem_tpu/utils/metrics.py, without `shadow_reads`: shadow-warm is
not ported).

The reference's observability is wall/CPU timers printed at exit
(src/utils.h:138-149, src/FEM.c:42-48), per-batch mapping times
(src/map.c:24,57) and the five MappingStats counters
(src/FEM_map.c:214-218). Equivalents here: per-batch wall clocks,
reads/s, and a JSON stats dump whose counter names match the reference's
stderr lines one-to-one (they are the cross-implementation oracle), the
same keys as the JAX CLI's `--stats-json` but its two per-stage wall
clocks. `torch.profiler` traces attach via the CLI --profile flag.

Spans: `span(name, ...)` marks a host stage of the program (the reader's
parse, a batch's submit and drain, the retry ladder, garbage collection)
on the clock of torch.profiler's host events, from whichever thread runs
it. Tracing is off unless `tracing(True)` turns it on; then each span
appends a record, which `take_spans()` returns.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import threading
import time
from typing import Dict


class Timer:
    def __init__(self) -> None:
        self._t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self._t0

    def reset(self) -> float:
        now = time.time()
        dt = now - self._t0
        self._t0 = now
        return dt


@dataclasses.dataclass
class PipelineMetrics:
    num_batches: int = 0
    reads: int = 0
    records: int = 0
    fallback_reads: int = 0  # exact-host-mapper reads (past the last tier)
    retried_reads: int = 0  # reads remapped at retry tiers >= 1
    wall_total_s: float = 0.0

    def batch(self, n_reads: int, n_records: int) -> None:
        self.num_batches += 1
        self.reads += n_reads
        self.records += n_records

    @property
    def reads_per_s(self) -> float:
        return self.reads / self.wall_total_s if self.wall_total_s else 0.0

    def to_dict(self, stats=None) -> Dict:
        out = dataclasses.asdict(self)
        out["reads_per_s"] = round(self.reads_per_s, 1)
        if stats is not None:
            out["mapping_stats"] = {
                "num_reads": stats.num_reads,
                "num_mapped_reads": stats.num_mapped_reads,
                "num_candidates_without_additional_qgram_filter": (
                    stats.num_candidates_without_additional_qgram_filter
                ),
                "num_candidates": stats.num_candidates,
                "num_mappings": stats.num_mappings,
            }
        return out

    def dump_json(self, path: str, stats=None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(stats), f, indent=2)
            f.write("\n")


# ------------------------------------------------------------------- spans

# A span record's fields, in the order `take_spans` gives them: its name,
# the OS thread id it ran on, start and end in Unix-epoch ns (the clock of
# torch.profiler's host events), its own id, the id of the span enclosing
# it on the same thread (`parent`) and of the span that caused it on
# another (`cause`: a drain's is its batch's submit), the batch id (a
# tier-0 batch's stream position, a retry batch's the negated id of its
# submit), the retry tier, and the reads it handled.
SPAN_FIELDS = ("name", "thread", "start_ns", "end_ns", "id", "parent", "cause", "batch",
               "tier", "reads")
SPAN_CAP = 1_000_000  # records a recording keeps; spans opened past it are counted


class _NoSpan:
    """What `span` returns while tracing is off: one shared object that
    records nothing."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return None

    def tag(self, batch=None, tier=None, reads=None) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Thread:
    """One thread's part of a recording: its records, the ids of its open
    spans (innermost last), what the cap dropped, a collection's start."""

    __slots__ = ("thread", "records", "stack", "dropped", "gc_start")

    def __init__(self):
        self.thread = threading.get_native_id()
        self.records: list = []
        self.stack: list = []
        self.dropped = 0
        self.gc_start = None

    def add(self, rec: tuple, cap: int) -> None:
        if rec[4] < cap:
            self.records.append(rec)
        else:
            self.dropped += 1


class _Recording:
    """The records of one `tracing(True)` .. `tracing(False)`. Each thread
    appends to its own part, so recording takes no lock; ids come from one
    counter."""

    def __init__(self, cap: int):
        self.cap = cap
        self.ids = itertools.count()
        self.local = threading.local()
        self.threads: list = []
        self.start_ns = time.time_ns()
        self.end_ns = None

    def part(self) -> _Thread:
        t = getattr(self.local, "part", None)
        if t is None:
            t = self.local.part = _Thread()
            self.threads.append(t)
        return t


class _Span:
    __slots__ = ("_rec", "_part", "_t0", "_parent", "name", "id", "cause", "batch", "tier",
                 "reads")

    def __init__(self, rec, name, batch, tier, reads, cause):
        self._rec, self.name = rec, name
        self.batch, self.tier, self.reads, self.cause = batch, tier, reads, cause

    def __enter__(self):
        part = self._part = self._rec.part()
        self.id = next(self._rec.ids)
        self._parent = part.stack[-1] if part.stack else None
        part.stack.append(self.id)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, typ, value, tb):
        t1 = time.time_ns()
        part = self._part
        part.stack.pop()
        part.add((self.name, part.thread, self._t0, t1, self.id, self._parent, self.cause,
                  self.batch, self.tier, self.reads), self._rec.cap)
        return None

    def tag(self, batch=None, tier=None, reads=None) -> None:
        """Set tags known only once the span is open."""
        if batch is not None:
            self.batch = batch
        if tier is not None:
            self.tier = tier
        if reads is not None:
            self.reads = reads


_active: _Recording | None = None  # where spans go; None while tracing is off
_latest: _Recording | None = None  # what take_spans returns


def span(name: str, *, batch=None, tier=None, reads=None, cause=None):
    """A context manager timing a host stage: `with span("fem::emit",
    reads=n):`. Its tags are keywords (`batch`, `tier`, `reads`, `cause`,
    a span id); `tag()` sets them later, and the span's `id` is known once
    it is open. While tracing is off it returns one shared object and
    allocates nothing."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, batch, tier, reads, cause)


def _gc_hook(phase: str, info: dict) -> None:
    """A `gc.callbacks` hook: each collection as a `fem::gc` span on the
    thread that ran it."""
    rec = _active
    if rec is None:
        return
    part = rec.part()
    if phase == "start":
        part.gc_start = time.time_ns()
    elif part.gc_start is not None:
        part.add(("fem::gc", part.thread, part.gc_start, time.time_ns(), next(rec.ids),
                  part.stack[-1] if part.stack else None, None, None, None, None), rec.cap)
        part.gc_start = None


def tracing(on: bool) -> None:
    """Start a new recording of spans (and of garbage collections), or end
    the one running; `take_spans()` returns the latest. Nothing else
    turns tracing on."""
    global _active, _latest
    if on and _active is None:
        _active = _latest = _Recording(SPAN_CAP)
        gc.callbacks.append(_gc_hook)
    elif not on and _active is not None:
        _active.end_ns = time.time_ns()
        _active = None
        gc.callbacks.remove(_gc_hook)


def take_spans() -> dict:
    """The latest recording: its start and end (ns; end None while it
    runs), the spans the cap dropped, and the records kept, each a dict of
    SPAN_FIELDS, by start. A record without a batch or tier of its own
    takes its parent's."""
    rec = _latest
    if rec is None:
        return {"start_ns": None, "end_ns": None, "dropped": 0, "records": []}
    rows = sorted((r for t in list(rec.threads) for r in list(t.records)), key=lambda r: r[4])
    by_id: dict = {}
    for r in rows:  # ids grow with opening, so a parent comes before its children
        d = dict(zip(SPAN_FIELDS, r))
        up = by_id.get(d["parent"])
        if up is not None:
            if d["batch"] is None:
                d["batch"] = up["batch"]
            if d["tier"] is None:
                d["tier"] = up["tier"]
        by_id[d["id"]] = d
    return {"start_ns": rec.start_ns, "end_ns": rec.end_ns,
            "dropped": sum(t.dropped for t in rec.threads),
            "records": sorted(by_id.values(), key=lambda d: d["start_ns"])}
