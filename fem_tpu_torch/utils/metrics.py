"""Observability: timers, per-batch metrics, structured stats (the port's
copy of fem_tpu/utils/metrics.py, without `shadow_reads`: shadow-warm is
not ported).

The reference's observability is wall/CPU timers printed at exit
(src/utils.h:138-149, src/FEM.c:42-48), per-batch mapping times
(src/map.c:24,57) and the five MappingStats counters
(src/FEM_map.c:214-218). Equivalents here: per-batch wall clocks,
reads/s, and a JSON stats dump whose counter names match the reference's
stderr lines one-to-one (they are the cross-implementation oracle), the
same keys as the JAX CLI's `--stats-json`. `torch.profiler` traces attach
via the CLI --profile flag.
"""

from __future__ import annotations

import dataclasses
import json
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
    wall_submit_s: float = 0.0
    wall_drain_s: float = 0.0
    wall_total_s: float = 0.0

    def batch(self, n_reads: int, n_records: int, submit_s: float, drain_s: float) -> None:
        self.num_batches += 1
        self.reads += n_reads
        self.records += n_records
        self.wall_submit_s += submit_s
        self.wall_drain_s += drain_s

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
