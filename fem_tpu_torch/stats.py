"""The mapping counters (fem_tpu/golden/model.py: MappingStats), shared by
the engine, the port's golden oracle (golden/model.py) and the CLI."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MappingStats:
    """The five self-reported counters (src/utils.h:55-61, printed at
    src/FEM_map.c:214-218). These are the cross-implementation oracle."""

    num_reads: int = 0
    num_mapped_reads: int = 0
    num_candidates_without_additional_qgram_filter: int = 0
    num_candidates: int = 0
    num_mappings: int = 0

    def __iadd__(self, other: "MappingStats") -> "MappingStats":
        self.num_reads += other.num_reads
        self.num_mapped_reads += other.num_mapped_reads
        self.num_candidates_without_additional_qgram_filter += (
            other.num_candidates_without_additional_qgram_filter
        )
        self.num_candidates += other.num_candidates
        self.num_mappings += other.num_mappings
        return self
