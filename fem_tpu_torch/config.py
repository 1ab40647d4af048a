"""Mapper configuration.

Mirrors the reference argument surface and validation rules
(reference: src/FEM_map.c:29-55 check_args, src/FEM_map.c:67-72 defaults,
src/utils.h:63-70 FEMArgs) without copying its structure: this is a plain
dataclass used by both the golden model and the device pipeline.

The port's copy of fem_tpu/config.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FemArgs:
    """Mapping parameters.

    Attributes:
      kmer_size: seed length k (fixed by the index; reference default 12).
      step_size: window step (fixed by the index; reference default 3).
      error_threshold: max edit distance e, 0 <= e <= 7 (src/FEM_map.c:30).
      num_additional_qgrams: a, 0 <= a <= 2 (src/FEM_map.c:38).
      num_threads: host worker threads for the CPU pipeline stages.
    """

    kmer_size: int = 12
    step_size: int = 3
    error_threshold: int = 2
    num_additional_qgrams: int = 1
    num_threads: int = 1

    def __post_init__(self) -> None:
        if not (0 <= self.error_threshold <= 7):
            raise ValueError("error threshold must be in [0, 7]")
        if not (0 <= self.num_additional_qgrams <= 2):
            raise ValueError("number of additional q-grams must be in [0, 2]")
        if self.num_threads <= 0:
            raise ValueError("number of threads must be positive")
        if self.kmer_size <= 0 or self.kmer_size > 15:
            raise ValueError("kmer size must be in [1, 15]")
        if self.step_size <= 0:
            raise ValueError("step size must be positive")

    @property
    def num_qgrams(self) -> int:
        """Seeds selected per group: e + 1 + a (src/filter.c:194,204)."""
        return self.error_threshold + 1 + self.num_additional_qgrams

    @property
    def seed_span_in_group(self) -> int:
        """Seed footprint in group coordinates: ceil(k/step) (src/filter.c:162-165)."""
        return -(-self.kmer_size // self.step_size)

    @property
    def band_width(self) -> int:
        """Banded DP width in bits: 2e + 1."""
        return 2 * self.error_threshold + 1

    def max_step_size(self, read_length: int) -> int:
        """Sensitivity guarantee: step <= L/(e+2) - k + 1 (reference README.md:30)."""
        return read_length // (self.error_threshold + 2) - self.kmer_size + 1
