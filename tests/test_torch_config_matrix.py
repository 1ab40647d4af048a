"""The port's parameter sweep (tests/test_config_matrix.py): the engine on
the CPU against fem_tpu's golden oracle and fem_tpu's engine, over e, a, k,
step and read length.

Each configuration maps the JAX sweep's world (a 150 kb two-chromosome
genome, 20% repeats, seeds 23 and 24) with the sweep's EngineConfig. The
port runs its padded, packed step program; every batch is padded to
batch_size with empty reads, as fem_tpu pads its jitted program's input.
Checks, all exact: SAM bytes and the five counters equal to the golden
oracle; retried reads, tier dispatches and host-mapped reads equal to
fem_tpu's engine with the same config. A second case maps 40 of the 48
reads, so 8 rows of the program are padding.

The sweep's six configurations, and a seventh inside FEM's step bound at
e=7, step <= L/(e+2) - k + 1 (docs/SOAK.md): 150 bp reads with up to 7
errors, Lmax 160, the widest band. Under the bound no read maps at e=7 and
100 bp, nor at e=4 and 76 bp with step 2. The configurations are split over
this file and test_torch_config_matrix_long.py, so that each file stays
short on one test worker.
"""

import dataclasses
import functools

import pytest
import torch

from fem_tpu import sim
from fem_tpu.config import FemArgs
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.index.build import build_index
from fem_tpu.io import fastx
from fem_tpu.pipeline import engine as jengine
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
from test_torch_cases import SWEEP_CAPS, SWEEP_CONFIGS
from tests.test_engine import _batch_from_reads

torch.set_num_threads(1)

CONFIGS, CAPS = SWEEP_CONFIGS, SWEEP_CAPS
NUM_READS = 48
SHORT = 40  # the short batch: 8 rows of padding
COUNTERS = ("num_reads", "num_mapped_reads", "num_candidates",
            "num_candidates_without_additional_qgram_filter", "num_mappings")


@dataclasses.dataclass
class World:
    args: FemArgs
    ref: object
    index: object
    reads: list
    golden: GoldenMapper
    jax_engine: object  # one per configuration: its jitted programs are reused


@functools.lru_cache(maxsize=None)
def _world_of(name: str, root: str) -> World:
    k, step, e, a, read_len, max_errors = CONFIGS[name]
    seqs = sim.random_genome(150_000, num_seqs=2, seed=23, repeat_fraction=0.2)
    path = f"{root}/{name}.fa"
    sim.write_fasta(path, seqs)
    ref = fastx.read_fasta(path)
    index = build_index(ref, k, step)
    reads = sim.simulate_reads(seqs, NUM_READS, read_length=read_len,
                               max_errors=max_errors, seed=24)
    args = FemArgs(kmer_size=k, step_size=step, error_threshold=e, num_additional_qgrams=a)
    return World(args, ref, index, reads, GoldenMapper(args, ref, index),
                 jengine.MappingEngine(args, ref, index, jengine.EngineConfig(**CAPS)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cfg"))
    return lambda name: _world_of(name, root)


def check_config(w: World, n: int):
    """Map the first n reads on the port's CPU engine, the golden oracle
    and fem_tpu's engine; returns the golden stats."""
    batch = _batch_from_reads(w.reads[:n])
    engine = MappingEngine(w.args, w.ref, w.index, EngineConfig(**CAPS), device="cpu")
    recs, stats = engine.map_batch(batch)
    grecs, gstats = w.golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    for f in COUNTERS:
        assert getattr(stats, f) == getattr(gstats, f), f
    jeng = w.jax_engine
    before = [getattr(jeng, c) for c in ("retried_reads", "tier_dispatches", "fallback_reads")]
    jrecs, _ = jeng.map_batch(batch)
    assert b"".join(jrecs) == b"".join(grecs)
    after = [getattr(jeng, c) for c in ("retried_reads", "tier_dispatches", "fallback_reads")]
    assert [engine.retried_reads, engine.tier_dispatches, engine.fallback_reads] == \
        [y - x for x, y in zip(before, after)]
    # One program, at tier 0 and the batch's Lmax, padded to batch_size.
    Lmax = batch.codes.shape[1]
    assert (0, Lmax) in engine.programs
    return gstats


@pytest.mark.parametrize("n", [NUM_READS, SHORT], ids=["full", "short"])
@pytest.mark.parametrize("name", ["e7_a2", "e0", "e5_a0", "k10_step5"])
def test_engine_matches_golden_and_jax_config(world, name, n):
    gstats = check_config(world(name), n)
    if name == "e7_a2":  # outside the step bound at 100 bp: no read maps
        assert gstats.num_mapped_reads == 0 and gstats.num_candidates == 0
    else:
        assert gstats.num_mapped_reads > 0
