"""Tier 0's occurrence capacity derived from the index's bucket occupancy
(`pipeline/engine.py: tier0_cap_occ`).

The rule's table at the benchmark's indexes and the CPU fixtures' sizes;
an explicit cap_occ wins over it; the ladder above tier 0 keeps its
shapes whatever tier 0 resolves to; and on a genome indexed at a small k,
so that a bucket holds ~60 occurrences as GRCh38's k=12 buckets do, the
derived tier 0 gives the records and counters of fem_tpu's golden oracle
and of cap_occ 256, with fewer reads retried.
Everything compared is integers and bytes: exact equality.
"""

import dataclasses

import pytest
import torch

from fem_tpu.config import FemArgs as JFemArgs
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.index.build import build_index as jbuild_index
from fem_tpu.io import fastx as jfastx
from fem_tpu_torch import sim
from fem_tpu_torch.config import FemArgs
from fem_tpu_torch.index.build import build_index
from fem_tpu_torch.io import fastx
from fem_tpu_torch.parallel.mesh import make_index_mesh
from fem_tpu_torch.pipeline.engine import (
    BASE_CAP_OCC,
    EngineConfig,
    MappingEngine,
    TierConfig,
    tier0_cap_occ,
)

torch.set_num_threads(1)

# Tier 1 and tier 2 of EngineConfig(): (batch, cap_occ, cap_cand, verify, accept).
LADDER = ((512, 2048, 2048, 64, 16), (64, 16384, 16384, 2048, 512))
CHR21, GRCH38 = 15_569_991, 999_999_915  # k=12 step=3 occurrences (PERF.md §4)


@pytest.mark.parametrize("occurrences,kmer,seeds,want", [
    (CHR21, 12, 7, 256),  # chr21_e5: 0.93 a bucket asks 104 slots
    (CHR21, 12, 10, 256),  # chr21_e7: e=7 a=2, 10 seeds a group ask 139
    (GRCH38, 12, 7, 576),  # grch38_e5: 59.6 a bucket ask 574
    (GRCH38 // 4, 12, 7, 256),  # a (1, 4) GRCh38 grid's shard, ~15 a bucket
    (80_000, 12, 5, 256),  # a CPU fixture's 240 kb genome at e=3 a=1
    (246_665, 6, 5, 448),  # this file's heavy fixture: 60.2 a 6-mer bucket
], ids=["chr21_e5", "chr21_e7", "grch38_e5", "grch38_shard4", "cpu_fixture", "heavy_k6"])
def test_rule_table(occurrences, kmer, seeds, want):
    got = tier0_cap_occ(occurrences, kmer, seeds, LADDER[0][1])
    assert got == want
    assert got % 8 == 0 and BASE_CAP_OCC <= got <= LADDER[0][1]


def test_rule_clamps_to_tier1():
    """Above the floor the rule never passes tier 1's cap_occ; below the
    floor a small tier 1 leaves tier 0 at the floor."""
    assert tier0_cap_occ(GRCH38, 12, 7, 512) == 512
    assert tier0_cap_occ(100 * GRCH38, 12, 7, 2048) == 2048
    assert tier0_cap_occ(100 * GRCH38, 12, 7) > 2048
    assert tier0_cap_occ(GRCH38, 12, 7, 240) == BASE_CAP_OCC
    assert tier0_cap_occ(0, 12, 7) == BASE_CAP_OCC


@pytest.fixture(scope="module")
def heavy_world(tmp_path_factory):
    """740 kb of uniform bases indexed at k=6 step 3: 246,665 occurrences,
    60.2 a bucket; e=3 a=1 on 40 bp reads, whose groups of 11-12 seeds
    leave the seed DP little choice of its 5 (as 100 bp reads at k=12
    leave it), so that cap_occ 256 holds few groups and the rule derives
    448; 48 reads."""
    d = tmp_path_factory.mktemp("heavy")
    seqs = sim.random_genome(740_000, num_seqs=1, seed=31)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    sim.write_fastq(str(d / "reads.fq"),
                    sim.simulate_reads(seqs, 48, read_length=40, max_errors=3, seed=8))
    ref = fastx.read_fasta(str(d / "ref.fa"))
    index = build_index(ref, 6, 3)
    args = FemArgs(kmer_size=6, step_size=3, error_threshold=3, num_additional_qgrams=1)
    batch = next(fastx.stream_fastq_batches(str(d / "reads.fq"), 48))
    return ref, index, args, batch, str(d / "ref.fa")


def _engine(world, **config):
    ref, index, args = world[:3]
    return MappingEngine(args, ref, index, EngineConfig(batch_size=48, **config), device="cpu")


def _ladder(engine):
    return tuple((t.batch_size, t.cap_occ, t.cap_cand, t.verify_per_read, t.accept_per_read)
                 for t in engine.tiers)


@pytest.mark.parametrize("cap_occ", [None, 80, 256, 512])
def test_explicit_cap_wins(heavy_world, cap_occ):
    """An explicit cap_occ is tier 0's as given, reported not derived; None
    derives the rule's value from the index."""
    _, index, args = heavy_world[:3]
    engine = _engine(heavy_world, cap_occ=cap_occ)
    want = (tier0_cap_occ(index.num_occurrences, 6, args.num_qgrams, engine.tiers[0].cap_occ)
            if cap_occ is None else cap_occ)
    assert engine._tier(0).cap_occ == engine.tier0_cap_occ == want
    report = engine.report()
    assert report["tier0_cap_occ"] == want
    assert report["tier0_cap_occ_derived"] is (cap_occ is None)


@pytest.fixture(scope="module")
def light_world(tmp_path_factory):
    """20 kb indexed at k=12: a bucket holds 0.0004 occurrences."""
    path = str(tmp_path_factory.mktemp("light") / "ref.fa")
    sim.write_fasta(path, sim.random_genome(20_000, num_seqs=1, seed=3))
    ref = fastx.read_fasta(path)
    return ref, build_index(ref, 12, 3)


def test_ladder_keeps_its_shapes(heavy_world, light_world):
    """Tiers 1 and 2 of EngineConfig() are today's on a light index, and on
    one whose tier 0 derives wider than 256 they are what cap_occ=256
    gives."""
    light = MappingEngine(FemArgs(error_threshold=5), *light_world, EngineConfig(),
                          device="cpu")
    assert light.tier0_cap_occ == BASE_CAP_OCC and _ladder(light) == LADDER
    heavy = _engine(heavy_world)
    assert heavy.tier0_cap_occ == 448
    assert _ladder(heavy) == _ladder(_engine(heavy_world, cap_occ=BASE_CAP_OCC)) == (
        (48, *LADDER[0][1:]), (48, *LADDER[1][1:]))  # the 48-read batch bounds both


def test_derived_cap_maps_as_256_does(heavy_world):
    """The same batch through the derived tier 0, through cap_occ 256 and
    through fem_tpu's golden oracle on fem_tpu's own index of the same
    FASTA: byte-equal records, equal counters, and fewer reads retried at
    the derived width (the ladder is exact, so a read mapped at tier 0
    gives the records it gave at tier 1)."""
    batch, fasta = heavy_world[3:]
    derived, fixed = _engine(heavy_world), _engine(heavy_world, cap_occ=BASE_CAP_OCC)
    recs_d, stats_d = derived.map_batch(batch)
    recs_f, stats_f = fixed.map_batch(batch)
    jref = jfastx.read_fasta(fasta)
    golden = GoldenMapper(JFemArgs(kmer_size=6, step_size=3, error_threshold=3,
                                   num_additional_qgrams=1), jref, jbuild_index(jref, 6, 3))
    recs_g, stats_g = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(recs_d) == b"".join(recs_g) == b"".join(recs_f)
    assert dataclasses.asdict(stats_d) == dataclasses.asdict(stats_g) == dataclasses.asdict(stats_f)
    assert stats_d.num_mapped_reads > 0
    assert fixed.retried_reads > derived.retried_reads
    assert derived.report()["tier0_cap_occ"] == 448
    assert sorted(derived.programs)[0][0] == 0
    assert derived.programs[sorted(derived.programs)[0]].step.params.cap_occ == 448


def test_index_grid_derives_from_its_largest_shard(heavy_world):
    """A coordinate-sharded grid derives tier 0 from its largest cell's
    occurrences, and keeps the default ladder."""
    ref, index, args = heavy_world[:3]
    engine = MappingEngine(args, ref, index, EngineConfig(
        batch_size=48, index_mesh=make_index_mesh(["cpu"] * 2, 2)), device="cpu")
    largest = max(c["occurrences"] for c in engine.report()["cells"])
    assert index.num_occurrences // 2 <= largest < index.num_occurrences
    assert engine.tier0_cap_occ == tier0_cap_occ(largest, 6, args.num_qgrams, 2048)
    assert _ladder(engine)[0][1:3] == (2048, 2048)


def test_tier_config_of_explicit_ladder(heavy_world):
    """An explicit ladder's tier 1 bounds the derived tier 0."""
    rung = TierConfig(batch_size=16, cap_occ=320, cap_cand=512,
                      verify_per_read=64, accept_per_read=16)
    engine = _engine(heavy_world, tiers=(rung,))
    assert engine.tier0_cap_occ == 320
    assert _engine(heavy_world, tiers=()).tier0_cap_occ == 448
