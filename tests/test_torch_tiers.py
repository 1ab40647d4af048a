"""The port's capacity-retry ladder against the golden oracle and fem_tpu's
engine (mirrors tests/test_retry_tiers.py and tests/test_native.py's
overflow case).

Reads whose selected seeds are satellite-frequent overflow small tier-0
capacities and must climb through bigger tiers, the host mapper only past
the last one, while the output stays byte-identical to the golden oracle
(`map_batch`) or record-set identical (`map_stream`) with exact counters.
Everything is integers and bytes: every comparison is exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fem_tpu import sim
from fem_tpu.config import FemArgs
from fem_tpu.golden.model import GoldenMapper, MappingStats
from fem_tpu.index.build import build_index
from fem_tpu.io import fastx
from fem_tpu.pipeline import engine as jengine
from fem_tpu_torch.parallel.mesh import make_mesh
from fem_tpu_torch.pipeline.engine import (
    EngineConfig,
    MappingEngine,
    TierConfig,
)
from tests.test_engine import _batch_from_reads
from tests.torch_bridges import engine_config_from_jax

torch.set_num_threads(1)

# Small tiers keep the CPU run short and still give two rungs before the
# host mapper (the ladder of tests/test_retry_tiers.py).
TEST_TIERS = (
    TierConfig(batch_size=16, cap_occ=256, cap_cand=256,
               verify_per_read=64, accept_per_read=32),
    TierConfig(batch_size=8, cap_occ=2048, cap_cand=1024,
               verify_per_read=512, accept_per_read=128),
)


@pytest.fixture(scope="module")
def satellite_world(tmp_path_factory):
    seqs = sim.satellite_genome(
        300_000, num_seqs=1, seed=5, satellite_fraction=0.15,
        unit_range=(24, 120), copies_range=(48, 400),
    )
    path = tmp_path_factory.mktemp("sat") / "ref.fa"
    sim.write_fasta(str(path), seqs)
    ref = fastx.read_fasta(str(path))
    index = build_index(ref, kmer_size=12, step_size=3)
    args = FemArgs(error_threshold=3, num_additional_qgrams=1)
    return seqs, ref, index, args


def _engine(world, tiers, **caps):
    _, ref, index, args = world
    caps = dict(dict(cap_occ=32, cap_cand=32, verify_per_read=4, accept_per_read=2), **caps)
    return MappingEngine(args, ref, index, EngineConfig(tiers=tiers, **caps), device="cpu")


def _mixed_reads(seqs, n, seed):
    """Reads drawn uniformly: about satellite_fraction of them land inside
    arrays and overflow small tier-0 caps."""
    return sim.simulate_reads(seqs, n, read_length=100, max_errors=2, seed=seed)


def _golden(world, reads):
    _, ref, index, args = world
    return GoldenMapper(args, ref, index).map_reads(
        [r.name for r in reads], [r.seq for r in reads], [r.qual for r in reads])


def _lines(chunks):
    return sorted(line for c in chunks for line in c.splitlines())


def _stream(eng, reads, B, **kw):
    batches = [_batch_from_reads(reads[i : i + B]) for i in range(0, len(reads), B)]
    total, recs = MappingStats(), []
    for r, st in eng.map_stream(batches, **kw):
        total += st
        recs.extend(r)
    return recs, total


def test_satellite_seed_frequencies_are_heavy_tailed(satellite_world):
    _, _, index, _ = satellite_world
    freq = np.diff(index.lookup.astype(np.int64))
    assert freq.max() >= 100, "generator must create satellite-frequency seeds"


def test_tier_escalation_byte_identical_sync(satellite_world):
    eng = _engine(satellite_world, TEST_TIERS, batch_size=32)
    reads = _mixed_reads(satellite_world[0], 32, seed=91)
    recs, stats = eng.map_batch(_batch_from_reads(reads))
    grecs, gstats = _golden(satellite_world, reads)
    # The synchronous path splices retried reads' records back in read order.
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)
    assert eng.retried_reads > 0, "workload must exercise the retry ladder"
    assert eng.tier_dispatches > 0


def test_tier_escalation_stream_record_set(satellite_world):
    eng = _engine(satellite_world, TEST_TIERS, batch_size=16)
    reads = _mixed_reads(satellite_world[0], 64, seed=92)
    recs, total = _stream(eng, reads, 16)
    grecs, gstats = _golden(satellite_world, reads)
    assert _lines(recs) == _lines(grecs)  # record-set equality (t>1 contract)
    assert dataclasses.asdict(total) == dataclasses.asdict(gstats)
    assert eng.retried_reads > 0
    # Every batch fully emitted: the safe resume offset is the whole stream.
    assert eng.watermark_reads == 64
    assert eng.consumed_reads == 64


def test_no_tiers_routes_overflow_to_host(satellite_world):
    eng = _engine(satellite_world, (), batch_size=16)
    reads = _mixed_reads(satellite_world[0], 16, seed=93)
    recs, stats = eng.map_batch(_batch_from_reads(reads))
    grecs, gstats = _golden(satellite_world, reads)
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)
    assert eng.fallback_reads > 0
    assert eng.retried_reads == 0 and eng.tier_dispatches == 0


def test_last_tier_overflow_reaches_host(satellite_world):
    """A ladder whose top rung is still too small: the host mapper must
    finish the heaviest reads exactly."""
    tiers = (TierConfig(batch_size=8, cap_occ=64, cap_cand=64,
                        verify_per_read=16, accept_per_read=8),)
    eng = _engine(satellite_world, tiers, batch_size=16)
    reads = _mixed_reads(satellite_world[0], 32, seed=94)
    recs, total = _stream(eng, reads, 16)
    grecs, gstats = _golden(satellite_world, reads)
    assert _lines(recs) == _lines(grecs)
    assert dataclasses.asdict(total) == dataclasses.asdict(gstats)
    assert eng.fallback_reads > 0  # the top tier overflowed into the host path
    assert eng.retried_reads > 0
    assert eng.watermark_reads == 32


def test_engine_overflow_fallback_uses_cpu_mapper(small_reference, small_index, default_args):
    """Tiny caps and the default ladder (tests/test_native.py): a read from
    a planted repeat overflows the occurrence slab; the result is still
    byte-identical to golden."""
    seqs, ref = small_reference
    eng = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=32, cap_occ=16, cap_cand=16, verify_per_read=8,
                     accept_per_read=8),
        device="cpu",
    )
    assert len(eng.tiers) == 2
    reads = sim.simulate_reads(seqs, 32, read_length=100, max_errors=2, seed=82)
    rep = seqs[0][1][10_050:10_150]
    reads[0] = sim.SimulatedRead(b"rep", rep, b"I" * 100, 0, 10_050, 0, 0)
    batch = _batch_from_reads(reads)
    recs, stats = eng.map_batch(batch)
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)
    assert eng.retried_reads + eng.fallback_reads > 0


def test_map_batch_equals_jax_engine_with_same_ladder(satellite_world):
    """fem_tpu's engine and the port on one batch with one ladder, carried
    across by engine_config_from_jax: equal bytes, counters and retry
    counters (in map_batch the ladder is deterministic)."""
    seqs, ref, index, args = satellite_world
    jcfg = jengine.EngineConfig(
        batch_size=32, cap_occ=32, cap_cand=32, verify_per_read=4, accept_per_read=2,
        tiers=tuple(jengine.TierConfig(**dataclasses.asdict(t)) for t in TEST_TIERS),
    )
    tcfg = engine_config_from_jax(dataclasses.asdict(jcfg))
    assert tcfg.tiers == TEST_TIERS and tcfg.pipeline_depth == jcfg.pipeline_depth
    assert not hasattr(tcfg, "cap_vote") and not hasattr(tcfg.tiers[0], "cap_vote")
    batch = _batch_from_reads(_mixed_reads(seqs, 32, seed=91))
    jeng = jengine.MappingEngine(args, ref, index, jcfg)
    teng = MappingEngine(args, ref, index, tcfg, device="cpu")
    jrecs, jstats = jeng.map_batch(batch)
    trecs, tstats = teng.map_batch(batch)
    assert b"".join(trecs) == b"".join(jrecs)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    for counter in ("retried_reads", "tier_dispatches", "fallback_reads"):
        assert getattr(teng, counter) == getattr(jeng, counter), counter
    assert teng.retried_reads > 0 and teng.tier_dispatches > 1
    assert teng.watermark_reads == jeng.watermark_reads == 32


def _ladder(engine_cls, config):
    """The tiers an engine derives, without building the engine (the
    port's on one device: a grid of one cell)."""
    eng = object.__new__(engine_cls)
    eng.config = config
    eng.grid = make_mesh(["cpu"])
    return tuple(dataclasses.asdict(t) for t in engine_cls._default_tiers(eng))


@pytest.mark.parametrize(
    "env",
    [None, "none", "256:640:512:32:16;32:4100:4096:2048:512", "256:640:512:32",
     "256:0:512:32:16"],
    ids=["default", "none", "two_rungs", "malformed", "zero_field"],
)
@pytest.mark.parametrize("caps", [dict(batch_size=16384, cap_occ=80, cap_cand=16,
                                       verify_per_read=2, accept_per_read=0.85),
                                  dict(batch_size=48)])
def test_default_tiers_and_env_match_jax(monkeypatch, env, caps):
    """_default_tiers and the FEM_TPU_TIERS parsing against fem_tpu's: the
    same rungs, and the same ValueError text for a malformed string."""
    if env is None:
        monkeypatch.delenv("FEM_TPU_TIERS", raising=False)
    else:
        monkeypatch.setenv("FEM_TPU_TIERS", env)
    jcfg, tcfg = jengine.EngineConfig(**caps), EngineConfig(**caps)
    if env in ("256:640:512:32", "256:0:512:32:16"):
        with pytest.raises(ValueError) as jerr:
            _ladder(jengine.MappingEngine, jcfg)
        with pytest.raises(ValueError) as terr:
            _ladder(MappingEngine, tcfg)
        assert str(terr.value) == str(jerr.value)
        assert "malformed" in str(terr.value)
        return
    want = _ladder(jengine.MappingEngine, jcfg)
    got = _ladder(MappingEngine, tcfg)
    assert got == tuple({k: v for k, v in t.items() if k != "cap_vote"} for t in want)
    assert len(got) == (0 if env == "none" else 2)
    if env and env != "none":
        assert got[1]["cap_occ"] == 4104  # rounded up to the 8-slot chunk
