"""The port's pipelined stream: drains on threads, the retry pool, deferred
acks and the watermark (mirrors tests/test_watermark_race.py), plus the
ordered mode, `consumed_reads`, depth and error propagation.

The stream runs drains on executor threads up to `depth` batches ahead of
the consumer, defers completion marks into ack closures that only run
after the consumer pulls the NEXT item, and resolves capacity retries
through a shared pool. The checkpoint contract is

    watermark_reads  <=  reads whose records the consumer has received

at EVERY yield. Randomized delays in the drain path make the executor
threads race and interleave with retries. Everything is integers and
bytes: every comparison is exact equality.
"""

import dataclasses
import random
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from fem_tpu import sim
from fem_tpu.config import FemArgs
from fem_tpu.golden.model import GoldenMapper, MappingStats
from fem_tpu.index.build import build_index
from fem_tpu.io import fastx
from fem_tpu_torch.native import NativeCpuMapper
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine, TierConfig
from tests.test_engine import _batch_from_reads

torch.set_num_threads(1)

TIERS = (
    TierConfig(batch_size=16, cap_occ=256, cap_cand=256,
               verify_per_read=64, accept_per_read=32),
    TierConfig(batch_size=8, cap_occ=2048, cap_cand=1024,
               verify_per_read=512, accept_per_read=128),
)
NUM_READS, B = 96, 16


@dataclasses.dataclass
class World:
    ref: object
    index: object
    args: object
    reads: list
    grecs: list  # golden records, one bytes object per read, in read order
    glines: list  # the same as sorted lines
    gstats: MappingStats

    def engine(self, depth=4, tiers=TIERS):
        return MappingEngine(
            self.args, self.ref, self.index,
            EngineConfig(batch_size=B, cap_occ=32, cap_cand=32, verify_per_read=4,
                         accept_per_read=2, tiers=tiers, pipeline_depth=depth),
            device="cpu",
        )

    def batches(self):
        return [_batch_from_reads(self.reads[i : i + B]) for i in range(0, NUM_READS, B)]


@pytest.fixture(scope="module")
def race_world(tmp_path_factory):
    seqs = sim.satellite_genome(
        250_000, num_seqs=1, seed=17, satellite_fraction=0.15,
        unit_range=(24, 120), copies_range=(48, 400),
    )
    path = tmp_path_factory.mktemp("race") / "ref.fa"
    sim.write_fasta(str(path), seqs)
    ref = fastx.read_fasta(str(path))
    index = build_index(ref, kmer_size=12, step_size=3)
    args = FemArgs(error_threshold=3, num_additional_qgrams=1)
    reads = sim.simulate_reads(seqs, NUM_READS, read_length=100, max_errors=2, seed=18)
    golden = GoldenMapper(args, ref, index)
    grecs, gstats = [], MappingStats()
    for r in reads:  # one read at a time: the records of each read apart
        recs, st = golden.map_reads([r.name], [r.seq], [r.qual])
        grecs.append(b"".join(recs))
        gstats += st
    glines = sorted(line for r in grecs for line in r.splitlines())
    return World(ref, index, args, reads, grecs, glines, gstats)


def _lines(chunks):
    return sorted(line for c in chunks for line in c.splitlines())


def _delayed_drains(engine, seed, max_delay_s=0.03):
    """Wrap the engine's stream drain with a randomized pre-delay so that
    executor threads complete out of submission order."""
    rng = random.Random(seed)
    orig = engine._drain_stream

    def slow(pending):
        time.sleep(rng.random() * max_delay_s)
        return orig(pending)

    engine._drain_stream = slow


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watermark_never_passes_consumer_under_racing_drains(race_world, seed):
    eng = race_world.engine(depth=4)
    _delayed_drains(eng, seed)
    rng = random.Random(1000 + seed)
    total, recs, received = MappingStats(), [], 0
    for r, stats in eng.map_stream(race_world.batches()):
        received += stats.num_reads
        # THE invariant: the safe-resume offset never counts reads whose
        # records the consumer has not yet received.
        assert eng.watermark_reads <= received, (eng.watermark_reads, received)
        recs.extend(r)
        total += stats
        if rng.random() < 0.3:  # racy consumer: sometimes slow to pull
            time.sleep(rng.random() * 0.02)
    assert eng.retried_reads > 0, "workload must exercise the retry pool"
    assert _lines(recs) == race_world.glines
    assert dataclasses.asdict(total) == dataclasses.asdict(race_world.gstats)
    # Drained and all retries resolved: the whole stream is checkpointable.
    assert eng.watermark_reads == NUM_READS
    assert eng.consumed_reads == NUM_READS


def test_watermark_monotone_under_many_interleavings(race_world):
    """More seeds, per-yield monotonicity: the watermark never decreases
    and never exceeds the reads the consumer received."""
    for seed in range(3, 6):
        eng = race_world.engine(depth=3)
        _delayed_drains(eng, seed, max_delay_s=0.01)
        received = last_wm = 0
        for _, stats in eng.map_stream(race_world.batches()):
            received += stats.num_reads
            wm = eng.watermark_reads
            assert last_wm <= wm <= received, (last_wm, wm, received)
            last_wm = wm
        assert eng.watermark_reads == NUM_READS


def test_native_mapper_and_emitter_concurrent_calls_are_exact(race_world):
    """Drain threads call the host mapper (one handle, serialized by its
    lock) and the emitter (no shared scratch) side by side: hammered from 8
    threads, both give what one thread gives."""
    w = race_world
    m = NativeCpuMapper(w.args, w.ref, w.index)
    singles = [m.map_reads([r.name], [r.seq], [r.qual]) for r in w.reads]
    assert [blob for blob, _ in singles] == w.grecs
    eng = w.engine(tiers=())
    batches = w.batches()
    emitted = [eng.map_batch(b) for b in batches]
    with ThreadPoolExecutor(max_workers=8) as ex:
        for _ in range(3):  # repeated rounds raise the collision probability
            results = list(ex.map(lambda r: m.map_reads([r.name], [r.seq], [r.qual]),
                                  w.reads))
            for (blob_s, st_s), (blob_c, st_c) in zip(singles, results):
                assert blob_s == blob_c
                assert (st_s == st_c).all()
            again = list(ex.map(eng.map_batch, batches * 2))
            for (recs_s, st_s), (recs_c, st_c) in zip(emitted * 2, again):
                assert b"".join(recs_s) == b"".join(recs_c)
                assert st_s == st_c


@pytest.mark.parametrize("depth", [1, 4])
def test_ordered_stream_is_a_read_order_prefix_at_every_yield(race_world, depth):
    """`ordered=True`: retries run inside each batch's drain and splice
    back, so the bytes so far are exactly the golden bytes of the first
    `consumed_reads` reads, at every yield; no retry item is ever yielded."""
    eng = race_world.engine(depth=depth)
    _delayed_drains(eng, 40 + depth, max_delay_s=0.01)
    out, total, yields = b"", MappingStats(), 0
    for recs, stats in eng.map_stream(race_world.batches(), ordered=True):
        yields += 1
        out += b"".join(recs)
        total += stats
        assert eng.consumed_reads == yields * B == total.num_reads
        assert out == b"".join(race_world.grecs[: eng.consumed_reads])
        assert eng.watermark_reads <= eng.consumed_reads
    assert yields == NUM_READS // B
    assert dataclasses.asdict(total) == dataclasses.asdict(race_world.gstats)
    assert eng.retried_reads > 0 and eng.watermark_reads == NUM_READS


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_unordered_stream_same_record_set_at_every_depth(race_world, depth):
    """Depth changes which reads share a retry batch, never the records;
    `consumed_reads` counts original batches only, in submission order."""
    eng = race_world.engine()
    recs, total, seen = [], MappingStats(), []
    for r, stats in eng.map_stream(race_world.batches(), depth=depth):
        recs.extend(r)
        total += stats
        seen.append(eng.consumed_reads)
    assert _lines(recs) == race_world.glines
    assert dataclasses.asdict(total) == dataclasses.asdict(race_world.gstats)
    # Original batches advance the position by B each, in order; a retry
    # item (yielded between or after them) leaves it where it is.
    assert seen == sorted(seen) and seen[-1] == NUM_READS
    assert sorted(set(seen)) == [B * (i + 1) for i in range(NUM_READS // B)]
    assert len(seen) > NUM_READS // B
    assert eng.retried_reads > 0 and eng.watermark_reads == NUM_READS


def test_exception_in_a_drain_reaches_the_consumer(race_world):
    eng = race_world.engine(depth=2)
    orig, calls = eng._drain_stream, []

    def failing(pending):
        calls.append(pending.seq)
        if len(calls) == 3:
            raise RuntimeError("drain failed on purpose")
        return orig(pending)

    eng._drain_stream = failing
    got = 0
    with pytest.raises(RuntimeError, match="drain failed on purpose"):
        for _ in eng.map_stream(race_world.batches()):
            got += 1
    assert got == 2  # the two batches before the failing one were delivered
    assert eng._retry_pool is None  # the stream cleaned up after itself
    assert eng.watermark_reads < NUM_READS


def test_second_stream_starts_consumed_reads_at_zero(race_world):
    eng = race_world.engine()
    batches = race_world.batches()
    for _ in eng.map_stream(batches[:4]):
        pass
    assert eng.consumed_reads == 4 * B
    first = True
    for _ in eng.map_stream(batches[4:]):
        if first:
            assert eng.consumed_reads == B
            first = False
    assert eng.consumed_reads == 2 * B
    # The watermark runs on over the engine's life, as in fem_tpu.
    assert eng.watermark_reads == NUM_READS


def test_launch_counter_is_exact_under_threads():
    """Drain threads launch retry batches beside the submitting thread:
    16 threads, more than the cores, each counting 2,000 launches with a
    short switch interval, lose none."""
    import sys

    from fem_tpu_torch import kernels

    kernels.reset_launches()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            done = list(ex.map(
                lambda t: [kernels.count_launch("filter_tail", (80, 16 + t % 2))
                           for _ in range(2000)],
                range(16), timeout=60))
    finally:
        sys.setswitchinterval(before)
    assert len(done) == 16
    assert kernels.launches == {"banded_myers": 0, "filter_tail": 32_000, "occ_slab": 0,
                                "verify_slab": 0, "accept_slab": 0}
    assert kernels.launches_by_shape() == {
        "banded_myers": {}, "filter_tail": {(80, 16): 16_000, (80, 17): 16_000},
        "occ_slab": {}, "verify_slab": {}, "accept_slab": {}}
    kernels.reset_launches()
    assert kernels.launches_by_shape() == {"banded_myers": {}, "filter_tail": {},
                                           "occ_slab": {}, "verify_slab": {},
                                           "accept_slab": {}}
