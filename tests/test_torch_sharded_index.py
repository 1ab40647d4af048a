"""The port's coordinate-sharded index (fem_tpu_torch/parallel/sharded_index.py)
against fem_tpu's: the host build field by field, the partitions, the
truncation bound's single int64 key against the JAX package's two-step
pmax, and the engine on (data, index) grids of CPU entries, record- and
counter-equal to the golden oracle (tests/test_sharded_index.py's cases).
The retry ladder on grids: tests/test_torch_sharded_ladder.py. Everything
is integers and bytes: every comparison is exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fem_tpu import sim
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.parallel import sharded_index as jsharded
from fem_tpu_torch.ops.occ_slab import truncation_key
from fem_tpu_torch.parallel import sharded_index as tsharded
from fem_tpu_torch.parallel.mesh import make_index_mesh
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
from tests.test_engine import _batch_from_reads
from tests.torch_bridges import device_index_from_jax_shard

torch.set_num_threads(1)

ENGINE_CAPS = dict(cap_occ=256, cap_cand=128, verify_per_read=32, accept_per_read=16)


def _grid(n_dp, n_ip):
    return make_index_mesh(["cpu"] * (n_dp * n_ip), n_ip)


def _equal(recs, stats, grecs, gstats):
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_build_equals_jax_field_by_field(small_reference, small_index, num_shards):
    _, ref = small_reference
    want = jsharded.build_sharded_index(small_index, ref, num_shards)
    got = tsharded.build_sharded_index(small_index, ref, num_shards)
    assert got.num_shards == want.num_shards and got.halo == want.halo
    assert got.ranges == want.ranges
    np.testing.assert_array_equal(got.lookup, want.lookup)
    assert got.lookup.dtype == np.int64  # offsets up to 2^32 - 1 (the index file's u32)
    for f in ("own_start", "own_end", "halo_lo", "ref_lengths", "freq_table"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got.ref_offsets, want.ref_offsets.astype(np.int64))
    assert got.num_occurrences == int(want.num_occurrences) == small_index.num_occurrences
    for s in range(num_shards):
        n = int(want.lookup[s, -1])
        pairs = want.occ_rows[s].reshape(-1, 2)[:n].astype(np.uint64)
        np.testing.assert_array_equal(got.occ[s], (pairs[:, 0] << np.uint64(32)) | pairs[:, 1])
        np.testing.assert_array_equal(
            np.stack([want.csr_rows[s, :, 0], want.csr_rows[s, :, 1]], 1),
            np.stack([got.lookup[s, :-1], got.lookup[s, 1:]], 1))
        flat = got.ref_flat[s]
        np.testing.assert_array_equal(flat, want.ref_flat[s, : flat.shape[0]])
        assert (want.ref_flat[s, flat.shape[0]:] == 4).all()
    assert (got.ref_offsets < 0).any() == (num_shards == 4)  # slices starting mid-chromosome


def test_device_index_from_jax_shard_equals_port_shard(small_reference, small_index):
    _, ref = small_reference
    want = jsharded.build_sharded_index(small_index, ref, 2)
    got = tsharded.build_sharded_index(small_index, ref, 2)
    arrays = {f: np.asarray(getattr(want, f)) for f in (
        "lookup", "occ_rows", "ref_flat", "ref_offsets", "own_start", "own_end",
        "halo_lo", "freq_table", "num_occurrences", "ref_lengths")}
    for s in range(2):
        a = device_index_from_jax_shard(arrays, s, "cpu")
        b = got.device_index(s, "cpu")
        for f in ("occ", "lookup", "freq_table", "ref_offsets", "ref_lengths",
                  "own_start", "own_end", "halo_lo"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        n = b.ref_flat.shape[0]
        assert torch.equal(a.ref_flat[:n], b.ref_flat) and bool((a.ref_flat[n:] == 4).all())
        assert a.num_occurrences == b.num_occurrences == small_index.num_occurrences
        # The shard's DP and sort decisions are global: not its own CSR's.
        assert b.num_occurrences > b.occ.shape[0]
        assert not torch.equal(b.freq_table, torch.diff(b.lookup))


@pytest.mark.parametrize("lengths,shards", [
    ([50, 10, 40, 30, 70], 2), ([50, 10, 40, 30, 70], 4), ([1000, 50, 50], 4),
    ([5, 5], 3), ([100], 4)])
def test_partitions_equal_jax(lengths, shards):
    lengths = np.array(lengths)
    assert tsharded.partition_chromosomes(lengths, shards) == \
        jsharded.partition_chromosomes(lengths, shards)
    got = tsharded.partition_ranges(lengths, shards)
    assert got == jsharded.partition_ranges(lengths, shards)
    # Disjoint, in order, covering (tests/test_sharded_index.py).
    covered = {sid: 0 for sid in range(len(lengths))}
    for sid, s, e in (p for pieces in got for p in pieces):
        assert s == covered[sid]
        covered[sid] = e
    assert covered == dict(enumerate(lengths.tolist()))


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_truncation_key_equals_two_step_rule(n_shards):
    """One max of sid << 32 | diag over the shards keeps exactly the slots
    that fem_tpu's pmax of tsid, then pmax of tpos at that tsid, keep."""
    rng = np.random.default_rng(7 + n_shards)
    shape = (64, 3, 40)
    sids = [torch.from_numpy(rng.integers(0, 4, shape)) for _ in range(n_shards)]
    diags = [torch.from_numpy(rng.integers(0, 2**32 - 1, shape)) for _ in range(n_shards)]
    for d in diags:  # many ties on diag too
        d[:, :, ::3] = d[:, :, :1]
    others = [torch.from_numpy(rng.random(shape) < 0.3) for _ in range(n_shards)]
    others[0][:4] = False  # lanes with no other seed anywhere
    for o in others[1:]:
        o[:4] = False
    key = torch.stack([truncation_key(s, d, o) for s, d, o in zip(sids, diags, others)]).amax(0)
    tsid = torch.stack([torch.where(o, s, -1).amax(2, keepdim=True)
                        for s, o in zip(sids, others)]).amax(0)
    tpos = torch.stack([torch.where(o & (s == tsid), d, -1).amax(2, keepdim=True)
                        for s, d, o in zip(sids, diags, others)]).amax(0)
    for s, d in zip(sids, diags):
        two_step = (s < tsid) | ((s == tsid) & (d <= tpos))
        assert torch.equal(((s << 32) | d) <= key, two_step)
    assert (key[:4] == -1).all() and (tsid[:4] == -1).all()


@pytest.mark.parametrize("n_dp,n_ip", [(1, 2), (2, 2), (1, 4), (4, 2)])
def test_sharded_engine_matches_golden(small_reference, small_index, default_args, n_dp, n_ip):
    seqs, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=32, index_mesh=_grid(n_dp, n_ip), **ENGINE_CAPS),
                           device="cpu")
    reads = sim.simulate_reads(seqs, 32, read_length=100, max_errors=2, seed=51)
    # The planted cross-chromosome repeat: hits in both halves of the genome.
    reads[0] = sim.SimulatedRead(b"rep", seqs[0][1][10_060:10_160], b"I" * 100, 0, 10_060, 0, 0)
    batch = _batch_from_reads(reads)
    recs, stats = engine.map_batch(batch)
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals)
    _equal(recs, stats, grecs, gstats)
    rep = [r for r in b"".join(grecs).splitlines() if r.startswith(b"rep\t")]
    assert len({line.split(b"\t")[2] for line in rep}) == 2
    assert len(engine._cell_index) == n_dp * n_ip
    assert len({id(x) for x in engine._cell_index.values()}) == n_ip  # a shard once a device


def test_split_boundary_reads_match_golden(small_reference, small_index, default_args):
    """Reads across the mid-chromosome cuts of 4 index shards (50 kb into
    each chromosome): each candidate owned by one shard, bands verified
    across the cut from the halo."""
    seqs, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=16, index_mesh=_grid(1, 4), **ENGINE_CAPS),
                           device="cpu")
    reads = []
    for i, off in enumerate(range(-120, 120, 15)):
        pos = 50_000 + off
        reads.append(sim.SimulatedRead(b"cut%d" % i, seqs[i % 2][1][pos : pos + 100],
                                       b"I" * 100, i % 2, pos, 0, 0))
    batch = _batch_from_reads(reads)
    recs, stats = engine.map_batch(batch)
    _equal(recs, stats, *GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals))
    assert stats.num_mapped_reads == 16


def test_halo_risk_reads_reach_the_host_mapper(small_reference, small_index, default_args):
    """Reads inside the first e positions past a shard's left halo start
    carry the inherent bit on that shard and are mapped on the host; the
    records stay the golden oracle's."""
    seqs, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=8, index_mesh=_grid(1, 4), **ENGINE_CAPS),
                           device="cpu")
    cut = 50_000 - 4096  # shard 1's halo starts here on chromosome 0
    reads = [sim.SimulatedRead(b"h%d" % k, seqs[0][1][cut + k : cut + k + 100], b"I" * 100,
                               0, cut + k, 0, 0) for k in range(8)]
    batch = _batch_from_reads(reads)
    recs, stats = engine.map_batch(batch)
    _equal(recs, stats, *GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals))
    assert engine.fallback_reads > 0 and engine.retried_reads == 0


def test_read_longer_than_halo_raises(small_reference, small_index, default_args):
    seqs, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=4, index_mesh=_grid(1, 2), **ENGINE_CAPS),
                           device="cpu")
    engine._sharded_halo = 100
    batch = _batch_from_reads(sim.simulate_reads(seqs, 4, read_length=100, seed=3))
    with pytest.raises(ValueError, match="halo"):
        engine.map_batch(batch)
