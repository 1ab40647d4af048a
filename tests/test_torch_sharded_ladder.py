"""The capacity-retry ladder on the port's coordinate-sharded grids
(fem_tpu_torch/parallel/) against the golden oracle and fem_tpu's sharded
engine: reads that overflow any index shard climb the ladder whole, with
the JAX sharded engine's retry counts, and the tier-0 step's per-lane
candidate counts and overflow bits reduced over the index axis equal to
fem_tpu's. Everything is integers and bytes: every comparison is exact
equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, PartitionSpec as P

from fem_tpu.ops.types import DeviceIndex as JDeviceIndex, FilterParams as JFilterParams
from fem_tpu.parallel import sharded_index as jsharded
from fem_tpu.pipeline import engine as jengine
from fem_tpu_torch.ops.step import map_core_steps
from fem_tpu_torch.ops.types import FilterParams
from fem_tpu_torch.parallel.mesh import GridReducer, make_index_mesh
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine, TierConfig
from tests.test_engine import _batch_from_reads
from tests.test_torch_tiers import (  # noqa: F401 (satellite_world: a fixture)
    TEST_TIERS, _golden, _lines, _mixed_reads, _stream, satellite_world)

torch.set_num_threads(1)


def _grid(n_dp, n_ip):
    return make_index_mesh(["cpu"] * (n_dp * n_ip), n_ip)


def _equal(recs, stats, grecs, gstats):
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)


def test_satellite_through_the_sharded_ladder(satellite_world):
    """Tight tier-0 caps on a satellite genome over a (2, 2) grid: reads
    overflow on some shard and climb the ladder whole, in the pipelined
    stream; record set and counters equal the golden oracle's."""
    seqs, ref, index, args = satellite_world
    eng = MappingEngine(args, ref, index, EngineConfig(
        batch_size=16, cap_occ=32, cap_cand=32, verify_per_read=4, accept_per_read=2,
        tiers=TEST_TIERS, index_mesh=_grid(2, 2)), device="cpu")
    reads = _mixed_reads(seqs, 48, seed=92)
    recs, total = _stream(eng, reads, 16)
    grecs, gstats = _golden(satellite_world, reads)
    assert _lines(recs) == _lines(grecs)
    assert dataclasses.asdict(total) == dataclasses.asdict(gstats)
    assert eng.retried_reads > 0 and eng.tier_dispatches > 0
    assert eng.watermark_reads == eng.consumed_reads == 48


def _jax_sharded_counts(jeng, batch, params):
    """fem_tpu's sharded candidate generation (the first half of
    make_index_sharded_map_fn's shard_fn) with the per-lane counts the
    step reduces: num_candidates psum'd and the overflow bits pmax'd over
    the index axis."""
    from fem_tpu.ops.candidates import generate_candidates
    from fem_tpu.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes

    def shard_fn(freq_table, occ_rows, ref_rows, ref_offsets, ref_lengths, num_occ,
                 own_start, own_end, halo_lo, csr_rows, codes, lengths):
        index = JDeviceIndex(
            lookup=None, freq_table=freq_table, occ_rows=occ_rows[0], ref_rows=ref_rows[0],
            ref_offsets=ref_offsets[0], ref_lengths=ref_lengths, num_occurrences=num_occ,
            own_start=own_start[0], own_end=own_end[0], halo_lo=halo_lo[0],
            csr_rows=csr_rows[0])
        both = jnp.concatenate([codes, reverse_complement(codes, lengths)])
        lens2 = jnp.concatenate([lengths, lengths])
        cand = generate_candidates(
            both, lens2, seed_hashes(both, params.kmer_size),
            ambiguous_base_counts(both, lens2, params.kmer_size), index, params,
            index_axis=jsharded.INDEX_AXIS, use_kernel=False)
        nc = jax.lax.psum(cand.num_candidates, jsharded.INDEX_AXIS)
        fb = jax.lax.pmax(cand.needs_fallback.astype(jnp.int32), jsharded.INDEX_AXIS)
        return nc[None], fb[None]

    idx = P(jsharded.INDEX_AXIS)
    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=jeng.config.index_mesh,
        in_specs=(P(), idx, idx, idx, P(), P(), idx, idx, idx, idx,
                  P(jsharded.DATA_AXIS), P(jsharded.DATA_AXIS)),
        out_specs=(P(jsharded.DATA_AXIS), P(jsharded.DATA_AXIS)), check_vma=False))
    nc, fb = fn(*jeng._device_args, jnp.asarray(batch.codes), jnp.asarray(batch.lengths))
    return np.asarray(nc), np.asarray(fb)


def test_retry_counts_equal_jax_sharded_engine(satellite_world):
    """A (1, 2) grid and fem_tpu's sharded engine on one batch with one
    ladder of one small rung (each rung is a program for JAX to compile):
    equal records, counters, retry counters, and per-lane candidate counts
    and overflow bits of the tier-0 step."""
    seqs, ref, index, args = satellite_world
    caps = dict(batch_size=32, cap_occ=32, cap_cand=32, verify_per_read=4, accept_per_read=2)
    jmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "index"))
    rung = dict(batch_size=16, cap_occ=64, cap_cand=64, verify_per_read=16, accept_per_read=8)
    jeng = jengine.MappingEngine(args, ref, index, jengine.EngineConfig(
        tiers=(jengine.TierConfig(**rung),), index_mesh=jmesh, **caps))
    teng = MappingEngine(args, ref, index, EngineConfig(
        tiers=(TierConfig(**rung),), index_mesh=_grid(1, 2), **caps), device="cpu")
    batch = _batch_from_reads(_mixed_reads(seqs, 32, seed=91))
    jrecs, jstats = jeng.map_batch(batch)
    trecs, tstats = teng.map_batch(batch)
    _equal(trecs, tstats, jrecs, jstats)
    for counter in ("retried_reads", "tier_dispatches", "fallback_reads"):
        assert getattr(teng, counter) == getattr(jeng, counter), counter
    assert teng.retried_reads > 0 and teng.fallback_reads > 0

    # The tier-0 step's per-lane counts, reduced over the index axis.
    tp = FilterParams.from_args(args, batch.codes.shape[1], cap_occ=32, cap_cand=32)
    jp = JFilterParams.from_args(args, batch.codes.shape[1], cap_occ=32, cap_cand=32,
                                 cap_vote=32)
    verify_cap, accept_cap = MappingEngine._caps(teng._tier(0))
    jnc, jfb = _jax_sharded_counts(jeng, batch, jp)
    codes = torch.from_numpy(batch.codes)
    lengths = torch.from_numpy(batch.lengths.astype(np.int32))
    gens = [map_core_steps(teng._cell_index[0, i], codes, lengths, tp, verify_cap // 2,
                           max(accept_cap // 2, 8)) for i in range(2)]
    reduce = GridReducer(teng.grid)
    sends, results = [None, None], [None, None]
    while True:
        asks = []
        for k, g in enumerate(gens):
            try:
                asks.append(g.send(sends[k]))
            except StopIteration as stop:
                results[k] = stop.value
        if not asks:
            break
        sends = reduce(asks[0][0], [v for _, v in asks])
    for out in results:
        np.testing.assert_array_equal(out["num_candidates"].numpy(), jnc.reshape(-1))
        np.testing.assert_array_equal(out["needs_fallback"].numpy(), jfb.reshape(-1) > 0)
    assert jnc.sum() > 0 and jfb.any()
