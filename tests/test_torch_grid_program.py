"""The grid's compiled step on the CPU (fem_tpu_torch/pipeline/engine.py
GridProgram, fem_tpu_torch/parallel/mesh.py GridStep) against fem_tpu's
jitted sharded program.

A grid dispatch is padded to its tier's batch size and split evenly over
the data rows, as fem_tpu pads its program's input and then shards it over
the data axis, so a short batch's reads fall on the same rows and overflow
the same per-cell slabs: the retry counters equal fem_tpu's. Each cell's
step is cut at the points where a row's cells meet into segments; on the
CPU the segments run eagerly, and they equal map_core on a one-cell grid
and fem_tpu's per-lane counts on a (2, 2) grid. On a card each segment is
a CUDA graph (chip_smoke.py phase 9 holds them). Everything is integers and
bytes: every comparison is exact equality.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fem_tpu import sim
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.ops.types import FilterParams as JFilterParams
from fem_tpu.parallel import mesh as jmesh
from fem_tpu.pipeline import engine as jengine
from fem_tpu_torch.ops.step import map_core, pack_result, unpack_input
from fem_tpu_torch.parallel.mesh import make_index_mesh, make_mesh
from fem_tpu_torch.pipeline.engine import EngineConfig, GridProgram, MappingEngine, TierConfig
from tests.test_engine import _batch_from_reads
from tests.test_torch_sharded_ladder import _jax_sharded_counts
from tests.test_torch_tiers import (  # noqa: F401 (satellite_world: a fixture)
    _mixed_reads, satellite_world)

torch.set_num_threads(1)

# The configuration whose short batches split differently before grids
# were padded: one rung, and verify and accept slabs of one slot a read.
CAPS = dict(batch_size=32, cap_occ=256, cap_cand=128, verify_per_read=1, accept_per_read=1)
RUNG = dict(batch_size=16, cap_occ=64, cap_cand=64, verify_per_read=16, accept_per_read=8)
COUNTERS = ("retried_reads", "tier_dispatches", "fallback_reads")


def _grids(n_dp, n_ip):
    """(fem_tpu's EngineConfig grid field, the port's) of one shape."""
    devs = jax.devices()[: n_dp * n_ip]
    if n_ip == 1:
        return dict(mesh=jmesh.make_mesh(devs)), dict(mesh=make_mesh(["cpu"] * n_dp))
    return (dict(index_mesh=Mesh(np.array(devs).reshape(n_dp, n_ip), ("data", "index"))),
            dict(index_mesh=make_index_mesh(["cpu"] * (n_dp * n_ip), n_ip)))


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)], ids=["data2", "grid2x2"])
def engines(request, satellite_world):
    """fem_tpu's engine and the port's on one grid shape, kept over the
    cases so that fem_tpu compiles each program once."""
    _, ref, index, args = satellite_world
    jgrid, tgrid = _grids(*request.param)
    jeng = jengine.MappingEngine(args, ref, index, jengine.EngineConfig(
        tiers=(jengine.TierConfig(**RUNG),), **jgrid, **CAPS))
    teng = MappingEngine(args, ref, index, EngineConfig(
        tiers=(TierConfig(**RUNG),), **tgrid, **CAPS), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("n", [24, 20])
def test_short_grid_batch_retries_as_fem_tpu(engines, satellite_world, n):
    """The first n of 32 reads on a data grid of 2 and a (2, 2) grid: the
    retry counters, records and counters equal fem_tpu's."""
    jeng, teng = engines
    batch = _batch_from_reads(_mixed_reads(satellite_world[0], 32, seed=91)[:n])
    before = [(getattr(jeng, c), getattr(teng, c)) for c in COUNTERS]
    jrecs, jstats = jeng.map_batch(batch)
    trecs, tstats = teng.map_batch(batch)
    assert b"".join(trecs) == b"".join(jrecs)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    moved = [(getattr(jeng, c) - j, getattr(teng, c) - t) for c, (j, t) in zip(COUNTERS, before)]
    for counter, (j, t) in zip(COUNTERS, moved):
        assert t == j, counter
    assert moved[0][0] > 0 and moved[2][0] > 0  # reads retried, reads host-mapped
    # Every dispatch of the grid went through its (tier, Lmax) program.
    assert set(teng.programs) == {(0, 128), (1, 128)}
    assert all(isinstance(p, GridProgram) for p in teng.programs.values())


def test_segments_equal_map_core_on_one_cell(small_reference, small_index, default_args):
    """A one-cell grid's segment runner (one segment: a row of one cell
    reduces to itself) and map_core on the same padded batch: the same
    dict, and the program's packed result is map_core's."""
    seqs, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index, EngineConfig(
        batch_size=16, cap_occ=256, cap_cand=128, verify_per_read=0.25,
        mesh=make_mesh(["cpu"])), device="cpu")
    batch = _batch_from_reads(sim.simulate_reads(seqs, 11, read_length=100, max_errors=2,
                                                 seed=61))
    packed = engine._packed(batch, engine._tier(0))
    prog = engine._program(0, 128)
    cpu = torch.device("cpu")
    got = prog.step.run(engine._cell_index, {(0, cpu): packed}, {})[0]
    codes, lengths = unpack_input(packed)
    want = map_core(engine._cell_index[0, 0], codes, lengths, prog.step.params,
                    prog.step.verify_cap, prog.step.accept_cap)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert want["retry"].any()
    flat, ready = prog.run({0: packed})
    assert ready == [] and torch.equal(flat, pack_result(want))



def test_one_card_is_a_one_cell_grid(small_reference, small_index, default_args):
    """An engine on one device holds only GridPrograms: a batch that
    overflows tier 0 (a verify slab of 8 slots for 16 reads) maps to the
    same bytes, counters and report, step programs and their dispatches
    included, as the same engine given a one-cell data grid, and both equal
    the golden oracle."""
    seqs, ref = small_reference
    caps = dict(batch_size=16, cap_occ=256, cap_cand=128, verify_per_read=0.25,
                accept_per_read=1)
    card = MappingEngine(default_args, ref, small_index, EngineConfig(**caps), device="cpu")
    grid = MappingEngine(default_args, ref, small_index,
                         EngineConfig(**caps, mesh=make_mesh(["cpu"])), device="cpu")
    assert card.grid.grid.shape == (1, 1)
    batch = _batch_from_reads(sim.simulate_reads(seqs, 16, read_length=100, max_errors=2,
                                                 seed=53))
    recs, stats = card.map_batch(batch)
    grecs, gstats = grid.map_batch(batch)
    orecs, ostats = GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs) == b"".join(orecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats) == dataclasses.asdict(ostats)
    assert card.retried_reads > 0
    assert set(card.programs) == {(0, 128), (1, 128)}
    assert all(isinstance(p, GridProgram) for p in card.programs.values())
    for c in COUNTERS + ("dispatches_by_tier",):
        assert getattr(card, c) == getattr(grid, c), c
    report = card.report()
    assert [(p["key"], p["dispatches"]) for p in report["programs"]] == [
        ([0, 128], 1), ([1, 128], card.tier_dispatches)]
    assert report == grid.report()

def test_short_batch_counts_equal_jax_sharded_program(satellite_world):
    """A (2, 2) grid's segments on a short batch padded to the tier's batch
    size, as fem_tpu's program takes it: each cell's per-lane candidate
    counts and overflow bits, reduced over its row, equal fem_tpu's."""
    seqs, ref, index, args = satellite_world
    jgrid, tgrid = _grids(2, 2)
    jeng = jengine.MappingEngine(args, ref, index, jengine.EngineConfig(**jgrid, **CAPS))
    teng = MappingEngine(args, ref, index, EngineConfig(**tgrid, **CAPS), device="cpu")
    batch = _batch_from_reads(_mixed_reads(seqs, 32, seed=91)[:20])
    tc = teng._tier(0)
    packed = teng._packed(batch, tc)
    codes, lengths = unpack_input(packed)
    padded = types.SimpleNamespace(codes=codes.numpy(), lengths=lengths.numpy())
    jp = JFilterParams.from_args(args, 128, cap_occ=tc.cap_occ, cap_cand=tc.cap_cand,
                                 cap_vote=tc.cap_occ)
    jnc, jfb = _jax_sharded_counts(jeng, padded, jp)
    prog = teng._program(0, 128)
    Bloc = tc.batch_size // 2
    rows = {(d, dev): packed[d * Bloc : (d + 1) * Bloc] for d, dev in prog.rows}
    outs = prog.step.run(teng._cell_index, rows, {})
    for (d, i, _), out in zip(prog.step.cells, outs):
        np.testing.assert_array_equal(out["num_candidates"].numpy(), jnc[d], err_msg=(d, i))
        np.testing.assert_array_equal(out["needs_fallback"].numpy(), jfb[d] > 0, err_msg=(d, i))
    assert len(prog.step.cells) == 4 and jnc.sum() > 0 and jfb.any()
    # Rows past the batch's reads hold only empty reads: no candidate.
    assert not jnc[1][Bloc - 12 : Bloc].any() and not jnc[1][2 * Bloc - 12 :].any()


def test_one_grid_program_per_tier_and_lmax(small_reference, small_index, default_args):
    """A data grid of 2 with a tight verify slab: 100 bp batches (Lmax 128)
    make one tier-0 program and one tier-1 program for their overflow
    reads, a 150 bp batch (Lmax 160) another tier-0 program; mapping again
    makes none. The engine's report lists each with its dispatches."""
    seqs, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index, EngineConfig(
        batch_size=16, cap_occ=256, cap_cand=128, verify_per_read=0.25, accept_per_read=1,
        mesh=make_mesh(["cpu"] * 2)), device="cpu")
    short = sim.simulate_reads(seqs, 32, read_length=100, max_errors=2, seed=62)
    long = sim.simulate_reads(seqs, 6, read_length=150, max_errors=2, seed=63)
    batches = [_batch_from_reads(short[:16]), _batch_from_reads(short[16:]),
               _batch_from_reads(long)]
    for _ in range(2):
        for b in batches:
            engine.map_batch(b)
        assert set(engine.programs) == {(0, 128), (1, 128), (0, 160)}
    assert engine.retried_reads > 0
    progs = {tuple(p["key"]): p for p in engine.report()["programs"]}
    assert set(progs) == set(engine.programs)
    assert progs[0, 128]["dispatches"] == 4 and progs[0, 160]["dispatches"] == 2
    assert progs[1, 128]["dispatches"] == engine.tier_dispatches
    assert [c["cell"] for c in progs[0, 128]["cells"]] == [[0, 0], [1, 0]]
    # A program is the key's own: its shapes follow the tier and Lmax.
    p128, p160, t1 = (engine.programs[k].step for k in ((0, 128), (0, 160), (1, 128)))
    assert (p128.params.max_read_length, p160.params.max_read_length) == (128, 160)
    assert p128.verify_cap == p160.verify_cap == int(2 * 16 * 0.25) // 2
    assert t1.params.cap_occ == engine.tiers[0].cap_occ
