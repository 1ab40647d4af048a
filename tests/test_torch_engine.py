"""The port's mapping step and engine: map_core against fem_tpu's, and
MappingEngine against the golden oracle on records and counters."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from fem_tpu import sim
from fem_tpu.golden.model import GoldenMapper, MappingStats
from fem_tpu.pipeline.engine import map_core as jmap_core
from fem_tpu_torch.ops.step import map_core, pack_result, unpack_result
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
from tests.test_engine import _batch_from_reads
from tests.torch_bridges import device_index_from_jax

torch.set_num_threads(1)


def test_map_core_matches_jax():
    dindex, params, codes, lengths = __graft_entry__._toy_world()
    # cap_vote = cap_occ: fem_tpu's XLA path then never overflows its vote slab.
    jparams = dataclasses.replace(params, cap_vote=params.cap_occ)
    verify_cap, accept_cap = 96, 40  # small enough that both caps truncate
    want = jax.jit(functools.partial(
        jmap_core, params=jparams, verify_cap=verify_cap, use_pallas=False,
        accept_cap=accept_cap,
    ))(dindex, codes, lengths)
    want = {k: np.asarray(v) for k, v in want.items()}
    arrays = {k: np.asarray(getattr(dindex, k)) for k in (
        "occ_rows", "ref_rows", "csr_rows", "ref_offsets", "ref_lengths",
        "num_occurrences")}
    got = map_core(
        device_index_from_jax(arrays, "cpu"), torch.tensor(np.asarray(codes)),
        torch.tensor(np.asarray(lengths)), params, verify_cap, accept_cap,
    )
    n = int(want["n_accepted"][0])
    assert int(got["n_accepted"]) == n > accept_cap
    for k in ("a_lane", "a_sid", "a_pos", "a_ed", "a_end"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("num_candidates", "dp_total", "needs_fallback", "inherent_fallback",
              "retry", "total_candidates", "slab_overflow"):
        np.testing.assert_array_equal(
            got[k].numpy().astype(np.int64).reshape(-1),
            want[k].astype(np.int64).reshape(-1), err_msg=k,
        )
    assert want["retry"].any() and not want["retry"].all()
    # The host copy carries the same hits and pack_outputs' derived fields.
    host = unpack_result(pack_result(got).numpy(), max(accept_cap, 8), codes.shape[0])
    assert host["n_accepted"] == accept_cap
    np.testing.assert_array_equal(host["a_pos"], want["a_pos"])
    B = codes.shape[0]
    nf, inh = want["needs_fallback"], want["inherent_fallback"]
    fb = nf[:B] | nf[B:] | want["retry"] | inh[:B] | inh[B:]
    np.testing.assert_array_equal(host["fb"], fb)
    keep = ~np.concatenate([fb, fb])
    assert host["sum_nc"] == int(want["num_candidates"][keep].sum())
    assert host["sum_dp"] == int(want["dp_total"].astype(np.int64)[keep].sum())


@pytest.fixture(scope="module")
def engine_world(small_reference, small_index, default_args):
    seqs, ref = small_reference
    engine = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=64, cap_occ=256, cap_cand=128, verify_per_read=32),
        device="cpu",
    )
    return seqs, engine, GoldenMapper(default_args, ref, small_index)


def _assert_equal(recs, stats, grecs, gstats):
    assert b"".join(recs) == b"".join(grecs)  # byte-identical, read order
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)


def test_engine_matches_golden(engine_world):
    seqs, engine, golden = engine_world
    reads = sim.simulate_reads(seqs, 64, read_length=100, max_errors=2, seed=31)
    batch = _batch_from_reads(reads)
    _assert_equal(*engine.map_batch(batch),
                  *golden.map_reads(batch.names, batch.seqs, batch.quals))


def test_engine_mixed_lengths_and_ns(engine_world):
    seqs, engine, golden = engine_world
    base = sim.simulate_reads(seqs, 12, read_length=100, max_errors=2, seed=33)
    muts = []
    for i, r in enumerate(base):
        s = r.seq
        if i % 4 == 0:
            s = s[:57]
        elif i % 4 == 1:
            s = s[:20] + b"N" + s[21:]
        elif i % 4 == 2:
            s = s[:20] + b"NNNN" + s[24:]  # > e ambiguous -> unmapped
        muts.append(sim.SimulatedRead(r.name, s, b"I" * len(s), r.sid, r.pos, r.strand, 0))
    batch = _batch_from_reads(muts)
    _assert_equal(*engine.map_batch(batch),
                  *golden.map_reads(batch.names, batch.seqs, batch.quals))


def test_engine_host_fallback_and_stream(small_reference, small_index, default_args):
    """Caps so tight that reads overflow, and no retry ladder: they are
    mapped exactly on the host and spliced back in read order; a stream of
    batches adds up."""
    seqs, ref = small_reference
    engine = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=32, cap_occ=8, cap_cand=2, verify_per_read=1,
                     accept_per_read=0.5, tiers=()),
        device="cpu",
    )
    golden = GoldenMapper(default_args, ref, small_index)
    reads = sim.simulate_reads(seqs, 80, read_length=100, max_errors=2, seed=34)
    reads.append(sim.SimulatedRead(b"rep", seqs[0][1][10_050:10_150], b"I" * 100,
                                   0, 10_050, 0, 0))  # both repeat copies
    batches = [_batch_from_reads(reads[i : i + 32]) for i in range(0, len(reads), 32)]
    recs, total = [], MappingStats()
    for r, st in engine.map_stream(batches):
        recs.extend(r)
        total += st
    _assert_equal(recs, total, *golden.map_reads(
        [r.name for r in reads], [r.seq for r in reads], [r.qual for r in reads]))
    assert 0 < engine.fallback_reads < len(reads)
