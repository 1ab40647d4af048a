"""The filter tail at the retry tiers' widths, on the CPU.

cap_cand + cap_occ of 640 + 512 (the default ladder's tier 1), 2048 + 1024,
4096 + 4096, 5120 + 4096 (tier 2) and one whose scratch does not fit shared
memory, so the CUDA kernel runs it on a workspace: the plain version == the
g++ host build of the kernel's block lane code (csrc/filter_tail_core.h
through csrc/warp_emul.h, an emulated block of 64 threads) == fem_tpu's
generate_candidates on its slab path, which is how fem_tpu runs these
shapes. Integers only: exact equality.
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim
from fem_tpu.config import FemArgs
from fem_tpu.index.build import build_index
from fem_tpu.io import fastx
from fem_tpu.ops import types as jtypes
from fem_tpu.ops.candidates import generate_candidates as jgenerate
from fem_tpu.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu_torch.ops import types as ttypes
from fem_tpu_torch.ops.candidates import generate_candidates as tgenerate
from fem_tpu_torch.ops.filter_tail import KERNEL_NAMES, filter_tail, filter_tail_plain, plan
from tests.test_engine import _batch_from_reads
from test_torch_candidates import _host_tail, host_check  # noqa: F401 (fixture)
from test_torch_cases import WIDE_CASE_NAMES, WIDE_LANES, WIDE_SHAPES, wide_tail_cases

torch.set_num_threads(1)
SENT = ttypes.SENTINEL_SID


@pytest.mark.parametrize("cap,cc,route,threads,words", [
    (80, 16, 0, 32, 0), (432, 80, 0, 32, 0),  # a warp a lane
    (433, 80, 1, 256, 32 + 512 + 433 + 2 * 80 + 433),
    (640, 512, 1, 256, 3360),  # tier 1: 26,880 bytes, eight lanes an SM
    (2048, 1024, 1, 1024, 32 + 2048 + 2048 + 2 * 1024 + 2048),
    (5120, 4096, 1, 1024, 26_656),  # tier 2: 213,248 bytes of 232,448
    (8200, 64, 2, 1024, 32 + 16384 + 8200 + 2 * 64 + 8200),
    (9000, 64, 2, 1024, 32 + 16384 + 9000 + 2 * 64 + 9000),
    (20, 2000, 1, 256, 32 + 1010 + 1010 + 2 * 2000 + 20),  # the fold's int32 sizes S and V
])
def test_plan_routes(host_check, cap, cc, route, threads, words):
    """ft::plan through the host build: which program, block size and
    scratch a width takes on the card; the default tier 2 fits shared
    memory, the workspace widths do not."""
    got = plan(cap, cc, host_check)
    assert got == (route, threads, words)
    assert got.kernel == KERNEL_NAMES[route]
    assert got.in_shared_memory == (words * 8 <= 232_448)


@pytest.mark.parametrize("a", [0, 1, 2])
@pytest.mark.parametrize("shape_name", list(WIDE_SHAPES))
def test_kernel_lane_code_wide_slabs(host_check, shape_name, a):
    """The retry tiers' widths and the workspace path's: host build of the
    block lane code == plain version on valid counts 0, 1, 33, half and
    full, chains of gaps e and e + 1, a list that fills exactly, one that
    overflows by one key and a full list whose every key survivors displace.
    All cases go through one call."""
    shape = WIDE_SHAPES[shape_name]
    cases = wide_tail_cases(shape)
    sid_m = np.concatenate([cases[n][0] for n in WIDE_CASE_NAMES])
    diag_m = np.concatenate([cases[n][1] for n in WIDE_CASE_NAMES])
    CC, e = shape["CC"], shape["e"]
    got = _host_tail(host_check, sid_m, diag_m, CC, e, a)
    plain = filter_tail_plain(torch.from_numpy(sid_m), torch.from_numpy(diag_m), CC, e, a)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g, w.numpy())
    lanes = {n: slice(i * WIDE_LANES, (i + 1) * WIDE_LANES)
             for i, n in enumerate(WIDE_CASE_NAMES)}
    kept = (got[0] != SENT).sum(axis=1)
    assert not kept[lanes["count_0"]].any()
    if a == 0:
        one = kept[lanes["count_1"]]  # one key a group: 1 to G kept
        assert ((1 <= one) & (one <= shape["G"])).all()
        assert got[2][lanes["overflow_by_one"]].all()
        assert (kept[lanes["overflow_by_one"]] == CC).all()
        assert not got[2][lanes["fills_exactly"]].any()
        assert (kept[lanes["fills_exactly"]] == CC).all()
        assert (kept[lanes["gap_e_plus_1"]] == CC // 2).all()
        assert (kept[lanes["gap_e"]] == min(CC, min(shape["CAP"], 400) // 2)).all()
        ev = lanes["evicted"]
        n_ev = min(CC, shape["CAP"])
        assert (kept[ev] == n_ev).all() and not got[2][ev].any()
        first = diag_m[ev, 0][sid_m[ev, 0] != SENT].reshape(WIDE_LANES, n_ev)
        np.testing.assert_array_equal(got[1][ev, :n_ev], np.sort(first, axis=1) - 1)
    assert kept[lanes["count_full"]].all()


@pytest.fixture(scope="module")
def heavy_world():
    """A genome that is two fifths satellite arrays of 200 to 700 copies,
    and 12 reads on it (24 lanes): of 200 simulated reads the 9 whose seeds
    are most frequent (reads inside arrays: hundreds to thousands of
    occurrences a group) and the 3 whose seeds are rarest."""
    seqs = sim.satellite_genome(120_000, num_seqs=2, seed=61, satellite_fraction=0.4,
                                unit_range=(24, 60), copies_range=(200, 700))
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.fa")
        sim.write_fasta(p, seqs)
        ref = fastx.read_fasta(p)
    index = build_index(ref, 12, 3)
    reads = sim.simulate_reads(seqs, 200, read_length=100, max_errors=3, seed=62)
    codes = jnp.asarray(_batch_from_reads(reads).codes)
    freq = np.diff(index.lookup.astype(np.int64))[np.asarray(seed_hashes(codes, 12))[:, :89]]
    order = np.argsort(np.median(freq, axis=1), kind="stable")
    batch = _batch_from_reads([reads[i] for i in (*order[-9:], *order[:3])])
    return ref, index, batch


@pytest.mark.parametrize("cap_occ,cap_cand",
                         [(640, 512), (2048, 1024), (4096, 4096), (5120, 4096), (8200, 64)])
def test_generate_candidates_wide_matches_jax_slab_path(
        host_check, heavy_world, monkeypatch, cap_occ, cap_cand):
    """At tier shapes fem_tpu leaves its Pallas kernel for its slab path
    (use_kernel=False; cap_vote = cap_occ, so the vote slab never
    overflows): the port's one filter tail gives the same candidates on
    every lane that does not overflow, and the same overflow flags. The
    slabs the port's filter tail was handed go through the host build of
    the kernel's lane code too, which must equal the plain version."""
    from fem_tpu_torch.ops import candidates as tcand

    ref, index, batch = heavy_world
    args = FemArgs(error_threshold=3, num_additional_qgrams=1)
    jp = jtypes.FilterParams.from_args(args, batch.codes.shape[1], cap_occ=cap_occ,
                                       cap_cand=cap_cand, cap_vote=cap_occ)
    tp = ttypes.FilterParams.from_args(args, batch.codes.shape[1], cap_occ=cap_occ,
                                       cap_cand=cap_cand)
    codes, lengths = jnp.asarray(batch.codes), jnp.asarray(batch.lengths)
    both = jnp.concatenate([codes, reverse_complement(codes, lengths)])
    lens2 = jnp.concatenate([lengths, lengths])
    hashes = seed_hashes(both, jp.kmer_size)
    amb = ambiguous_base_counts(both, lens2, jp.kmer_size)
    want = jax.jit(functools.partial(jgenerate, params=jp, use_kernel=False))(
        both, lens2, hashes, amb, jtypes.device_index_from_host(index, ref)
    )
    seen = []
    monkeypatch.setattr(
        tcand, "filter_tail",
        lambda *a: seen.append((a, filter_tail(*a))) or seen[-1][1])
    t = lambda x: torch.tensor(np.asarray(x))
    got = tgenerate(t(both), t(lens2), t(hashes), t(amb),
                    ttypes.device_index_from_host(index, ref, "cpu"), tp)

    (sid_m, diag_m, cc, e, a), plain = seen[0]
    assert sid_m.shape[2] == cap_occ and cc == cap_cand
    host = _host_tail(host_check, sid_m.numpy(), diag_m.numpy(), cc, e, a)
    for h, w in zip(host, plain):
        np.testing.assert_array_equal(h, w.numpy())

    np.testing.assert_array_equal(got.needs_fallback.numpy(),
                                  np.asarray(want.needs_fallback))
    ok = ~got.needs_fallback.numpy()
    assert ok.any()
    for name in got._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy().astype(np.int64)[ok],
            np.asarray(getattr(want, name)).astype(np.int64)[ok], err_msg=name,
        )
    # The wide slabs are in real use: some group holds hundreds of keys.
    assert int((sid_m != SENT).sum(dim=2).max()) > 256
