"""Candidate generation and the filter tail of the port against fem_tpu.

The plain filter tail is held against fem_tpu's scalar model of the fold
and its Pallas kernel (interpreted); the kernel's per-lane header code
(csrc/filter_tail_core.h, built for the host with g++) against the plain
version; generate_candidates against fem_tpu's on every field.
"""

import functools
import os
import shutil
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
from fem_tpu.ops.filter_tail_pallas import filter_tail_pallas
from fem_tpu.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu_torch import kernels
from fem_tpu_torch.ops import types as ttypes
from fem_tpu_torch.ops.candidates import generate_candidates as tgenerate
from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain
from tests.test_engine import _batch_from_reads
from tests.test_filter_kernel import _random_slabs, _scalar_tail
from test_torch_cases import (
    PALLAS_SHAPE,
    TAIL_CASE_NAMES,
    TAIL_SHAPE,
    tail_cases,
)

torch.set_num_threads(1)
SENT, BIG = ttypes.SENTINEL_SID, ttypes.BIG


def _masked(sid, diag, valid):
    return (np.where(valid, sid, SENT).astype(np.int32),
            np.where(valid, diag, BIG).astype(np.int32))


def _lists(c_sid, c_pos):
    return [
        [(int(s), int(p)) for s, p in zip(c_sid[b], c_pos[b]) if s != SENT]
        for b in range(c_sid.shape[0])
    ]


@pytest.mark.parametrize("a", [0, 1, 2])
@pytest.mark.parametrize("e", [2, 5, 7])
def test_plain_tail_matches_scalar_fold(a, e):
    rng = np.random.default_rng(2000 + 10 * a + e)
    NB, G, CAP, CC = 130, 3, 24, 8
    sid, diag, valid = _random_slabs(rng, NB, G, CAP)
    c_sid, c_pos, ovf = filter_tail(
        *(torch.from_numpy(x) for x in _masked(sid, diag, valid)), CC, e, a
    )
    cands, ov = _scalar_tail(sid, diag, valid, CC, e, a)
    assert _lists(c_sid.numpy(), c_pos.numpy()) == cands
    np.testing.assert_array_equal(ovf.numpy(), ov)
    tail = c_sid.numpy() == SENT  # tail slots carry the sentinel pair
    assert (c_pos.numpy()[tail] == BIG).all()
    assert any(cands)


def test_plain_tail_eviction_across_groups():
    """A later group's smaller position evicts an earlier kept candidate."""
    sid = np.zeros((1, 2, 8), np.int32)
    diag = np.full((1, 2, 8), BIG, np.int32)
    valid = np.zeros((1, 2, 8), bool)
    diag[0, 0, :2] = [10, 20]
    valid[0, 0, :2] = True
    diag[0, 1, 0] = 16
    valid[0, 1, 0] = True
    c_sid, c_pos, _ = filter_tail(
        *(torch.from_numpy(x) for x in _masked(sid, diag, valid)), 4, 5, 0
    )
    assert _lists(c_sid.numpy(), c_pos.numpy())[0] == [(0, 10), (0, 16)]


def test_plain_tail_matches_pallas_interpreted():
    rng = np.random.default_rng(2100)
    NB, G, CAP, CC, e, a = 96, 1, 24, 8, 5, 1
    sid, diag, valid = _random_slabs(rng, NB, G, CAP)
    sid_m, diag_m = _masked(sid, diag, valid)
    want = filter_tail_pallas(sid_m, diag_m, CC, e, a, interpret=True)
    got = filter_tail_plain(torch.from_numpy(sid_m), torch.from_numpy(diag_m), CC, e, a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def host_check():
    """The kernels' header code built for the host. Skips only when g++ is
    absent; a compile error fails."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    with tempfile.TemporaryDirectory() as d:
        yield kernels.build_host_check(d)


# Threads of an emulated block lane (widths above 512); the card runs 256
# or 1024 (ops/filter_tail.py:plan), the arithmetic is the same at any
# multiple of 32, and fewer threads emulate faster.
HOST_BLOCK_THREADS = 64


def _host_tail(host_check, sid_m, diag_m, CC, e, a, threads=HOST_BLOCK_THREADS):
    """The g++ build of the kernel's lane code on masked (NB, G, CAP) slabs:
    a warp a lane up to CC + CAP = 512, a block of `threads` above."""
    import ctypes

    NB, G, CAP = sid_m.shape
    sid_m, diag_m = np.ascontiguousarray(sid_m), np.ascontiguousarray(diag_m)
    out_sid = np.empty((NB, CC), np.int32)
    out_pos = np.empty((NB, CC), np.int32)
    ovf = np.empty(NB, np.uint8)
    vp = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    rc = host_check.fem_host_filter_tail(
        vp(sid_m), vp(diag_m), NB, G, CAP, CC, e, a, vp(out_sid), vp(out_pos), vp(ovf),
        threads,
    )
    assert rc == 0
    return out_sid, out_pos, ovf.astype(bool)


@pytest.mark.parametrize(
    "NB,G,CAP,CC,e,a",
    [(97, 3, 24, 8, 5, 1), (64, 3, 80, 16, 5, 2), (40, 2, 40, 8, 0, 0),
     (16, 3, 480, 32, 7, 1)],  # last: cap_cand + cap_occ = 512
)
def test_kernel_lane_code_matches_plain(host_check, NB, G, CAP, CC, e, a):
    rng = np.random.default_rng(NB * 7 + CAP)
    sid, diag, valid = _random_slabs(rng, NB, G, CAP, spread=CAP)
    sid_m, diag_m = _masked(sid, diag, valid)
    got = _host_tail(host_check, sid_m, diag_m, CC, e, a)
    want = filter_tail_plain(torch.from_numpy(sid_m), torch.from_numpy(diag_m), CC, e, a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_kernel_lane_code_unaligned_slab(host_check):
    """cap_occ not a multiple of 4: the scalar loads, same result."""
    rng = np.random.default_rng(77)
    sid, diag, valid = _random_slabs(rng, 30, 2, 50, spread=50)
    sid_m, diag_m = _masked(sid, diag, valid)
    got = _host_tail(host_check, sid_m, diag_m, 8, 5, 1)
    want = filter_tail_plain(torch.from_numpy(sid_m), torch.from_numpy(diag_m), 8, 5, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("a", [0, 1, 2])
@pytest.mark.parametrize("case", TAIL_CASE_NAMES)
def test_kernel_lane_code_edges(host_check, case, a):
    """Host build of the kernel's lane code == plain version == fem_tpu's
    scalar model of the fold, exactly, on every lane of the edge cases."""
    sid_m, diag_m = tail_cases(TAIL_SHAPE)[case]
    CC, e = TAIL_SHAPE["CC"], TAIL_SHAPE["e"]
    got = _host_tail(host_check, sid_m, diag_m, CC, e, a)
    plain = filter_tail_plain(torch.from_numpy(sid_m), torch.from_numpy(diag_m), CC, e, a)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g, w.numpy())
    cands, ov = _scalar_tail(sid_m, diag_m, sid_m != SENT, CC, e, a)
    assert _lists(got[0], got[1]) == cands
    np.testing.assert_array_equal(got[2], ov)
    if case == "overflow_by_one" and a == 0:
        assert got[2].all() and (got[0] != SENT).all()
    if case == "fills_exactly" and a == 0:
        assert not got[2].any() and (got[0] != SENT).all()
    if case == "gap_e_plus_1" and a == 0:
        assert ((got[0] != SENT).sum(axis=1) == 15).all()


@functools.lru_cache(maxsize=None)
def _pallas_on_cases():
    """fem_tpu's Pallas kernel (interpreted) on all cases' lanes in one call."""
    cases = tail_cases(PALLAS_SHAPE)
    sid = np.concatenate([c[0] for c in cases.values()])
    diag = np.concatenate([c[1] for c in cases.values()])
    out = filter_tail_pallas(sid, diag, PALLAS_SHAPE["CC"], PALLAS_SHAPE["e"], 1,
                             interpret=True)
    out = [np.asarray(x) for x in out]
    res, o = {}, 0
    for name, c in cases.items():
        n = c[0].shape[0]
        res[name] = [x[o : o + n] for x in out]
        o += n
    return res


@pytest.mark.parametrize("case", TAIL_CASE_NAMES)
def test_kernel_lane_code_edges_match_pallas(host_check, case):
    sid_m, diag_m = tail_cases(PALLAS_SHAPE)[case]
    got = _host_tail(host_check, sid_m, diag_m, PALLAS_SHAPE["CC"], PALLAS_SHAPE["e"], 1)
    for g, w in zip(got, _pallas_on_cases()[case]):
        np.testing.assert_array_equal(g, w)


def test_generate_candidates_matches_jax_kernel_path():
    """Every output field equal to fem_tpu's with the filter-tail kernel
    (interpreted), on a satellite genome whose heavy seeds overflow the
    slabs, so both fallback flags are exercised."""
    seqs = sim.satellite_genome(60_000, num_seqs=2, seed=51, satellite_fraction=0.05)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.fa")
        sim.write_fasta(p, seqs)
        ref = fastx.read_fasta(p)
    index = build_index(ref, 12, 3)
    reads = sim.simulate_reads(seqs, 60, read_length=100, max_errors=5, seed=52)
    batch = _batch_from_reads(reads)
    batch.codes[3, 30:34] = 4  # four Ns: still mappable at e=5
    batch.lengths[5] = 40  # a short read
    args = FemArgs(error_threshold=5, num_additional_qgrams=1)
    caps = dict(cap_occ=24, cap_cand=8)
    jp = jtypes.FilterParams.from_args(args, batch.codes.shape[1], **caps)
    tp = ttypes.FilterParams.from_args(args, batch.codes.shape[1], **caps)

    codes, lengths = jnp.asarray(batch.codes), jnp.asarray(batch.lengths)
    both = jnp.concatenate([codes, reverse_complement(codes, lengths)])
    lens2 = jnp.concatenate([lengths, lengths])
    hashes = seed_hashes(both, jp.kmer_size)
    amb = ambiguous_base_counts(both, lens2, jp.kmer_size)
    want = jax.jit(functools.partial(jgenerate, params=jp, use_kernel=True))(
        both, lens2, hashes, amb, jtypes.device_index_from_host(index, ref)
    )
    t = lambda x: torch.tensor(np.asarray(x))
    got = tgenerate(t(both), t(lens2), t(hashes), t(amb),
                    ttypes.device_index_from_host(index, ref, "cpu"), tp)
    for name in got._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy().astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64), err_msg=name,
        )
    assert got.needs_fallback.any() and got.cand_valid.any()
