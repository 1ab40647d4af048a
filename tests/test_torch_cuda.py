"""The port's CUDA kernels and engine on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs where only the port is installed:

    FEM_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(FEM_TPU_TEST_TPU=1 keeps tests/conftest.py from importing JAX.) Each
kernel is held against its plain torch version on the same CUDA tensors;
all outputs are integers and must be exactly equal.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from fem_tpu.golden.model import GoldenMapper
from fem_tpu_torch import kernels, sim
from fem_tpu_torch.core.encoding import encode
from fem_tpu_torch.io.fastx import ReadBatch
from fem_tpu_torch.ops.candidates import candidates_back, candidates_front
from fem_tpu_torch.ops.compact import (
    accept_slab,
    accept_slab_plain,
    range_filter,
    verify_slab,
    verify_slab_plain,
)
from fem_tpu_torch.ops.filter_tail import WORKSPACE_ROWS, filter_tail, filter_tail_plain, plan
from fem_tpu_torch.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu_torch.ops.occ_slab import occ_bound, occ_slab, occ_slab_plain
from fem_tpu_torch.ops.types import BIG, SENTINEL_SID, FilterParams, device_index_from_host
from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine, TierConfig
from fem_tpu_torch.stats import MappingStats
from test_torch_cases import (
    COMPACT_CASE_NAMES,
    COMPACT_WIDTHS,
    OCC_CASE_NAMES,
    OCC_WIDTHS,
    SWEEP_CAPS,
    SWEEP_CONFIGS,
    TAIL_CASE_NAMES,
    TAIL_SHAPE,
    WIDE_CASE_NAMES,
    WIDE_SHAPES,
    compact_full_case,
    compact_index,
    compact_outputs,
    compact_reference,
    occ_case,
    slot_case,
    tail_cases,
    wide_tail_cases,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _slabs(rng, NB, G, CAP, spread=40):
    """Clustered (sid, diag) slabs, 40% valid, invalid slots at the
    sentinel pair (the generator of tests/test_filter_kernel.py)."""
    sid = rng.integers(0, 3, (NB, G, CAP))
    diag = rng.integers(0, spread, (NB, G, CAP)) + rng.integers(0, 4, (NB, G, CAP))
    valid = rng.random((NB, G, CAP)) < 0.4
    return (torch.from_numpy(np.where(valid, sid, SENTINEL_SID).astype(np.int32)),
            torch.from_numpy(np.where(valid, diag, BIG).astype(np.int32)))


@pytest.mark.parametrize(
    "NB,G,CAP,CC,e,a",
    [(130, 3, 24, 8, 5, 1), (1000, 3, 80, 16, 5, 0), (1000, 3, 80, 16, 5, 2),
     (77, 2, 40, 8, 0, 1), (64, 3, 480, 32, 7, 1), (5, 1, 8, 4, 2, 0)],
)
def test_filter_tail_kernel_matches_plain(cuda, NB, G, CAP, CC, e, a):
    sid, diag = (x.to(cuda) for x in _slabs(np.random.default_rng(NB + CAP), NB, G, CAP))
    kernels.reset_launches()
    got = filter_tail(sid, diag, CC, e, a)
    torch.cuda.synchronize()
    assert kernels.launches["filter_tail"] == 1
    assert kernels.launches_by_shape()["filter_tail"] == {(CAP, CC): 1}
    for g, w in zip(got, filter_tail_plain(sid, diag, CC, e, a)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("a", [0, 1, 2])
@pytest.mark.parametrize("case", TAIL_CASE_NAMES)
def test_filter_tail_kernel_edges(cuda, case, a):
    """Valid counts 0..cap_occ around the 32-key register path, chains of
    gaps e and e + 1, overflow by exactly one (tests/test_torch_cases.py)."""
    sid, diag = (torch.from_numpy(x).to(cuda) for x in tail_cases(TAIL_SHAPE)[case])
    CC, e = TAIL_SHAPE["CC"], TAIL_SHAPE["e"]
    got = filter_tail(sid, diag, CC, e, a)
    torch.cuda.synchronize()
    for g, w in zip(got, filter_tail_plain(sid, diag, CC, e, a)):
        assert torch.equal(g, w)


def test_filter_tail_kernel_eviction(cuda):
    sid = torch.full((1, 2, 8), SENTINEL_SID, dtype=torch.int32)
    diag = torch.full((1, 2, 8), BIG, dtype=torch.int32)
    sid[0, 0, :2], diag[0, 0, :2] = 0, torch.tensor([10, 20], dtype=torch.int32)
    sid[0, 1, 0], diag[0, 1, 0] = 0, 16
    c_sid, c_pos, ovf = filter_tail(sid.to(cuda), diag.to(cuda), 4, 5, 0)
    assert c_sid.cpu().tolist() == [[0, 0, SENTINEL_SID, SENTINEL_SID]]
    assert c_pos.cpu().tolist() == [[10, 16, BIG, BIG]]
    assert not ovf.item()


@pytest.mark.parametrize("a", [0, 1, 2])
@pytest.mark.parametrize("shape_name", list(WIDE_SHAPES))
def test_filter_tail_kernel_wide_slabs(cuda, shape_name, a):
    """The retry tiers' widths (a block a lane, scratch in shared memory)
    and one whose scratch is a workspace: valid counts 0, 1, 33, half, full,
    chains, exact fill, overflow by one and a displaced full list."""
    shape = WIDE_SHAPES[shape_name]
    cases = wide_tail_cases(shape)
    sid, diag = (torch.from_numpy(np.concatenate([cases[n][i] for n in WIDE_CASE_NAMES]))
                 .to(cuda) for i in (0, 1))
    CC, e = shape["CC"], shape["e"]
    kernels.reset_launches()
    got = filter_tail(sid, diag, CC, e, a)
    torch.cuda.synchronize()
    assert kernels.launches["filter_tail"] == 1
    for g, w in zip(got, filter_tail_plain(sid, diag, CC, e, a)):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "NB,G,CAP,CC",
    [(1024, 3, 640, 512), (300, 2, 1500, 500), (128, 3, 4096, 4096),
     (128, 3, 5120, 4096), (256, 3, 2048, 1024), (700, 2, 9000, 64), (3, 1, 20000, 8)],
)
def test_filter_tail_kernel_wide_random(cuda, NB, G, CAP, CC):
    """Dense random slabs at the default ladder's shapes and at each block
    size the launcher picks (256 and 1024 threads a lane); the workspace
    widths with more lanes than workspace rows (700 > 132), so blocks walk
    over several lanes."""
    sid, diag = (x.to(cuda) for x in _slabs(np.random.default_rng(CAP), NB, G, CAP,
                                            spread=3 * CAP))
    got = filter_tail(sid, diag, CC, 5, 1)
    torch.cuda.synchronize()
    for g, w in zip(got, filter_tail_plain(sid, diag, CC, 5, 1)):
        assert torch.equal(g, w)


def test_filter_tail_plan_routes(cuda):
    """The kernel library's plan: a warp a lane up to 512, a block of 256
    threads up to 2048, 1024 above; the default tier 2 in shared memory."""
    assert plan(80, 16)[:2] == (0, 32)
    assert plan(640, 512)[:2] == (1, 256)
    assert plan(1500, 500)[:2] == (1, 256)
    assert plan(5120, 4096)[:2] == (1, 1024) and plan(5120, 4096).words * 8 == 213_248
    assert plan(9000, 64)[:2] == (2, 1024) and 700 > WORKSPACE_ROWS


def test_filter_tail_kernel_rejects_bad_input(cuda):
    sid, diag = (x.to(cuda) for x in _slabs(np.random.default_rng(1), 4, 3, 500))
    got = filter_tail(sid, diag, 16, 5, 1)  # 16 + 500 > 512: no width is refused
    for g, w in zip(got, filter_tail_plain(sid, diag, 16, 5, 1)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="contiguous"):
        filter_tail(sid.transpose(0, 1), diag.transpose(0, 1), 16, 5, 1)
    with pytest.raises(TypeError):
        filter_tail(sid.long(), diag, 8, 5, 1)


def _all_modes_equal(off, lfreq, start, lane_ok, occ, cap):
    """The kernel against the plain version on the same CUDA tensors, in
    each mode: own bound and slab, the bound alone, a given bound (the
    own one raised in every other group, -1 in the first). Returns the
    plain version's own-bound result."""
    kernels.reset_launches()
    got = occ_slab(off, lfreq, start, lane_ok, occ, cap)
    torch.cuda.synchronize()
    assert kernels.launches["occ_slab"] == 1
    assert kernels.launches_by_shape()["occ_slab"] == {(cap, off.shape[0]): 1}
    own = occ_slab_plain(off, lfreq, start, lane_ok, occ, cap)
    for g, w in zip(got, own):
        assert torch.equal(g, w)
    bound = occ_bound(off, lfreq, start, lane_ok, occ, cap)
    assert bound.sid is None and bound.diag is None
    assert torch.equal(bound.overflow_occ, own.overflow_occ)
    assert torch.equal(bound.tkey, own.tkey)
    reduced = own.tkey.clone()
    reduced.view(-1)[1::2] += 1 << 33
    reduced.view(-1)[0] = -1
    got = occ_slab(off, lfreq, start, lane_ok, occ, cap, tkey=reduced)
    torch.cuda.synchronize()
    want = occ_slab_plain(off, lfreq, start, lane_ok, occ, cap, tkey=reduced)
    assert torch.equal(got.sid, want.sid) and torch.equal(got.diag, want.diag)
    return own


@pytest.mark.parametrize("cap", OCC_WIDTHS)
@pytest.mark.parametrize("name", OCC_CASE_NAMES)
def test_occ_slab_kernel_matches_plain(cuda, name, cap):
    """The edge cases of tests/test_torch_occ_slab.py at tier 0's, tier 1's
    and tier 2's cap_occ (a warp an item, a block an item)."""
    c = {k: torch.from_numpy(v).to(cuda) for k, v in occ_case(name, cap, NB=40).items()}
    _all_modes_equal(c["off"], c["lfreq"], c["start"], c["lane_ok"], c["occ"], cap)


@pytest.mark.parametrize("tier,cap", [(0, 256), (1, 2048), (2, 16384)])
def test_occ_slab_kernel_on_the_main_paths_seed_tables(cuda, tmp_path, tier, cap):
    """The seed tables candidates_front builds on the card (satellite
    genome: long runs, groups over cap_occ at tier 0), each tier's
    cap_occ: the kernel's slabs, flags and bounds equal the plain
    version's, and what candidates_front holds is the kernel's."""
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.io import fastx

    seqs = sim.satellite_genome(300_000, num_seqs=2, seed=5, satellite_fraction=0.15)
    sim.write_fasta(str(tmp_path / "ref.fa"), seqs)
    ref = fastx.read_fasta(str(tmp_path / "ref.fa"))
    index = device_index_from_host(build_index(ref, 12, 3), ref, cuda)
    batch = _batch(sim.simulate_reads(seqs, 256, read_length=100, max_errors=5, seed=6))
    args = FemArgs(error_threshold=5, num_additional_qgrams=1)
    params = FilterParams.from_args(args, batch.codes.shape[1], cap_occ=cap, cap_cand=cap)
    codes = torch.from_numpy(batch.codes).to(cuda)
    lengths = torch.from_numpy(batch.lengths).to(cuda)
    both = torch.cat([codes, reverse_complement(codes, lengths)])
    lens2 = torch.cat([lengths, lengths])
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)
    front = candidates_front(both, lens2, hashes, amb, index, params)
    want = _all_modes_equal(front.off_s, front.lfreq_s, front.start_s, front.lane_ok,
                            index.occ, cap)
    assert torch.equal(front.sid, want.sid) and torch.equal(front.diag, want.diag)
    assert torch.equal(front.tkey, want.tkey)
    assert (want.sid != SENTINEL_SID).any()
    if tier == 0:
        assert want.overflow_occ.any()


def test_occ_slab_launches_equal_filter_tail_over_a_stream(cuda, tmp_path):
    """One card, a pipelined stream with a two-rung ladder: one occurrence
    slab launch a step, as many as the filter tail's, at each tier's width."""
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.io import fastx

    seqs = sim.satellite_genome(250_000, num_seqs=1, seed=17, satellite_fraction=0.15,
                                unit_range=(24, 120), copies_range=(48, 400))
    sim.write_fasta(str(tmp_path / "ref.fa"), seqs)
    ref = fastx.read_fasta(str(tmp_path / "ref.fa"))
    index = build_index(ref, kmer_size=12, step_size=3)
    args = FemArgs(error_threshold=3, num_additional_qgrams=1)
    reads = sim.simulate_reads(seqs, 192, read_length=100, max_errors=2, seed=19)
    engine = MappingEngine(
        args, ref, index,
        EngineConfig(batch_size=16, cap_occ=32, cap_cand=32, verify_per_read=4,
                     accept_per_read=2, tiers=TIERS),
    )
    kernels.reset_launches()
    batches = [_batch(reads[i : i + 16]) for i in range(0, 192, 16)]
    for _ in engine.map_stream(batches):
        pass
    assert engine.tier_dispatches > 0
    steps = 12 + engine.tier_dispatches
    assert kernels.launches["occ_slab"] == kernels.launches["filter_tail"] == steps
    by_cap = collections.Counter()
    for (cap, _), n in kernels.launches_by_shape()["occ_slab"].items():
        by_cap[cap] += n
    tail = collections.Counter()
    for (cap, _), n in kernels.launches_by_shape()["filter_tail"].items():
        tail[cap] += n
    assert by_cap == tail


def _compactions_equal(cand_sid, cand_pos, lens2, both, index, e, cap, acc_cap):
    """The verify-slab and accept kernels against the plain version on the
    same CUDA tensors, one launch each, Myers' kernel between them on
    `both`, the reads' codes both strands. Returns the plain version's
    slabs."""
    CC = cand_sid.shape[1]
    kernels.reset_launches()
    got = verify_slab(cand_sid, cand_pos, lens2, index, e, cap)
    want = verify_slab_plain(cand_sid, cand_pos, lens2, index, e, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    res = verify_candidates(index, got.sid, got.pos, got.lane, both, lens2, e, used=got.total)
    acc = accept_slab(got, res.accepted, res.edit_distance, res.end_offset, acc_cap, CC)
    acc_want = accept_slab_plain(want, res.accepted, res.edit_distance, res.end_offset,
                                 acc_cap)
    torch.cuda.synchronize()
    for g, w in zip(acc, acc_want):
        assert torch.equal(g, w)
    nb = cand_sid.shape[0]
    assert kernels.launches_by_shape()["verify_slab"] == {(CC, nb): 1}
    assert kernels.launches_by_shape()["accept_slab"] == {(CC, nb): 1}
    return want, acc_want


@pytest.mark.parametrize("cc", list(COMPACT_WIDTHS))
@pytest.mark.parametrize("name", COMPACT_CASE_NAMES)
def test_compaction_kernels_match_plain(cuda, name, cc):
    """The cases of tests/test_torch_compact.py at tier 0's, tier 1's and
    tier 2's cap_cand (a warp a lane, a block of 256, of 1,024): both
    kernels equal to the plain version and to the rules' loops, zeros
    past the totals included."""
    c = compact_full_case(name, cc)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    index = compact_index(c, cuda)
    kernels.reset_launches()
    v = verify_slab(t(c["cand_sid"]), t(c["cand_pos"]), t(c["lengths"]), index, c["e"],
                    c["verify_cap"])
    a = accept_slab(v, t(c["accepted"]), t(c["ed"]), t(c["end"]), c["acc_cap"], cc)
    torch.cuda.synchronize()
    assert kernels.launches["verify_slab"] == kernels.launches["accept_slab"] == 1
    got = compact_outputs(v, a)
    for k, w in compact_reference(c).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    plain_v = verify_slab_plain(t(c["cand_sid"]), t(c["cand_pos"]), t(c["lengths"]), index,
                                c["e"], c["verify_cap"])
    plain_a = accept_slab_plain(plain_v, t(c["accepted"]), t(c["ed"]), t(c["end"]),
                                c["acc_cap"])
    for g, w in zip(list(v) + list(a), list(plain_v) + list(plain_a)):
        assert torch.equal(g, w)


def _main_path_lists(cuda, tmp_path, cap, reads, index_shards=0):
    """The filter tail's lists on the card at cap_occ = cap_cand = cap, on
    a satellite genome (long runs, lanes over their caps): the whole
    index's, or with `index_shards` a middle cell's of a (1, n) grid (its
    own bound standing in for the reduced one). Returns (cand_sid,
    cand_pos, lens2, both, index, e)."""
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.parallel.sharded_index import build_sharded_index

    seqs = sim.satellite_genome(300_000, num_seqs=2, seed=5, satellite_fraction=0.15)
    sim.write_fasta(str(tmp_path / "ref.fa"), seqs)
    ref = fastx.read_fasta(str(tmp_path / "ref.fa"))
    host_index = build_index(ref, 12, 3)
    if index_shards:
        index = build_sharded_index(host_index, ref, index_shards).device_index(
            index_shards // 2, cuda)
    else:
        index = device_index_from_host(host_index, ref, cuda)
    batch = _batch(sim.simulate_reads(seqs, reads, read_length=100, max_errors=5, seed=6))
    args = FemArgs(error_threshold=5, num_additional_qgrams=1)
    params = FilterParams.from_args(args, batch.codes.shape[1], cap_occ=cap, cap_cand=cap)
    codes = torch.from_numpy(batch.codes).to(cuda)
    lengths = torch.from_numpy(batch.lengths).to(cuda)
    both = torch.cat([codes, reverse_complement(codes, lengths)])
    lens2 = torch.cat([lengths, lengths])
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)
    front = candidates_front(both, lens2, hashes, amb, index, params)
    tail = candidates_back(front, front.tkey, index, params)
    return tail.cand_sid, tail.cand_pos, lens2, both, index, 5


@pytest.mark.parametrize("tier,cap,reads", [(0, 256, 256), (1, 2048, 256), (2, 16384, 64)])
def test_compaction_kernels_on_the_main_paths_lists(cuda, tmp_path, tier, cap, reads):
    """The lists the filter tail writes on the card at each tier's width,
    through both kernels, with Myers between: equal to the plain version,
    with a verify cap that fits them all and one that cuts them, and an
    accept cap cut likewise."""
    cand_sid, cand_pos, lens2, both, index, e = _main_path_lists(cuda, tmp_path, cap, reads)
    total = int(range_filter(cand_sid, cand_pos, lens2, index, e)[2].sum())
    assert total > 0
    _, a = _compactions_equal(cand_sid, cand_pos, lens2, both, index, e, total + 5, total)
    assert a.ok.all() and 0 < int(a.n_accepted) <= total
    v, a = _compactions_equal(cand_sid, cand_pos, lens2, both, index, e, total // 2,
                              max(total // 8, 8))
    assert not v.num_candidates.eq(0).all() and a.ok.any() and not a.ok.all()


def test_compaction_kernels_on_an_index_grid_cell(cuda, tmp_path):
    """A middle cell of a (1, 4) grid on one card: the ownership predicate
    of its shard, at the cell's quarter of the verify slots."""
    cand_sid, cand_pos, lens2, both, index, e = _main_path_lists(cuda, tmp_path, 256, 256,
                                                                 index_shards=4)
    assert index.own_start is not None
    nb = cand_sid.shape[0]
    v, _ = _compactions_equal(cand_sid, cand_pos, lens2, both, index, e, 16 * nb // 4,
                              max(4 * nb // 4, 8))
    kept = v.pos[: int(v.total)].long() + e
    sid = v.sid[: int(v.total)].long()
    assert len(kept) > 0
    assert ((kept >= index.own_start[sid]) & (kept < index.own_end[sid])).all()


@pytest.mark.parametrize("e", [0, 2, 5, 7])
def test_myers_kernel_matches_plain(cuda, small_reference, small_index, e):
    """Reads copied from the reference with edits, plus out-of-range sids,
    lanes and positions and an empty read (clamped alike)."""
    _, ref = small_reference
    index = device_index_from_host(small_index, ref, cuda)
    rng = np.random.default_rng(600 + e)
    NB, Lmax, V = 300, 128, 2000
    lens = rng.integers(30, Lmax + 1, NB).astype(np.int32)
    lens[0] = 0
    both = rng.integers(0, 5, (NB, Lmax)).astype(np.uint8)
    v_lane = rng.integers(0, NB, V).astype(np.int32)
    v_sid = rng.integers(0, ref.num_seqs, V).astype(np.int32)
    v_pos = np.array([rng.integers(0, ref.lengths[s] - Lmax - 2 * e) for s in v_sid],
                     np.int32)
    for v in range(0, V, 2):
        off = int(ref.offsets[v_sid[v]]) + int(v_pos[v]) + e
        both[v_lane[v]] = ref.flat_codes[off : off + Lmax]
        for _ in range(rng.integers(0, e + 2)):
            both[v_lane[v], rng.integers(0, Lmax)] = rng.integers(0, 4)
    v_sid[1], v_lane[3], v_pos[5], v_pos[7] = 99, -2, -500, 2**30
    args = [torch.from_numpy(x).to(cuda) for x in (v_sid, v_pos, v_lane, both, lens)]
    kernels.reset_launches()
    got = verify_candidates(index, *args, e)
    torch.cuda.synchronize()
    assert kernels.launches["banded_myers"] == 1
    assert kernels.launches_by_shape()["banded_myers"] == {(V, NB): 1}
    want = verify_candidates_plain(index, *args, e)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want.accepted.any() and not want.accepted.all()


@pytest.mark.parametrize("used,Lmax", [(0, 128), (1, 128), (200, 128), (400, 128),
                                       (400, 100), (400, 40), (400, 160), (400, 256)])
@pytest.mark.parametrize("e", [0, 2, 5, 7])
def test_myers_kernel_edges(cuda, small_reference, small_index, e, used, Lmax):
    """Windows into the gap and past the array's ends, reads with N, rows
    off a 16-byte boundary, `used` of the 400 slots in use, and full-width
    reads across five and eight 32-base chunks (Lmax 160, 256)."""
    _, ref = small_reference
    index = device_index_from_host(small_index, ref, cuda)
    args = [torch.from_numpy(x).to(cuda) for x in slot_case(ref, e, Lmax, 700 + 10 * e + Lmax)]
    n_used = torch.tensor(used, device=cuda)
    got = verify_candidates(index, *args, e, used=n_used)
    torch.cuda.synchronize()
    want = verify_candidates_plain(index, *args, e, used=n_used)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got.accepted[used:].any()


def test_engine_defaults_to_cuda(cuda, small_reference, small_index, default_args):
    _, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index, EngineConfig(batch_size=8))
    assert engine.device.type == "cuda"


def _batch(reads):
    lengths = np.array([len(r.seq) for r in reads], np.int32)
    codes = np.full((len(reads), max(128, -(-int(lengths.max()) // 32) * 32)), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r.seq)] = encode(r.seq)
    return ReadBatch([r.name for r in reads], [r.seq for r in reads],
                     [r.qual for r in reads], codes, lengths)


def test_engine_on_cuda_matches_golden(cuda, small_reference, small_index, default_args):
    seqs, ref = small_reference
    engine = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=64, cap_occ=80, cap_cand=16, verify_per_read=4),
        device=cuda,
    )
    golden = GoldenMapper(default_args, ref, small_index)
    reads = sim.simulate_reads(seqs, 64, read_length=100, max_errors=2, seed=35)
    batch = _batch(reads)
    grecs, gstats = golden.map_reads(batch.names, batch.seqs, batch.quals)
    # The first dispatch of the (tier 0, Lmax 128) step runs eagerly and is
    # then captured into a CUDA graph; the second replays the graph. Each
    # launches each kernel once, and a replay counts what the capture
    # recorded.
    for _ in range(2):
        kernels.reset_launches()
        recs, stats = engine.map_batch(batch)
        assert b"".join(recs) == b"".join(grecs)
        assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)
        assert kernels.launches == {"banded_myers": 1, "filter_tail": 1, "occ_slab": 1,
                                    "verify_slab": 1, "accept_slab": 1}
    prog = engine.programs[0, 128]
    assert prog.captured and prog.replays == 1
    shapes = kernels.launches_by_shape()
    assert shapes["banded_myers"] == {(64 * 2 * 4, 128): 1}
    assert shapes["verify_slab"] == shapes["accept_slab"] == {(16, 128): 1}


def test_eager_step_on_cuda_equals_graph(cuda, small_reference, small_index, default_args):
    """engine.eager_step runs the step eagerly on the card; a short batch is
    padded either way."""
    seqs, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=64, cap_occ=80, cap_cand=16,
                                        verify_per_read=4), device=cuda)
    batch = _batch(sim.simulate_reads(seqs, 50, read_length=100, max_errors=2, seed=37))
    graphs = [engine.map_batch(batch) for _ in range(3)]
    engine.eager_step = True
    eager = engine.map_batch(batch)
    assert all(g == eager for g in graphs)
    assert engine.programs[0, 128].replays == 2


@pytest.mark.parametrize("n", [48, 40], ids=["full", "short"])
@pytest.mark.parametrize("name", list(SWEEP_CONFIGS))
def test_sweep_config_on_cuda_matches_golden(cuda, tmp_path, name, n):
    """The parameter sweep (tests/test_torch_config_matrix.py) through the
    step graphs: the first dispatch eager, the second a replay; both equal
    to the golden oracle in bytes and counters."""
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.io import fastx

    k, step, e, a, read_len, max_errors = SWEEP_CONFIGS[name]
    seqs = sim.random_genome(150_000, num_seqs=2, seed=23, repeat_fraction=0.2)
    sim.write_fasta(str(tmp_path / "ref.fa"), seqs)
    ref = fastx.read_fasta(str(tmp_path / "ref.fa"))
    index = build_index(ref, k, step)
    reads = sim.simulate_reads(seqs, 48, read_length=read_len, max_errors=max_errors,
                               seed=24)[:n]
    args = FemArgs(kmer_size=k, step_size=step, error_threshold=e, num_additional_qgrams=a)
    engine = MappingEngine(args, ref, index, EngineConfig(**SWEEP_CAPS), device=cuda)
    batch = _batch(reads)
    grecs, gstats = GoldenMapper(args, ref, index).map_reads(
        batch.names, batch.seqs, batch.quals)
    for _ in range(2):
        recs, stats = engine.map_batch(batch)
        assert b"".join(recs) == b"".join(grecs)
        assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)
    assert all(p.captured for p in engine.programs.values())
    assert engine.programs[0, batch.codes.shape[1]].replays == 1


TIERS = (
    TierConfig(batch_size=16, cap_occ=256, cap_cand=256,
               verify_per_read=64, accept_per_read=32),
    TierConfig(batch_size=8, cap_occ=2048, cap_cand=1024,
               verify_per_read=512, accept_per_read=128),
)


@pytest.mark.parametrize("ordered", [False, True])
def test_pipelined_engine_with_tiers_on_cuda_matches_golden(cuda, tmp_path, ordered):
    """The pipelined stream with a two-rung ladder on a satellite genome
    (tests/test_torch_stream.py's world) on the card: record set and
    counters equal to golden, bytes too when ordered; the filter tail ran
    at every tier's width."""
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.io import fastx

    seqs = sim.satellite_genome(250_000, num_seqs=1, seed=17, satellite_fraction=0.15,
                                unit_range=(24, 120), copies_range=(48, 400))
    sim.write_fasta(str(tmp_path / "ref.fa"), seqs)
    ref = fastx.read_fasta(str(tmp_path / "ref.fa"))
    index = build_index(ref, kmer_size=12, step_size=3)
    args = FemArgs(error_threshold=3, num_additional_qgrams=1)
    reads = sim.simulate_reads(seqs, 96, read_length=100, max_errors=2, seed=18)
    engine = MappingEngine(
        args, ref, index,
        EngineConfig(batch_size=16, cap_occ=32, cap_cand=32, verify_per_read=4,
                     accept_per_read=2, tiers=TIERS),
    )
    kernels.reset_launches()
    recs, total = [], MappingStats()
    batches = [_batch(reads[i : i + 16]) for i in range(0, 96, 16)]
    for r, st in engine.map_stream(batches, ordered=ordered):
        recs.extend(r)
        total += st
    grecs, gstats = GoldenMapper(args, ref, index).map_reads(
        [r.name for r in reads], [r.seq for r in reads], [r.qual for r in reads])
    lines = lambda chunks: sorted(x for c in chunks for x in c.splitlines())
    assert lines(recs) == lines(grecs)
    if ordered:
        assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(total) == dataclasses.asdict(gstats)
    assert engine.retried_reads > 0 and engine.tier_dispatches > 0
    assert engine.watermark_reads == engine.consumed_reads == 96
    assert kernels.launches["filter_tail"] == 6 + engine.tier_dispatches
    tail_shapes = kernels.launches_by_shape()["filter_tail"]
    assert tail_shapes[(32, 32)] == 6
    assert sum(tail_shapes.get((t.cap_occ, t.cap_cand), 0) for t in TIERS) == engine.tier_dispatches


@pytest.mark.parametrize("grid", ["data_2", "index_1x2", "index_2x2"])
def test_grid_on_cuda_matches_golden(cuda, small_reference, small_index, default_args, grid):
    """Grids whose every cell is this card (parallel/): a data grid of 2,
    and coordinate-sharded (data, index) grids; each cell launches both
    kernels once a batch."""
    from fem_tpu_torch.parallel.mesh import make_index_mesh, make_mesh

    seqs, ref = small_reference
    devs = ["cuda:0"] * (2 if grid == "data_2" else int(grid[-3]) * int(grid[-1]))
    kw = ({"mesh": make_mesh(devs)} if grid == "data_2"
          else {"index_mesh": make_index_mesh(devs, int(grid[-1]))})
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=64, cap_occ=80, cap_cand=16,
                                        verify_per_read=8, **kw))
    reads = sim.simulate_reads(seqs, 64, read_length=100, max_errors=2, seed=36)
    reads[0] = sim.SimulatedRead(b"rep", seqs[0][1][10_060:10_160], b"I" * 100, 0, 10_060, 0, 0)
    batch = _batch(reads)
    kernels.reset_launches()
    recs, stats = engine.map_batch(batch)
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)
    cells = len(devs)
    assert kernels.launches["filter_tail"] >= cells and kernels.launches["banded_myers"] >= cells


@pytest.mark.parametrize("grid", ["data_2", "index_1x2", "index_2x2"])
def test_grid_program_on_cuda_replays(cuda, small_reference, small_index, default_args, grid):
    """A grid's GridProgram on the card: the key's first dispatch eager,
    then every cell's segments captured (one a cell on a data grid, three
    on an index grid); later dispatches replay them, a short batch too,
    and count each cell's kernels once a replay; the eager step gives the
    same bytes."""
    from fem_tpu_torch.parallel.mesh import make_index_mesh, make_mesh

    seqs, ref = small_reference
    devs = ["cuda:0"] * (2 if grid == "data_2" else int(grid[-3]) * int(grid[-1]))
    kw = ({"mesh": make_mesh(devs)} if grid == "data_2"
          else {"index_mesh": make_index_mesh(devs, int(grid[-1]))})
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=64, cap_occ=80, cap_cand=16,
                                        verify_per_read=8, tiers=(), **kw))
    reads = sim.simulate_reads(seqs, 64, read_length=100, max_errors=2, seed=38)
    full, short = _batch(reads), _batch(reads[:41])
    want = [engine.map_batch(b) for b in (full, short)]  # eager, then the first replay
    kernels.reset_launches()
    got = [engine.map_batch(b) for b in (full, short)]
    assert got == want
    prog = engine.programs[0, 128]
    assert (prog.dispatches, prog.replays) == (4, 3)
    segments = 1 if grid == "data_2" else 3
    assert len(prog.cells) == len(devs)
    assert all(len(c.graphs) == segments and c.pool_bytes > 0 for c in prog.cells)
    # An index grid's cell writes its slab in two launches around the
    # bound's reduction over the shards, a whole index's in one.
    assert kernels.launches == {"filter_tail": 2 * len(devs), "banded_myers": 2 * len(devs),
                                "occ_slab": 2 * len(devs) * (1 if grid == "data_2" else 2),
                                "verify_slab": 2 * len(devs), "accept_slab": 2 * len(devs)}
    engine.eager_step = True
    assert [engine.map_batch(b) for b in (full, short)] == want
    assert prog.replays == 3
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        short.names, short.seqs, short.quals)
    assert b"".join(want[1][0]) == b"".join(grecs)
    assert dataclasses.asdict(want[1][1]) == dataclasses.asdict(gstats)


def test_span_encloses_its_kernel_on_the_profiler_clock(cuda):
    """The program's spans and torch.profiler's device events share one
    clock: a span around a synchronized filter-tail launch encloses that
    kernel's interval in the same trace. Prints the kernel's start after
    the span's start and the span's end after the kernel's end, in us."""
    from torch.profiler import ProfilerActivity, profile

    from fem_tpu_torch.utils import metrics

    sid, diag = (x.to(cuda) for x in _slabs(np.random.default_rng(7), 32768, 3, 80))
    filter_tail(sid, diag, 16, 5, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics.tracing(True)
        try:
            for k in range(5):
                with metrics.span("fem::probe", batch=k):
                    filter_tail(sid, diag, 16, 5, 1)
                    torch.cuda.synchronize()
        finally:
            metrics.tracing(False)
    spans = sorted((r for r in metrics.take_spans()["records"] if r["name"] == "fem::probe"),
                   key=lambda r: r["start_ns"])
    kern = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if "cpu" not in str(e.device_type()).lower() and "filter_tail" in e.name())
    assert len(spans) == len(kern) == 5
    lead = [(k0 - s["start_ns"]) / 1e3 for s, (k0, _) in zip(spans, kern)]
    tail = [(s["end_ns"] - k1) / 1e3 for s, (_, k1) in zip(spans, kern)]
    print(f"[clock] {torch.cuda.get_device_name(0)}: kernel start - span start {lead} us; "
          f"span end - kernel end {tail} us; kernel {[(b - a) / 1e3 for a, b in kern]} us")
    assert min(lead) > 0 and min(tail) > 0
