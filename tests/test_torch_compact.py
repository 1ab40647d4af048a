"""The step's range filter and slab compactions (ops/compact.py): the
kernels' block code (csrc/compact_core.h, built for the host with g++ and
run through warp_emul.h, blocks in ticket order) and the plain torch
version, each against loops over lanes and slots from the rules alone
(tests/test_torch_cases.py: compact_reference), field for field: the
verify slab, each lane's count and offset, the totals, the accept slab,
each lane's `ok` and the reads' retry bits, and zeros past the totals.
Cases at tier 0's, tier 1's and tier 2's cap_cand."""

import ctypes
import shutil
import tempfile

import numpy as np
import pytest
import torch

from fem_tpu_torch import kernels
from fem_tpu_torch.ops.compact import (
    VerifySlab,
    accept_slab,
    accept_slab_plain,
    range_filter,
    verify_slab,
    verify_slab_plain,
)
from test_torch_cases import (
    COMPACT_CASE_NAMES,
    COMPACT_WIDTHS,
    compact_full_case,
    compact_index,
    compact_outputs,
    compact_reference,
)


@pytest.fixture(scope="module")
def host_check():
    """The kernels' header code built for the host. Skips only when g++ is
    absent; a compile error fails."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    with tempfile.TemporaryDirectory() as d:
        yield kernels.build_host_check(d)


def plain(c):
    """The plain version on case `c`, as numpy."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    v = verify_slab(t(c["cand_sid"]), t(c["cand_pos"]), t(c["lengths"]), compact_index(c),
                    c["e"], c["verify_cap"])
    a = accept_slab(v, t(c["accepted"]), t(c["ed"]), t(c["end"]), c["acc_cap"],
                    c["cand_sid"].shape[1])
    return compact_outputs(v, a)


def host(lib, c, threads=0):
    """The kernels' block code on case `c`, through the g++ build."""
    NB, cc = c["cand_sid"].shape
    cap, acap = c["verify_cap"], c["acc_cap"]
    vp = lambda x: None if x is None else x.ctypes.data_as(ctypes.c_void_p)
    vbuf = np.full(((3 * cap + 1) & ~1) + 2 * (NB + 1), -7, np.int32)  # the memset's to do
    num = np.full(NB, -7, np.int32)
    off = np.full(NB, -7, np.int64)
    total = np.full(1, -7, np.int64)
    assert lib.fem_host_verify_slab(
        vp(c["cand_sid"]), vp(c["cand_pos"]), vp(c["lengths"]), vp(c["ref_lengths"]),
        len(c["ref_lengths"]), vp(c["own_start"]), vp(c["own_end"]), NB, cc, c["e"], cap,
        vp(vbuf), vp(num), vp(off), vp(total), threads) == 0
    abuf = np.full(((5 * acap + 1) & ~1) + 2 * (NB + 1), -7, np.int32)
    ok = np.full(NB, 7, np.uint8)
    n_acc = np.full(1, -7, np.int64)
    accepted = c["accepted"].astype(np.uint8)
    assert lib.fem_host_accept_slab(
        vp(vbuf[:cap]), vp(vbuf[cap:]), vp(c["ed"]), vp(c["end"]), vp(accepted), vp(num),
        vp(off), NB, cc, cap, acap, vp(abuf), vp(ok), vp(n_acc), threads) == 0
    v, a = vbuf[: 3 * cap].reshape(3, cap), abuf[: 5 * acap].reshape(5, acap)
    return dict(v_sid=v[0], v_pos=v[1], v_lane=v[2], num_candidates=num, offset=off,
                total=total[0], a_lane=a[0], a_sid=a[1], a_pos=a[2], a_ed=a[3], a_end=a[4],
                n_accepted=n_acc[0], ok=ok.astype(bool))


def assert_matches_reference(got: dict, c: dict) -> dict:
    want = compact_reference(c)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)
    # Zeros past each total, as the scatters into zeroed slabs left them.
    used = min(want["total"], c["verify_cap"])
    kept = min(want["n_accepted"], c["acc_cap"])
    for k in ("v_sid", "v_pos", "v_lane"):
        assert not np.asarray(got[k])[used:].any(), k
    for k in ("a_lane", "a_sid", "a_pos", "a_ed", "a_end"):
        assert not np.asarray(got[k])[kept:].any(), k
    # The reads' retry bits: both strands' lanes whole, or the read again.
    B = len(want["ok"]) // 2
    retry = ~(np.asarray(got["ok"])[:B] & np.asarray(got["ok"])[B:])
    np.testing.assert_array_equal(retry, ~(want["ok"][:B] & want["ok"][B:]))
    return want


@pytest.mark.parametrize("cc", list(COMPACT_WIDTHS))
@pytest.mark.parametrize("name", COMPACT_CASE_NAMES)
def test_lane_code_and_plain_match_the_rules(host_check, name, cc):
    """Each case at tier 0's, tier 1's and tier 2's width, at the card's
    threads a lane (cpt::threads: a warp, 256, 1,024)."""
    c = compact_full_case(name, cc)
    want = assert_matches_reference(plain(c), c)
    assert_matches_reference(host(host_check, c), c)
    num, ok = want["num_candidates"], want["ok"]
    total, n_acc = want["total"], want["n_accepted"]
    if name == "all_empty":
        assert total == n_acc == 0 and ok.all()
    if name == "empty_lanes":
        assert (num == 0).any() and (num > 0).any()
    if name == "full_lane":
        assert num[1] > 0 and (c["cand_sid"][1] < 3).all()
    if name == "not_prefix":  # every lane drops a candidate between two it keeps
        valid = compact_reference(c)["num_candidates"] < (c["cand_sid"] < 3).sum(axis=1)
        assert valid.all()
    if name == "verify_cap_mid_lane":  # a lane cut by the verify cap: it and the rest retry
        assert total > c["verify_cap"] and ok.any() and not ok.all()
        lane = int(np.flatnonzero(~ok)[0])
        assert want["offset"][lane] < c["verify_cap"] < want["offset"][lane] + num[lane]
    if name == "acc_cap_mid_lane":
        assert n_acc > c["acc_cap"] and total <= c["verify_cap"] and not ok.all()
    if name == "shard":
        assert (num > 0).any()
        kept = want["v_pos"][: min(total, c["verify_cap"])] + c["e"]
        s = want["v_sid"][: len(kept)]
        assert ((kept >= c["own_start"][s]) & (kept < c["own_end"][s])).all()


@pytest.mark.parametrize("threads", [32, 64, 256])
def test_lane_code_any_team_size(host_check, threads):
    """The result does not depend on how many threads share a lane: the
    card takes a warp up to a width of 512, then 256 or 1,024; a team of a
    warp takes eight lanes to a block, so lanes cross blocks and the
    look-back adds the blocks' sums."""
    for name in ("random", "verify_cap_mid_lane", "acc_cap_mid_lane", "full_lane"):
        c = compact_full_case(name, 2048, NB=22, seed=threads)
        assert_matches_reference(host(host_check, c, threads), c)


def test_look_back_over_many_blocks(host_check):
    """300 lanes of a warp each: 38 blocks, more than the 32 a look-back
    step reads, each block's offset from the blocks before it."""
    c = compact_full_case("random", 256, NB=300, seed=4)
    assert_matches_reference(host(host_check, c), c)


def test_range_filter_is_the_slabs_predicate():
    """range_filter (generate_candidates' plain filter) keeps exactly what
    the verify slab holds, shifted by -e."""
    c = compact_full_case("not_prefix", 256)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    pos, valid, num = range_filter(t(c["cand_sid"]), t(c["cand_pos"]), t(c["lengths"]),
                                   compact_index(c), c["e"])
    want = compact_reference(c)
    np.testing.assert_array_equal(num.numpy(), want["num_candidates"])
    np.testing.assert_array_equal(pos[valid].numpy(), want["v_pos"][: int(valid.sum())])
    np.testing.assert_array_equal(pos[~valid].numpy(), c["cand_pos"][~valid.numpy()])


def test_wrappers_check_their_inputs():
    c = compact_full_case("random", 256)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    sid, pos, lens = t(c["cand_sid"]), t(c["cand_pos"]), t(c["lengths"])
    index = compact_index(c)
    with pytest.raises(TypeError, match="int32"):
        verify_slab(sid.long(), pos, lens, index, 5, 100)
    with pytest.raises(ValueError, match="one shape"):
        verify_slab(sid, pos[:, :8], lens, index, 5, 100)
    with pytest.raises(ValueError, match="lengths"):
        verify_slab(sid, pos, lens[:3], index, 5, 100)
    v = verify_slab(sid, pos, lens, index, 5, 100)  # CPU tensors: the plain version
    assert isinstance(v, VerifySlab) and v.sid.shape == (100,) and v.total.dim() == 0
    acc, ed, end = t(c["accepted"][:100]), t(c["ed"][:100]), t(c["end"][:100])
    with pytest.raises(TypeError, match="bool"):
        accept_slab(v, acc.int(), ed, end, 40, 256)
    with pytest.raises(ValueError, match="one"):
        accept_slab(v, acc[:50], ed, end, 40, 256)
    a = accept_slab(v, acc, ed, end, 40, 256)
    assert a.lane.shape == (40,) and a.ok.dtype == torch.bool
    assert verify_slab_plain(sid, pos, lens, index, 5, 100).total == v.total
    assert accept_slab_plain(v, acc, ed, end, 40).n_accepted == a.n_accepted
