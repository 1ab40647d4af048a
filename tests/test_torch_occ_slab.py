"""The occurrence slab's kernel code (csrc/occ_slab_core.h, built for the
host with g++ and run through warp_emul.h) against its plain torch version
(ops/occ_slab.py), element for element: both int32 slabs, the overflow
flags and the truncation bound, in each of the kernel's three modes, at
tier 0's, tier 1's and tier 2's cap_occ."""

import ctypes
import shutil
import tempfile

import numpy as np
import pytest
import torch

from fem_tpu_torch import kernels
from fem_tpu_torch.ops.occ_slab import occ_bound, occ_slab, occ_slab_plain
from fem_tpu_torch.ops.types import BIG, SENTINEL_SID
from test_torch_cases import OCC_CASE_NAMES, OCC_WIDTHS, occ_case

OWN, BOUND_ONLY, GIVEN = 0, 1, 2


@pytest.fixture(scope="module")
def host_check():
    """The kernels' header code built for the host. Skips only when g++ is
    absent; a compile error fails."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    with tempfile.TemporaryDirectory() as d:
        yield kernels.build_host_check(d)


def _host_slab(host_check, c, cap, mode, tkey=None, threads=0, shift=0):
    """The g++ build on case `c`; `shift` adds to every CSR offset and
    moves the occurrence table's base back by as many entries, so the code
    reads the same occurrences at offsets `shift` higher."""
    NB, G, S = c["off"].shape
    off = np.ascontiguousarray(c["off"] + shift)
    sid = np.zeros((NB, G, cap), np.int32)
    diag = np.zeros((NB, G, cap), np.int32)
    overflow = np.zeros((NB, G), np.uint8)
    tkey_out = np.zeros((NB, G, 1), np.int64)
    lane_ok = c["lane_ok"].astype(np.uint8)
    occ = c["occ"]
    vp = lambda x: None if x is None else x.ctypes.data_as(ctypes.c_void_p)
    slab = mode != BOUND_ONLY
    rc = host_check.fem_host_occ_slab(
        vp(off), vp(c["lfreq"]), vp(c["start"]), vp(lane_ok),
        ctypes.c_void_p(occ.ctypes.data - 8 * shift), occ.shape[0] + shift,
        NB * G, S, cap, mode, vp(tkey), vp(sid) if slab else None,
        vp(diag) if slab else None, None if mode == GIVEN else vp(overflow),
        None if mode == GIVEN else vp(tkey_out), threads,
    )
    assert rc == 0
    return sid, diag, overflow.astype(bool), tkey_out


def _plain(c, cap, tkey=None):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return occ_slab_plain(t(c["off"]), t(c["lfreq"]), t(c["start"]), t(c["lane_ok"]),
                          t(c["occ"]), cap, None if tkey is None else t(tkey))


def _assert_equal(got, want):
    g_sid, g_diag, g_ovf, g_key = got
    if want.sid is not None:
        np.testing.assert_array_equal(g_sid, want.sid.numpy())
        np.testing.assert_array_equal(g_diag, want.diag.numpy())
    if want.overflow_occ is not None:
        np.testing.assert_array_equal(g_ovf, want.overflow_occ.numpy())
        np.testing.assert_array_equal(g_key, want.tkey.numpy())


@pytest.mark.parametrize("cap", OCC_WIDTHS)
@pytest.mark.parametrize("name", OCC_CASE_NAMES)
def test_lane_code_matches_plain(host_check, name, cap):
    """Own bound and slab (one launch a step on a whole index) and the
    bound alone (a shard's first launch)."""
    c = occ_case(name, cap)
    want = _plain(c, cap)
    _assert_equal(_host_slab(host_check, c, cap, OWN), want)
    _, _, ovf, key = _host_slab(host_check, c, cap, BOUND_ONLY)
    np.testing.assert_array_equal(ovf, want.overflow_occ.numpy())
    np.testing.assert_array_equal(key, want.tkey.numpy())
    valid = want.sid.numpy() != SENTINEL_SID
    assert ((want.diag.numpy() == BIG) == ~valid).all()
    if name == "lane_off":
        assert not valid[1:].any() and (key[1:] == -1).all()
    if name in ("run_cap", "run_cap_plus_1"):  # lane 0's run fills cap_occ, or passes it
        assert ovf[0].all() == (name == "run_cap_plus_1") and ovf[0].any() == ovf[0].all()
    if name in ("demand_cap", "demand_cap_plus_1"):
        assert ovf.all() == (name == "demand_cap_plus_1") and ovf.any() == ovf.all()
    if name == "before_read_offset":  # some occurrences kept, some dropped
        assert 0 < valid.sum() < (c["lfreq"] * c["lane_ok"][..., None]).sum()


@pytest.mark.parametrize("cap", OCC_WIDTHS)
@pytest.mark.parametrize("name", ["random", "tie", "run_cap_plus_1", "empty_runs"])
def test_lane_code_given_bound_matches_plain(host_check, name, cap):
    """The slab at a bound reduced over index shards (a shard's second
    launch): this item's own bound, raised by another shard's or not, and
    -1 where no shard has one."""
    c = occ_case(name, cap)
    own = _plain(c, cap).tkey.numpy()
    rng = np.random.default_rng(cap)
    other = np.where(rng.random(own.shape) < 0.5, own + rng.integers(0, 1 << 33, own.shape),
                     own)
    reduced = np.maximum(own, other)
    reduced[0, 0] = -1
    want = _plain(c, cap, tkey=reduced)
    got = _host_slab(host_check, c, cap, GIVEN, tkey=np.ascontiguousarray(reduced))
    _assert_equal(got, want)
    if name == "tie":  # a last-seed key equal to the bound is kept, one past it dropped
        kept = want.sid.numpy()[1:, :, :] != SENTINEL_SID
        assert kept.any()


def test_tie_keeps_the_bound_drops_one_past(host_check):
    """src/filter.c:85: the last seed keeps a key equal to the largest of
    the others' and drops one a diagonal further."""
    cap = 256
    c = occ_case("tie", cap)
    got = sid, diag, _, key = _host_slab(host_check, c, cap, OWN)
    NB, G, _ = c["off"].shape
    assert (key[..., 0] == (1 << 32) | 100).all()
    for b in range(NB):
        for g in range(G):
            d = diag[b, g][sid[b, g] == 1]  # seed 0's 100, and the last seed's
            assert (d == 100).sum() == 1 + ((b + g) % 2 == 0) and 101 not in d
    _assert_equal(got, _plain(c, cap))


@pytest.mark.parametrize("S", [1, 2, 10])
def test_lane_code_other_seed_counts(host_check, S):
    """One seed (no other seed: bound -1, the last seed drops all), two,
    and e = 7 with a = 2's ten."""
    for name in ("random", "mid_row", "empty_runs"):
        c = occ_case(name, 256, S=S)
        _assert_equal(_host_slab(host_check, c, 256, OWN), _plain(c, 256))


@pytest.mark.parametrize("cap", [256, 2048])
def test_lane_code_offsets_past_2_31(host_check, cap):
    """CSR offsets above 2^31 (GRCh38's 999,999,915 occurrences sit near
    it): the same occurrences read at offsets 2^31 + 40 higher give the
    same slab."""
    c = occ_case("random", cap)
    want = _plain(c, cap)
    _assert_equal(_host_slab(host_check, c, cap, OWN, shift=(1 << 31) + 40), want)
    c = occ_case("mid_row", cap)
    _assert_equal(_host_slab(host_check, c, cap, OWN, shift=(1 << 32) + 8), _plain(c, cap))


@pytest.mark.parametrize("threads", [32, 64, 256])
def test_lane_code_any_team_size(host_check, threads):
    """The arithmetic does not depend on how many threads share an item:
    the card takes 32 at 256 slots and 256 above."""
    cap = 2048
    c = occ_case("random", cap, seed=3)
    _assert_equal(_host_slab(host_check, c, cap, OWN, threads=threads), _plain(c, cap))


def test_wrapper_checks_its_inputs():
    c = occ_case("random", 256)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    args = (t["off"], t["lfreq"], t["start"], t["lane_ok"], t["occ"])
    with pytest.raises(ValueError, match="multiple of 8"):
        occ_slab(*args, 260)
    with pytest.raises(TypeError, match="int64"):
        occ_slab(t["off"].int(), *args[1:], 256)
    with pytest.raises(ValueError, match="bound"):
        occ_slab(*args, 256, tkey=torch.zeros((4, 3), dtype=torch.int64))
    out = occ_slab(*args, 256)  # a CPU tensor: the plain version
    assert out.sid.dtype == torch.int32 and out.tkey.shape == (4, 3, 1)
    bound = occ_bound(*args, 256)  # the bound alone: no slab
    assert bound.sid is None and bound.diag is None
    assert torch.equal(bound.tkey, out.tkey) and torch.equal(bound.overflow_occ, out.overflow_occ)
