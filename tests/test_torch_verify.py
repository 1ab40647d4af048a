"""Banded Myers verification of the port against fem_tpu.

The plain torch version is held against fem_tpu's jnp banded_myers and its
Pallas kernel (interpreted) on every slot, and the kernel's per-slot header
code (csrc/myers_core.h, built for the host with g++) against the plain
version, window gather included.
"""

import ctypes
import shutil
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops.verify import banded_myers as jmyers
from fem_tpu.ops.verify import compute_eq as jeq
from fem_tpu.ops.verify_pallas import banded_myers_pallas
from fem_tpu_torch import kernels
from fem_tpu_torch.ops import types as ttypes
from test_torch_cases import slot_case
from fem_tpu_torch.ops.verify import (
    banded_myers,
    compute_eq,
    gather_windows,
    verify_candidates,
)

torch.set_num_threads(1)


def _mutated_pairs(rng, V, L, e):
    """Random windows and texts; half the texts are mutated copies of their
    window's diagonal, so part of the slots are accepted."""
    window = rng.integers(0, 5, size=(V, L + 2 * e)).astype(np.uint8)
    text = rng.integers(0, 5, size=(V, L)).astype(np.uint8)
    for i in range(0, V, 2):
        text[i] = window[i, e : e + L]
        for _ in range(rng.integers(0, e + 2)):
            text[i, rng.integers(0, L)] = rng.integers(0, 4)
    lengths = rng.integers(40, L + 1, size=V).astype(np.int32)
    return window, text, lengths


@pytest.mark.parametrize("e", [0, 2, 5, 7])
def test_plain_myers_matches_jax(e):
    rng = np.random.default_rng(400 + e)
    window, text, lengths = _mutated_pairs(rng, 300, 100, e)
    got = banded_myers(
        compute_eq(torch.from_numpy(window), torch.from_numpy(text), e),
        torch.from_numpy(lengths), e,
    )
    want = jmyers(jeq(jnp.asarray(window), jnp.asarray(text), e), jnp.asarray(lengths), e)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.accepted.any() and not got.accepted.all()


def test_plain_myers_matches_pallas_interpreted():
    e = 5
    rng = np.random.default_rng(450)
    window, text, lengths = _mutated_pairs(rng, 200, 64, e)
    got = banded_myers(
        compute_eq(torch.from_numpy(window), torch.from_numpy(text), e),
        torch.from_numpy(lengths), e,
    )
    want = banded_myers_pallas(
        jnp.asarray(window), jnp.asarray(text), jnp.asarray(lengths), e, interpret=True
    )
    for g, w in zip(got, want):  # every slot, accepted or not
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_windows_direct(small_reference, small_index, rng):
    _, ref = small_reference
    index = ttypes.device_index_from_host(small_index, ref, "cpu")
    W, V = 114, 257
    sid = rng.integers(0, ref.num_seqs, V).astype(np.int32)
    pos = np.array([rng.integers(0, ref.lengths[s] - W) for s in sid], np.int32)
    got = gather_windows(index, torch.from_numpy(sid), torch.from_numpy(pos), W).numpy()
    for i in range(V):
        off = int(ref.offsets[sid[i]]) + int(pos[i])
        np.testing.assert_array_equal(got[i], ref.flat_codes[off : off + W])
    # Windows past the last base clamp into the trailing sentinel gap.
    end = ttypes.device_index_from_host(small_index, ref, "cpu").ref_flat.shape[0]
    last = gather_windows(index, torch.tensor([ref.num_seqs - 1], dtype=torch.int32),
                          torch.tensor([end], dtype=torch.int32), W)
    assert (last == 4).all()


@pytest.fixture(scope="module")
def host_check():
    """The kernels' header code built for the host. Skips only when g++ is
    absent; a compile error fails."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    with tempfile.TemporaryDirectory() as d:
        yield kernels.build_host_check(d)


def _host_myers(host_check, index, v_sid, v_pos, v_lane, both, lens, e, used):
    """The g++ build of the kernel's slot code."""
    V = v_sid.shape[0]
    NB, Lmax = both.shape
    ed = np.empty(V, np.int32)
    end = np.empty(V, np.int32)
    vp = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    flat = index.ref_flat.numpy()
    offs = index.ref_offsets.numpy()
    both = np.ascontiguousarray(both)
    host_check.fem_host_banded_myers(
        vp(flat), flat.shape[0], vp(offs), offs.shape[0], vp(v_sid), vp(v_pos),
        vp(v_lane), vp(both), vp(lens), NB, Lmax, e, V, used, vp(ed), vp(end),
    )
    return ed, end


@pytest.mark.parametrize("e", [0, 3, 5, 7])
def test_kernel_slot_code_matches_plain(host_check, small_reference, small_index, e):
    """Slots against reads copied from the reference with edits, plus
    out-of-range sids, lanes and positions (clamped alike)."""
    _, ref = small_reference
    index = ttypes.device_index_from_host(small_index, ref, "cpu")
    case = slot_case(ref, e, 128, 500 + e)
    ed, end = _host_myers(host_check, index, *case, e, case[0].shape[0])
    want = verify_candidates(index, *(torch.from_numpy(x) for x in case), e)
    np.testing.assert_array_equal(ed, want.edit_distance.numpy())
    np.testing.assert_array_equal(end, want.end_offset.numpy())
    assert want.accepted.any() and not want.accepted.all()


@pytest.mark.parametrize("used,Lmax", [(0, 128), (1, 128), (200, 128), (400, 128),
                                       (400, 100), (400, 40), (400, 160), (400, 256)])
@pytest.mark.parametrize("e", [0, 2, 5, 7])
def test_kernel_slot_code_edges(host_check, small_reference, small_index, e, used, Lmax):
    """Host build of the kernel's slot code == plain version == fem_tpu's
    banded_myers on windows gathered with numpy, exactly, with `used` of the
    400 slots in use. Lmax 100 and 40 give read rows that start off a
    16-byte boundary; at Lmax 160 and 256 a full-width read crosses the
    32-base chunk loop (csrc/myers_core.h:verify_slot) five and eight
    times."""
    _, ref = small_reference
    index = ttypes.device_index_from_host(small_index, ref, "cpu")
    case = slot_case(ref, e, Lmax, 700 + 10 * e + Lmax)
    v_sid, v_pos, v_lane, both, lens = case
    V = v_sid.shape[0]
    ed, end = _host_myers(host_check, index, *case, e, used)
    want = verify_candidates(index, *(torch.from_numpy(x) for x in case), e,
                             used=torch.tensor(used))
    np.testing.assert_array_equal(ed, want.edit_distance.numpy())
    np.testing.assert_array_equal(end, want.end_offset.numpy())
    assert not want.accepted[used:].any()
    assert (want.edit_distance[used:] == e + 1).all() and (want.end_offset[used:] == -1).all()

    flat = ref.flat_codes
    sid = np.clip(v_sid, 0, ref.num_seqs - 1)
    lane = np.clip(v_lane, 0, both.shape[0] - 1)
    g = (ref.offsets[sid] + v_pos.astype(np.int64))[:, None] + np.arange(Lmax + 2 * e)
    window = flat[np.clip(g, 0, flat.shape[0] - 1)]
    j_ed, j_end, j_acc = jmyers(
        jeq(jnp.asarray(window), jnp.asarray(both[lane]), e), jnp.asarray(lens[lane]), e
    )
    in_use = np.arange(V) < used
    np.testing.assert_array_equal(ed[in_use], np.asarray(j_ed)[in_use])
    np.testing.assert_array_equal(end[in_use], np.asarray(j_end)[in_use])
    np.testing.assert_array_equal(want.accepted.numpy(), np.asarray(j_acc) & in_use)
    if used == V:
        assert want.accepted.any() and not want.accepted.all()
