"""Hashing and q-gram selection of the port against fem_tpu's JAX ops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim
from fem_tpu.config import FemArgs
from fem_tpu.core.encoding import CHAR_TO_CODE
from fem_tpu.ops import hashing as jhash
from fem_tpu.ops import types as jtypes
from fem_tpu.ops.seed_select import select_qgrams as jselect
from fem_tpu_torch.ops import hashing as thash
from fem_tpu_torch.ops import types as ttypes
from fem_tpu_torch.ops.seed_select import select_qgrams as tselect

torch.set_num_threads(1)


def _codes(small_reference, n, seed):
    """Simulated reads of mixed lengths, with Ns, padded to 128."""
    seqs, _ = small_reference
    reads = sim.simulate_reads(seqs, n, read_length=100, max_errors=3, seed=seed)
    rng = np.random.default_rng(seed)
    codes = np.full((n + 2, 128), 4, np.uint8)
    lengths = np.zeros(n + 2, np.int32)
    for i, r in enumerate(reads):
        s = r.seq[: int(rng.integers(8, 101))]
        if i % 5 == 0:
            s = s[:10] + b"N" + s[11:]
        codes[i, : len(s)] = CHAR_TO_CODE[np.frombuffer(s, np.uint8)]
        lengths[i] = len(s)
    codes[n, :128], lengths[n] = rng.integers(0, 5, 128), 128  # full width
    return codes, lengths  # last row: empty (length 0)


@pytest.mark.parametrize("k", [12, 11])
def test_hashing_matches_jax(small_reference, k):
    codes, lengths = _codes(small_reference, 40, 61 + k)
    neg_j = np.asarray(jhash.reverse_complement(jnp.asarray(codes), jnp.asarray(lengths)))
    neg_t = thash.reverse_complement(torch.from_numpy(codes), torch.from_numpy(lengths))
    np.testing.assert_array_equal(neg_t.numpy(), neg_j)
    both = np.concatenate([codes, neg_j])
    lens2 = np.concatenate([lengths, lengths])
    np.testing.assert_array_equal(
        thash.seed_hashes(torch.from_numpy(both), k).numpy(),
        np.asarray(jhash.seed_hashes(jnp.asarray(both), k)),
    )
    np.testing.assert_array_equal(
        thash.ambiguous_base_counts(
            torch.from_numpy(both), torch.from_numpy(lens2), k
        ).numpy(),
        np.asarray(jhash.ambiguous_base_counts(jnp.asarray(both), jnp.asarray(lens2), k)),
    )


@pytest.mark.parametrize("e,a", [(2, 1), (5, 1), (0, 0), (7, 2)])
def test_select_qgrams_matches_jax(e, a):
    args = FemArgs(error_threshold=e, num_additional_qgrams=a)
    jp = jtypes.FilterParams.from_args(args, 128)
    tp = ttypes.FilterParams.from_args(args, 128)
    rng = np.random.default_rng(300 + 10 * e + a)
    NL, NG = 96, tp.max_group_size
    freqs = rng.integers(0, 60, size=(NL, NG)).astype(np.uint32)
    freqs[rng.random((NL, NG)) < 0.2] = 0
    # Frequencies near 2^32 make the DP sums wrap (src/filter.c uses u32).
    freqs[rng.random((NL, NG)) < 0.05] = np.uint32(0xFFFFFFF0)
    sizes = rng.integers(0, NG + 1, size=NL).astype(np.int32)
    occ = 12345 if a else 0xFFFFFF00  # degenerate-group sentinel, near the wrap
    js = jselect(jnp.asarray(freqs), jnp.asarray(sizes),
                 jnp.asarray(np.uint32(occ)), jp)
    ts = tselect(torch.from_numpy(freqs.astype(np.int64)),
                 torch.from_numpy(sizes), occ, tp)
    np.testing.assert_array_equal(ts.positions.numpy(), np.asarray(js.positions))
    np.testing.assert_array_equal(
        ts.min_total.numpy().astype(np.uint32), np.asarray(js.min_total)
    )
    assert ts.min_total.min() >= 0 and ts.min_total.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(ts.complete.numpy(), np.asarray(js.complete))
    np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js.degenerate))
    assert ts.degenerate.any()
    assert ts.complete.any() or tp.num_qgrams * tp.seed_span > NG
