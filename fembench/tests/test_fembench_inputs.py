"""The benchmark's input makers: the genome, the index built with torch
(field-equal to the program's builder), and the read pool."""

import numpy as np
import pytest
import torch

from fem_tpu_torch.core.encoding import CHAR_TO_CODE
from fem_tpu_torch.index.build import build_index as program_build_index
from fem_tpu_torch.io.fastx import Reference
from fembench.genome import make_genome
from fembench.index import build_index
from fembench.reads import make_pool

SPEC = {"profile_mb": [248, 242, 198, 59], "total_bp": 2_000_000, "repeat_share": 0.2,
        "segment_bp": [500, 5000], "divergence": 0.01}
WGS = {"pool_reads": 6000, "read_length": 100, "base_error_rate": 0.02, "mutation_rate": 0.001,
       "indel_fraction": 0.15, "indel_extend": 0.3, "quality": "2", "human_share": 1.0}


def reference(names, seqs, gap=256):
    lengths = np.array([len(s) for s in seqs], np.int64)
    offsets = gap + np.concatenate([[0], np.cumsum(lengths[:-1] + gap)]).astype(np.int64)
    flat = np.full(int(offsets[-1] + lengths[-1] + gap), 4, np.uint8)
    for off, s in zip(offsets, seqs):
        flat[off: off + len(s)] = CHAR_TO_CODE[np.frombuffer(s, np.uint8)]
    return Reference(list(names), list(seqs), lengths, offsets, flat)


@pytest.mark.parametrize("total_bp,step", [(1_000_000, 3), (3_000_000, 3), (1_500_000, 5)])
def test_index_field_equal_to_program(total_bp, step):
    names, seqs, _, _ = make_genome(dict(SPEC, total_bp=total_bp), seed=2024)
    want = program_build_index(reference(names, seqs), 12, step)
    lookup, occ = build_index(seqs, 12, step, "cpu")
    assert lookup.dtype == np.uint32 and occ.dtype == np.uint64
    np.testing.assert_array_equal(lookup, want.lookup)
    np.testing.assert_array_equal(occ, want.occurrences)


def test_index_hashes_ambiguous_and_lowercase_as_fem():
    rng = np.random.default_rng(4)
    seqs = []
    for n in (50_000, 11, 30_000):  # one shorter than a k-mer
        s = bytearray(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes())
        for i in rng.integers(0, n, n // 50):
            s[i] = ord("N")
        for i in rng.integers(0, n, n // 20):
            s[i] = ord(chr(s[i]).lower())
        seqs.append(bytes(s))
    names = [b"a", b"b", b"c"]
    want = program_build_index(reference(names, seqs), 12, 3)
    lookup, occ = build_index(seqs, 12, 3, "cpu")
    np.testing.assert_array_equal(lookup, want.lookup)
    np.testing.assert_array_equal(occ, want.occurrences)


def test_genome_follows_its_section():
    names, seqs, flat, offsets = make_genome(SPEC, seed=9)
    assert names == [b"chr1", b"chr2", b"chr3", b"chr4"]
    assert sum(len(s) for s in seqs) == pytest.approx(SPEC["total_bp"], abs=4)
    for s, off in zip(seqs, offsets):
        assert set(s) <= set(b"ACGT")
        np.testing.assert_array_equal(flat[off: off + len(s)], CHAR_TO_CODE[np.frombuffer(s, np.uint8)])
    assert (flat[: offsets[0]] == 4).all() and (flat[offsets[-1] + len(seqs[-1]):] == 4).all()
    named, *_ = make_genome({"names": ["chr21"], "lengths_bp": [70_000], "repeat_share": 0.2,
                             "segment_bp": [500, 5000], "divergence": 0.01}, seed=9)
    assert named == [b"chr21"]


def test_repeats_are_copies_at_the_divergence():
    """A fifth of the genome is re-inserted copies: the share of indexed
    12-mers (step 3) in buckets of more than one is far above a random
    genome's (a copy shares its source's windows where the two lie a
    multiple of the step apart, a third of copies)."""
    spec = dict(SPEC, total_bp=1_000_000)
    _, seqs, _, _ = make_genome(spec, seed=3)
    _, plain, _, _ = make_genome(dict(spec, repeat_share=0.0), seed=3)
    def repeated(ss):
        lookup, _ = build_index(ss, 12, 3, "cpu")
        f = np.diff(lookup.astype(np.int64))
        return f[f > 1].sum() / f.sum()
    assert repeated(seqs) > 0.10 > 0.05 > repeated(plain)


def test_seed_reproduces_inputs():
    a = make_genome(SPEC, seed=2**31 + 5)
    b = make_genome(SPEC, seed=2**31 + 5)
    c = make_genome(SPEC, seed=2**31 + 6)
    assert a[1] == b[1] and a[1] != c[1]
    lengths = np.array([len(s) for s in a[1]], np.int64)
    p = make_pool(WGS, a[2], a[3], lengths, 1000, seed=2**31 + 5)
    q = make_pool(WGS, a[2], a[3], lengths, 1000, seed=2**31 + 5)
    r = make_pool(WGS, a[2], a[3], lengths, 1000, seed=2**31 + 6)
    np.testing.assert_array_equal(p.codes, q.codes)
    assert not np.array_equal(p.codes, r.codes)


def _semi_global(read: np.ndarray, text: np.ndarray) -> int:
    """Edit distance of `read` against the best substring of `text`
    starting at its first base (the read's start is where it was cut)."""
    prev = np.arange(read.shape[0] + 1)
    best = prev[-1]
    for t in text:
        cur = np.empty_like(prev)
        cur[0] = prev[0] + 1
        sub = prev[:-1] + (read != t)
        cur[1:] = np.minimum(sub, prev[1:] + 1)
        for i in range(1, cur.shape[0]):  # insertions, left to right
            cur[i] = min(cur[i], cur[i - 1] + 1)
        best = min(best, cur[-1])
        prev = cur
    return int(best)


def test_reads_follow_wgsim_defaults():
    """Sequencing errors at 2% a base and variants at 0.1% a base, 15% of
    them indels: a mean near 2.1 edits a read, a variant in about one
    read of ten and an indel in about one of seventy."""
    _, seqs, flat, offsets = make_genome(SPEC, seed=21)
    lengths = np.array([len(s) for s in seqs], np.int64)
    pool = make_pool(dict(WGS, pool_reads=60_000), flat, offsets, lengths, 1000, seed=21)
    assert pool.size == 60_000 and pool.codes.shape == (60_000, 100)
    assert pool.codes.max() <= 3
    assert 2.0 < pool.edits.mean() < 2.25
    assert 0.010 < (pool.indels > 0).mean() < 0.019


def test_reads_carry_their_edits():
    _, seqs, flat, offsets = make_genome(SPEC, seed=21)
    lengths = np.array([len(s) for s in seqs], np.int64)
    pool = make_pool(dict(WGS, base_error_rate=0.01, mutation_rate=0.02), flat, offsets,
                     lengths, 1000, seed=21)
    assert pool.indels.sum() > 100
    for i in np.flatnonzero(pool.indels)[:40].tolist() + list(range(40)):
        read = pool.codes[i]
        if pool.strand[i]:
            read = 3 - read[::-1]
        start = offsets[pool.sid[i]] + pool.pos[i]
        ed = _semi_global(read, flat[start: start + 130])
        assert ed <= pool.edits[i], (i, ed, pool.edits[i])
        assert pool.edits[i] == 0 or ed > 0 or pool.indels[i] > 0


def test_host_depletion_pool_mixes_random_reads():
    _, seqs, flat, offsets = make_genome(SPEC, seed=1)
    lengths = np.array([len(s) for s in seqs], np.int64)
    mix = dict(WGS, human_share=0.1)
    pool = make_pool(mix, flat, offsets, lengths, 1000, seed=1)
    assert (pool.sid >= 0).sum() == 600 and (pool.sid < 0).sum() == 5400
    other = make_pool(mix, flat, offsets, lengths, 1000, seed=2)
    assert (other.sid >= 0).sum() == 600  # every seed: the same counts, another order
    assert not np.array_equal(pool.sid >= 0, other.sid >= 0)


def test_pool_rounds_up_to_whole_batches():
    _, seqs, flat, offsets = make_genome(SPEC, seed=1)
    lengths = np.array([len(s) for s in seqs], np.int64)
    pool = make_pool(dict(WGS, pool_reads=2500), flat, offsets, lengths, 1000, seed=1)
    assert pool.size == 3000
    assert torch.as_tensor(pool.codes).dtype == torch.uint8


def test_index_and_reference_on_card_equal_cpu(cuda):
    """On the card: the index builder and the reference give what they
    give on the CPU."""
    from fembench.reference.fem import PlainFem

    names, seqs, flat, offsets = make_genome(dict(SPEC, total_bp=1_000_000), seed=8)
    on_cpu = build_index(seqs, 12, 3, "cpu")
    on_card = build_index(seqs, 12, 3, cuda)
    for a, b in zip(on_cpu, on_card):
        np.testing.assert_array_equal(a, b)
    pool = make_pool(WGS, flat, offsets, np.array([len(s) for s in seqs]), 1000, seed=8)
    got = [PlainFem(12, 3, 5, 1, *on_cpu, names, seqs, dev, block_reads=2048).map_reads(pool.codes)
           for dev in ("cpu", cuda)]
    for f in ("dp", "nc", "nmap", "m_read", "m_band", "m_ed", "m_end"):
        assert torch.equal(getattr(got[0], f), getattr(got[1], f).cpu()), f


def test_fastq_holds_the_pool(tmp_path):
    from fem_tpu_torch.io.fastx import stream_fastq_batches
    from fembench.reads import write_fastq

    _, seqs, flat, offsets = make_genome(SPEC, seed=5)
    pool = make_pool(dict(WGS, pool_reads=3000), flat, offsets,
                     np.array([len(s) for s in seqs], np.int64), 1000, seed=5)
    path = str(tmp_path / "r.fq")
    assert write_fastq(pool, path) == 3000 * (8 + 2 * 100 + 6)
    batches = list(stream_fastq_batches(path, 1000))
    assert [b.num_reads for b in batches] == [1000] * 3
    assert batches[2].names_blob[:8] == b"00002000"
    assert bytes(batches[1].seqs_blob) == pool.chars(1000, 2000).tobytes()
    assert bytes(batches[0].quals_blob) == b"2" * 100_000
