"""The engine's step program on one device, on the CPU
(fem_tpu_torch/pipeline/engine.py, GridProgram on a grid of one cell): the
padded, packed step against the unpadded one, the program cache by (tier,
Lmax), the packed input's length bytes (fem_tpu_torch/ops/step.py), and the
arithmetic of kernel launch counts under capture and replay.

On a card the cell's step is one CUDA graph; here the same segment runs
eagerly on the same padded, packed input, so everything but the graph is
held here (tests/test_torch_cuda.py holds the graphs on the card).
"""

import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch

from fem_tpu import sim
from fem_tpu.golden.model import GoldenMapper
from fem_tpu_torch import kernels
from fem_tpu_torch.ops.step import (
    accepted_hits,
    map_core,
    pack_input,
    pack_result,
    unpack_input,
    unpack_result,
)
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
from tests.test_engine import _batch_from_reads

torch.set_num_threads(1)

B = 16
CAPS = {
    "roomy": dict(cap_occ=256, cap_cand=128, verify_per_read=32, accept_per_read=16),
    # A verify slab of 8 slots for 16 reads: later lanes overflow, and
    # the retry bits reach the padding rows too.
    "tight": dict(cap_occ=256, cap_cand=128, verify_per_read=0.25, accept_per_read=1),
}


def _engine(small_reference, small_index, default_args, caps):
    _, ref = small_reference
    return MappingEngine(default_args, ref, small_index,
                         EngineConfig(batch_size=B, **CAPS[caps]), device="cpu")


def _hits_by_read(host, acc_cap, nreads):
    """Accepted hits as (read, strand, sid, pos, ed, end) rows: lanes of a
    padded step number the minus strand from its batch size, not from the
    reads it holds."""
    lane, sid, pos, ed, end = accepted_hits(host, acc_cap)
    return np.stack([lane % nreads, lane >= nreads, sid, pos, ed, end], axis=1)


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("n", [1, B - 1, B])
def test_padded_step_equals_unpadded(small_reference, small_index, default_args, n, caps):
    seqs, ref = small_reference
    engine = _engine(small_reference, small_index, default_args, caps)
    reads = sim.simulate_reads(seqs, n, read_length=100, max_errors=2, seed=40 + n)
    batch = _batch_from_reads(reads)
    Lmax = batch.codes.shape[1]
    prog = engine._program(0, Lmax)
    acc_cap = max(prog.step.accept_cap, 8)

    flat, ready = prog.run({0: pack_input(batch.codes, batch.lengths, B)})
    assert ready == [] and flat.shape[0] == 3 + 5 * acc_cap + 2 * B
    padded = unpack_result(flat.numpy(), acc_cap, B)
    out = map_core(engine._cell_index[0, 0], torch.from_numpy(batch.codes),
                   torch.from_numpy(batch.lengths), prog.step.params, prog.step.verify_cap,
                   prog.step.accept_cap)
    plain = unpack_result(pack_result(out).numpy(), acc_cap, n)
    np.testing.assert_array_equal(_hits_by_read(padded, acc_cap, B),
                                  _hits_by_read(plain, acc_cap, n))
    for k in ("n_accepted", "sum_nc", "sum_dp"):
        assert padded[k] == plain[k], k
    for k in ("fb", "inherent"):
        np.testing.assert_array_equal(padded[k][:n], plain[k], err_msg=k)
    assert not padded["inherent"][n:].any()
    if caps == "tight":
        assert plain["fb"].any() or n == 1

    # The engine's whole path, padded: the golden oracle's bytes and counters.
    recs, stats = engine.map_batch(batch)
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)


def test_one_program_per_tier_and_lmax(small_reference, small_index, default_args):
    """A stream of 100 bp batches (Lmax 128) and one of 150 bp (Lmax 160)
    makes two tier-0 programs; mapping again makes none."""
    seqs, ref = small_reference
    engine = _engine(small_reference, small_index, default_args, "roomy")
    short = sim.simulate_reads(seqs, 40, read_length=100, max_errors=2, seed=51)
    long = sim.simulate_reads(seqs, 10, read_length=150, max_errors=2, seed=52)
    batches = [_batch_from_reads(short[i : i + B]) for i in range(0, 40, B)]
    batches.append(_batch_from_reads(long))
    assert [b.codes.shape[1] for b in batches] == [128, 128, 128, 160]
    for _ in range(2):
        recs = [r for chunk, _ in engine.map_stream(batches) for r in chunk]
        assert set(engine.programs) == {(0, 128), (0, 160)}
    assert engine.retried_reads == 0
    grecs, _ = GoldenMapper(default_args, ref, small_index).map_reads(
        [r.name for r in short + long], [r.seq for r in short + long],
        [r.qual for r in short + long])
    lines = lambda chunks: sorted(x for c in chunks for x in c.splitlines())
    assert lines(recs) == lines(grecs)
    # A program is the key's own: its shapes follow the tier and Lmax.
    p128, p160 = engine.programs[0, 128], engine.programs[0, 160]
    assert (p128.step.params.max_read_length, p160.step.params.max_read_length) == (128, 160)
    assert p128.step.verify_cap == p160.step.verify_cap == int(2 * B * 32)


def test_retry_tier_gets_its_own_program(small_reference, small_index, default_args):
    """Tight tier-0 caps: the overflow reads go to a tier-1 program, keyed
    by the sub-batch's Lmax."""
    seqs, _ = small_reference
    engine = _engine(small_reference, small_index, default_args, "tight")
    batch = _batch_from_reads(sim.simulate_reads(seqs, B, read_length=100, max_errors=2,
                                                 seed=53))
    engine.map_batch(batch)
    assert engine.retried_reads > 0
    assert set(engine.programs) == {(0, 128), (1, 128)}


@pytest.mark.parametrize("Lmax", [256, 288])
def test_packed_length_bytes_decode(Lmax):
    lengths = np.array([0, 1, 255, 256, Lmax, 7], np.int32)
    lengths = np.minimum(lengths, Lmax)
    rng = np.random.default_rng(Lmax)
    codes = np.full((lengths.size, Lmax), 4, np.uint8)
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.integers(0, 5, n)
    packed = pack_input(codes, lengths, 9)
    assert packed.shape == (9, Lmax + 4) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed[:6, Lmax:], lengths.astype("<i4").view(np.uint8)
                                  .reshape(6, 4))
    assert (packed[6:, :Lmax] == 4).all() and (packed[6:, Lmax:] == 0).all()
    got_codes, got_lengths = unpack_input(packed)
    assert got_lengths.dtype == torch.int32
    np.testing.assert_array_equal(got_lengths.numpy(), np.r_[lengths, 0, 0, 0])
    np.testing.assert_array_equal(got_codes.numpy()[:6], codes)
    with pytest.raises(ValueError, match="do not fit"):
        pack_input(codes, lengths, 5)


def test_packed_input_equals_native_reader(tmp_path):
    """pack_input's bytes are the native FASTQ reader's `packed` buffer
    (the upload fem_tpu's reader builds), for a short last batch too."""
    from fem_tpu_torch.io import fastx

    rng = np.random.default_rng(3)
    lens = [1, 255, 256, 100, 288, 33, 64]
    with open(tmp_path / "r.fq", "w") as f:
        for i, n in enumerate(lens):
            s = "".join(rng.choice(list("ACGTN"), n))
            f.write(f"@r{i}\n{s}\n+\n{'I' * n}\n")
    batches = list(fastx.stream_fastq_batches(str(tmp_path / "r.fq"), batch_size=4,
                                              use_native=True))
    assert [b.num_reads for b in batches] == [4, 3]
    for b in batches:
        assert b.packed is not None and b.packed.dtype == torch.uint8
        np.testing.assert_array_equal(pack_input(b.codes, b.lengths, 4).numpy(),
                                      b.packed.numpy())


def _stand_in_body(calls):
    """What a step's body does to the counts: the wrappers' count_launch
    calls, at two shapes of one kernel."""
    calls.append(1)
    kernels.count_launch("filter_tail", (80, 16))
    kernels.count_launch("banded_myers", (64, 32))
    kernels.count_launch("filter_tail", (640, 512))


def test_launch_counts_of_warm_up_capture_and_replays():
    """A stand-in program: the warm-up runs the body and counts as the real
    launches it is; the capture runs it once more inside
    kernels.recording_launches and counts nothing; each replay adds what
    the capture recorded."""
    kernels.reset_launches()
    calls = []
    _stand_in_body(calls)  # warm-up
    with kernels.recording_launches() as recorded:  # capture
        _stand_in_body(calls)
    assert kernels.launches == {"filter_tail": 2, "banded_myers": 1, "occ_slab": 0,
                                "verify_slab": 0, "accept_slab": 0}
    assert recorded == collections.Counter({("filter_tail", (80, 16)): 1,
                                            ("banded_myers", (64, 32)): 1,
                                            ("filter_tail", (640, 512)): 1})
    for _ in range(3):  # replays
        kernels.add_launches(recorded)
    assert len(calls) == 2  # a replay runs no wrapper
    assert kernels.launches == {"filter_tail": 8, "banded_myers": 4, "occ_slab": 0,
                                "verify_slab": 0, "accept_slab": 0}
    assert kernels.launches_by_shape() == {
        "filter_tail": {(80, 16): 4, (640, 512): 4}, "banded_myers": {(64, 32): 4},
        "occ_slab": {}, "verify_slab": {}, "accept_slab": {}}
    # Outside the capture a wrapper counts again.
    _stand_in_body(calls)
    assert kernels.launches == {"filter_tail": 10, "banded_myers": 5, "occ_slab": 0,
                                "verify_slab": 0, "accept_slab": 0}
    kernels.reset_launches()


def test_recording_is_per_thread():
    """Another thread's launches during a capture count as launches."""
    kernels.reset_launches()
    started, release = threading.Event(), threading.Event()

    def other():
        started.wait()
        kernels.count_launch("banded_myers", (8, 8))
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with kernels.recording_launches() as recorded:
        started.set()
        release.wait(10)
        kernels.count_launch("filter_tail", (8, 8))
    t.join()
    assert kernels.launches == {"filter_tail": 0, "banded_myers": 1, "occ_slab": 0,
                                "verify_slab": 0, "accept_slab": 0}
    assert recorded == collections.Counter({("filter_tail", (8, 8)): 1})
    kernels.reset_launches()


def test_eager_step_gives_the_programs_result(small_reference, small_index, default_args):
    """engine.eager_step (the eager path on which the card's kernel
    wrappers are called and timed) maps the same batch to the same bytes."""
    seqs, _ = small_reference
    batch = _batch_from_reads(sim.simulate_reads(seqs, B - 3, read_length=100,
                                                 max_errors=2, seed=54))
    engine = _engine(small_reference, small_index, default_args, "roomy")
    want = engine.map_batch(batch)
    engine.eager_step = True
    got = engine.map_batch(batch)
    assert b"".join(got[0]) == b"".join(want[0]) and got[1] == want[1]
