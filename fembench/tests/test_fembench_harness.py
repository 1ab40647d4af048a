"""The harness on the CPU at a tiny size, through the port's plain torch
versions: a cell's run is correct; the control, and the faults a mapping
cell can have planted under the timed path, come out not correct; the
reference agrees with the frozen golden model and catches a planted wrong
record and a planted wrong counter."""

import copy

import numpy as np
import pytest
import torch

from fem_tpu_torch.pipeline import engine as engine_mod
from fem_tpu_torch.pipeline.engine import EngineConfig
from fembench import harness
from fembench import reads as reads_mod
from fembench.reference import golden
from fembench.reference.fem import PlainFem

SEED = 2**31 + 1234567


def tiny(config_name="chr21_e5", traffic_name="wgs", bp=300_000, **traffic_over):
    config = harness.load_json("configs", config_name)
    config["genome"] = {k: v for k, v in config["genome"].items() if k not in ("profile_mb",)}
    config["genome"].update(lengths_bp=[bp // 2, bp // 2], names=["c1", "c2"])
    config["genome"].pop("total_bp", None)
    traffic = dict(harness.load_json("traffic", traffic_name), pool_reads=384, **traffic_over)
    return config, traffic


def run(config, traffic, engine_config=None, control=None, seconds=1.0):
    bench = harness.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["traffic"] == traffic["name"])
    return harness.run_cell(bench, cell, config, traffic, SEED, seconds, False, "cpu", 0.0,
                            lambda m: None, engine_config=engine_config or EngineConfig(batch_size=64),
                            control=control)


@pytest.mark.parametrize("mix,caps", [
    ({}, {}),
    ({}, {"cap_occ": 16, "cap_cand": 16}),  # the retry ladder at work
    ({"human_share": 0.1}, {}),  # host depletion: reads of no genome
])
def test_cell_is_correct(mix, caps):
    out = run(*tiny(**mix), EngineConfig(batch_size=64, **caps))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s"}  # no device trace on the CPU
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())


def test_control_is_not_correct():
    out = run(*tiny(), control="best_only")
    assert not out["correct"]
    assert out["checks"]["wrong_reads"]["value"] > 0
    assert out["checks"]["mappings_gap"]["value"] > 0


def test_altered_record_is_not_correct(monkeypatch):
    """An answer altered where it is produced: the emitter's first record
    of every batch moved one base."""
    real = engine_mod.NativeEmitter.emit

    def emit(self, *args, **kwargs):
        res = real(self, *args, **kwargs)
        blob = res[0] if isinstance(res, tuple) else res
        if blob:
            f = blob.split(b"\t", 4)
            f[3] = b"%d" % (int(f[3]) + 1)
            blob = b"\t".join(f)
        return (blob, res[1]) if isinstance(res, tuple) else blob

    monkeypatch.setattr(engine_mod.NativeEmitter, "emit", emit)
    out = run(*tiny())
    assert not out["correct"]
    assert out["checks"]["wrong_reads"]["value"] > 0


def test_half_batch_left_out_is_not_correct(monkeypatch):
    """Half of each batch left out: the hits of the reads in its second
    half dropped before emission (those reads come out unmapped)."""
    real = engine_mod.accepted_hits

    def half(host, acc_cap):
        lane, *rest = real(host, acc_cap)
        B = host["fb"].shape[0]
        keep = (lane % B) < B // 2
        return (lane[keep], *(c[keep] for c in rest))

    monkeypatch.setattr(engine_mod, "accepted_hits", half)
    out = run(*tiny())
    assert not out["correct"]
    assert out["checks"]["mappings_gap"]["value"] > 0


def feed_of(inputs, tmp_path, batch_size=64):
    path = str(tmp_path / "reads.fq")
    reads_mod.write_fastq(inputs.pool, path)
    return harness.Feed(path, inputs.pool.size, batch_size)


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    """One tiny window, kept whole for planting faults in its output."""
    config, traffic = tiny()
    inputs = harness.make_inputs(config, traffic, SEED, "cpu", 64)
    engine = harness.make_engine(inputs, "cpu", EngineConfig(batch_size=64))
    feed = feed_of(inputs, tmp_path_factory.mktemp("feed"))
    watched = np.arange(feed.n_batches)
    window = harness.run_stream(engine, feed, seconds=0.5, sink=harness.Sink(watched, 64))
    return window, inputs, feed, watched


def check(window, inputs, watched):
    return harness.check_run(window, inputs, SEED, "cpu", watched,
                             check_reads=inputs.pool.size)["checks"]


def test_reference_catches_planted_record(stream_run):
    window, inputs, _, watched = stream_run
    assert all(v == 0 for v, _ in check(window, inputs, watched).values())
    w = copy.copy(window)
    items = [list(chunks) for chunks in window["items"]]
    for chunks in items:
        for j, chunk in enumerate(chunks):
            if b"MD:Z:" in chunk:
                lines = chunk.split(b"\n")
                lines[0] = lines[0].replace(b"NM:i:", b"NM:i:1")  # a wrong edit distance
                chunks[j] = b"\n".join(lines)
                break
        else:
            continue
        break
    w["items"] = items
    checks = check(w, inputs, watched)
    assert checks["wrong_reads"][0] == 1
    assert sum(v for k, (v, _) in checks.items() if k != "wrong_reads") == 0


@pytest.mark.parametrize("counter", harness.COUNTERS)
def test_reference_catches_planted_counter(stream_run, counter):
    window, inputs, _, watched = stream_run
    w = dict(window, totals=dict(window["totals"]))
    w["totals"][counter] += 1
    checks = check(w, inputs, watched)
    assert [k for k, (v, _) in checks.items() if v] == [{
        "num_reads": "reads_gap", "num_mapped_reads": "mapped_gap",
        "num_candidates_without_additional_qgram_filter": "prefilter_gap",
        "num_candidates": "candidates_gap", "num_mappings": "mappings_gap"}[counter]]


@pytest.mark.parametrize("e,a,satellite", [(5, 1, False), (2, 0, True), (7, 2, False), (0, 0, False)])
def test_reference_equals_golden(e, a, satellite):
    """The batched reference against the frozen golden model, read by read:
    counters and records, on repeats, satellite arrays, ambiguous bases and
    reads of no genome."""
    rng = np.random.default_rng(e * 10 + a)
    n = 120_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if satellite:  # tandem arrays: seeds of a thousand occurrences
        unit = rng.integers(0, 4, 37).astype(np.uint8)
        codes[20_000:60_000] = np.tile(unit, 60_000 // 37 + 1)[:40_000]
    else:
        for _ in range(40):
            L, s, d = 1500, rng.integers(0, n - 1500), rng.integers(0, n - 1500)
            codes[d: d + L] = codes[s: s + L]
    seq = bytearray(np.frombuffer(b"ACGT", np.uint8)[codes].tobytes())
    for i in rng.integers(0, n, 30):
        seq[i] = ord("N")
    seqs = [bytes(seq[: n // 2]), bytes(seq[n // 2:])]
    names = [b"s0", b"s1"]
    from fem_tpu_torch.index.build import build_index
    from test_fembench_inputs import reference

    idx = build_index(reference(names, seqs), 12, 3)
    L = 100
    starts = rng.integers(0, n - L, 150)
    reads = []
    for r, s0 in enumerate(starts):
        r_seq = bytearray(seq[s0: s0 + L])
        for p in rng.integers(0, L, rng.integers(0, e + 2)):
            r_seq[p] = b"ACGT"[rng.integers(0, 4)]
        reads.append(bytes(r_seq))
    reads += [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].tobytes() for _ in range(30)]
    reads.append(b"N" * L)
    plain = PlainFem(12, 3, e, a, idx.lookup, idx.occurrences, names, seqs, "cpu", block_reads=64)
    mapped = plain.map_reads(np.stack([golden.CHAR_TO_CODE[np.frombuffer(r, np.uint8)]
                                       for r in reads]))
    recs = plain.records(mapped, [(i, b"r%d" % i, r, b"I" * L) for i, r in enumerate(reads)])
    g = golden.GoldenMapper(golden.FemArgs(12, 3, e, a), golden.Genome(names, seqs, np.array([len(s) for s in seqs])), idx)
    total = golden.MappingStats()
    for i, r in enumerate(reads):
        want, st = g.map_read(b"r%d" % i, r, b"I" * L)
        total += st
        assert recs[i] == want, i
        assert (int(mapped.dp[i]), int(mapped.nc[i]), int(mapped.nmap[i])) == (
            st.num_candidates_without_additional_qgram_filter, st.num_candidates,
            st.num_mappings), i
    assert mapped.counters() == {k: getattr(total, k) for k in harness.COUNTERS}


def test_reference_weights_reads_by_pulls():
    rng = np.random.default_rng(3)
    seqs = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 40_000)].tobytes()]
    from fem_tpu_torch.index.build import build_index
    from test_fembench_inputs import reference

    idx = build_index(reference([b"s"], seqs), 12, 3)
    codes = golden.CHAR_TO_CODE[np.frombuffer(seqs[0][1000:2000], np.uint8)].reshape(10, 100)
    m = PlainFem(12, 3, 5, 1, idx.lookup, idx.occurrences, [b"s"], seqs, "cpu").map_reads(codes)
    once = m.counters()
    w = torch.arange(10)
    twice = m.counters(w)
    assert twice["num_reads"] == 45
    assert twice["num_mappings"] == int((m.nmap * w).sum()) and once["num_mappings"] == 10


def test_window_stops_at_its_step_cap(stream_run):
    """A traced window ends after TRACE_STEPS device steps; with a cap of
    none it ends at its first item, and the stream still drains whole."""
    _, inputs, feed, watched = stream_run
    engine = harness.make_engine(inputs, "cpu", EngineConfig(batch_size=64))
    w = harness.run_stream(engine, feed, seconds=60.0, sink=harness.Sink(watched, 64), max_steps=0)
    assert w["seconds"] < 30 and w["pulled_batches"] <= 6
    assert w["totals"]["num_reads"] == w["pulled_reads"]


def test_feed_cycles_the_file_and_counts_pulls(stream_run):
    """The feed reads the FASTQ file through the program's reader, again from
    its start at its end; each pull is counted against its pool batch, and
    the reader's thread ends with the stream."""
    import threading

    _, inputs, feed, _ = stream_run
    feed.pulls[:] = 0
    log: list = []
    threads = threading.active_count()
    got = list(feed.stream(threading.Event(), feed.n_batches + 2, log))
    assert [b.num_reads for b in got] == [64] * (feed.n_batches + 2)
    assert [e for _, e in log] == [64 * (i + 1) for i in range(feed.n_batches + 2)]
    assert feed.pulls.tolist() == [2, 2] + [1] * (feed.n_batches - 2)
    names = [got[i].names_blob[:8] for i in (0, 1, feed.n_batches)]
    assert names == [b"00000000", b"00000064", b"00000000"]
    assert bytes(got[1].seqs_blob[:100]) == inputs.pool.chars(64, 65).tobytes()
    assert threading.active_count() == threads


@pytest.mark.parametrize("lo,hi", [(0, 64), (64, 128), (10_000, 20_000), (8192, 16384),
                                   (999_990, 1_000_030)])
def test_name_prefixes_cover_exactly_the_batch(lo, hi):
    prefixes = harness.name_prefixes(lo, hi)
    names = [b"%08d" % i for i in range(max(lo - 300, 0), hi + 300)]
    hit = [any(n.startswith(p) for p in prefixes) for n in names]
    assert hit == [lo <= int(n) < hi for n in names]


def test_sink_keeps_items_with_a_watched_line_anywhere():
    """An item is kept wherever a watched batch's line sits in it, first,
    last or in between (a retry batch may mix batches)."""
    sink = harness.Sink([3], 64)
    line = lambda i: b"%08d\t0\tc1\t1\n" % i
    sink.add([line(0) + line(1)])
    sink.add([line(5) + line(3 * 64 + 7) + line(9)])
    sink.add([line(3 * 64)])
    sink.add([b"", line(10) + line(4 * 64)])
    assert sink.lines == 8
    assert len(sink.items) == 2
