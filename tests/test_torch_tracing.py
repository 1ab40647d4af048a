"""The port's span recorder (fem_tpu_torch/utils/metrics.py: `span`,
`tracing`, `take_spans`) on the CPU: off by default and free of records;
on, each span's parent, batch, tier and thread; the spans a stream records
against what it mapped; the cap; the clock against torch.profiler's host
events; garbage collection; and the command line's --profile."""

import gc
import itertools
import json
import statistics
import sys
import threading
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from fem_tpu_torch import sim
from fem_tpu_torch.config import FemArgs
from fem_tpu_torch.index import build_index
from fem_tpu_torch.io import fastx
from fem_tpu_torch.pipeline import cli
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
from fem_tpu_torch.pipeline.prefetch import ThreadedBatchSource
from fem_tpu_torch.utils import metrics
from fem_tpu_torch.utils.metrics import span, take_spans, tracing

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test leaves tracing off, whatever it asserts."""
    yield
    tracing(False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 120 kb genome with its index and 200 reads (64-read batches: 4
    batches, the last of 8), and a satellite genome whose arrays overflow
    caps of 32 (the retry ladder at work)."""
    d = tmp_path_factory.mktemp("tracing")
    seqs = sim.random_genome(120_000, num_seqs=1, seed=21)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    sim.write_fastq(str(d / "reads.fq"), sim.simulate_reads(seqs, 200, max_errors=2, seed=22))
    sat = sim.satellite_genome(300_000, num_seqs=1, seed=5, satellite_fraction=0.15)
    sim.write_fasta(str(d / "sat.fa"), sat)
    sim.write_fastq(str(d / "sat.fq"), sim.simulate_reads(sat, 300, max_errors=2, seed=9))
    return d


def stream(d, name, **caps):
    """Map `name`.fq against its genome (ref.fa, or sat.fa for sat.fq)
    through map_stream from a ThreadedBatchSource with tracing on: (reads
    mapped, the engine, the recording)."""
    ref = fastx.read_fasta(str(d / ("sat.fa" if name == "sat" else "ref.fa")))
    engine = MappingEngine(FemArgs(error_threshold=2), ref, build_index(ref, 12, 3),
                           EngineConfig(batch_size=64, **caps), device="cpu")
    tracing(True)
    n = 0
    source = ThreadedBatchSource(fastx.stream_fastq_batches(str(d / f"{name}.fq"), 64))
    for _, st in engine.map_stream(source):
        n += st.num_reads
    tracing(False)
    return n, engine, take_spans()


def named(rec, name):
    return [r for r in rec["records"] if r["name"] == name]


def test_off_returns_one_shared_object_and_keeps_nothing():
    """Off (after a recording, too): the one shared object, whatever the
    tags; a call allocates nothing (the peak of a loop's memory does not
    grow with its length) and nothing is recorded."""
    tracing(True)
    tracing(False)
    a = span("fem::a", batch=1, tier=0, reads=3)
    assert a is span("fem::b") and a.id is None

    def loop(n):
        for _ in itertools.repeat(None, n):
            with span("fem::x", tier=1, reads=5) as sp:
                sp.tag(batch=7)

    tracemalloc.start()
    try:
        loop(10)
        grown = []
        for n in (10, 100_000):
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            loop(n)
            cur, peak = tracemalloc.get_traced_memory()
            grown.append((cur - base, peak - base))
    finally:
        tracemalloc.stop()
    assert grown[0][0] == grown[1][0] == 0 and grown[1][1] == grown[0][1]
    assert take_spans()["records"] == []


def test_parents_batches_and_threads_on_an_executor_thread():
    """Spans opened on a pool thread: the enclosing span on that thread is
    the parent, tags pass down to children that have none, the cause is
    what the caller gave, and the thread is the pool thread's."""
    tracing(True)
    with span("fem::submit", tier=1, reads=9) as sub:
        pass

    def work():
        with span("fem::drain", cause=sub.id, batch=-sub.id, tier=1, reads=9) as d:
            with span("fem::emit", reads=9):
                pass
        return threading.get_native_id(), d.id

    with ThreadPoolExecutor(1) as ex:
        tid, drain_id = ex.submit(work).result()
    tracing(False)
    rec = take_spans()
    (d,), (e,), (s,) = named(rec, "fem::drain"), named(rec, "fem::emit"), named(rec, "fem::submit")
    assert d["thread"] == e["thread"] == tid != s["thread"] == threading.get_native_id()
    assert d["id"] == drain_id and d["parent"] is None and d["cause"] == s["id"]
    assert e["parent"] == d["id"] and (e["batch"], e["tier"], e["reads"]) == (-s["id"], 1, 9)
    assert d["start_ns"] <= e["start_ns"] <= e["end_ns"] <= d["end_ns"]
    assert rec["dropped"] == 0 and rec["start_ns"] <= s["start_ns"] and rec["end_ns"]


def test_stream_records_one_submit_and_one_drain_a_batch(files):
    n, _, rec = stream(files, "reads")
    assert n == 200
    subs = [r for r in named(rec, "fem::submit") if r["tier"] == 0]
    drains = named(rec, "fem::drain")
    assert sorted(r["batch"] for r in subs) == sorted(r["batch"] for r in drains) == [0, 1, 2, 3]
    by_batch = {r["batch"]: r for r in subs}
    for dr in drains:
        assert dr["cause"] == by_batch[dr["batch"]]["id"] and dr["parent"] is None
        assert dr["thread"] != by_batch[dr["batch"]]["thread"]
    for child in ("fem::step.dispatch", "fem::drain.wait", "fem::drain.unpack", "fem::splice"):
        assert sorted(r["batch"] for r in named(rec, child)) == [0, 1, 2, 3], child
    stream_thread = {r["thread"] for r in named(rec, "fem::stream.wait")}
    assert stream_thread == {r["thread"] for r in subs} == {r["thread"] for r in
                                                           named(rec, "fem::feed.wait")}


@pytest.mark.parametrize("name,caps", [("reads", {}), ("sat", {"cap_occ": 32, "cap_cand": 32})])
def test_emitted_reads_sum_to_the_stream(files, name, caps):
    """Every read is emitted once, by the drain of whichever tier mapped
    it: with the retry ladder at work too (tier-1 batches flushed from the
    pool, drained without a parent on their threads)."""
    n, engine, rec = stream(files, name, **caps)
    assert engine.fallback_reads == 0
    assert sum(r["reads"] for r in named(rec, "fem::emit")) == n
    if caps:
        assert engine.retried_reads > 0
        flushes = named(rec, "fem::retry.flush")
        assert flushes and all(r["tier"] == 1 and r["batch"] < 0 for r in flushes)
        synced = sum(r["reads"] for r in named(rec, "fem::retry.sync"))
        assert sum(r["reads"] for r in flushes) + synced == engine.retried_reads
        retry_drains = [r for r in named(rec, "fem::drain") if r["tier"] == 1]
        assert {r["batch"] for r in retry_drains} == {r["batch"] for r in flushes}


def test_parsed_reads_equal_the_reads_fed(files):
    n, _, rec = stream(files, "reads")
    parses = named(rec, "fem::parse")
    assert sum(r["reads"] or 0 for r in parses) == n == 200
    assert len({r["thread"] for r in parses}) == 1
    assert parses[0]["thread"] not in {r["thread"] for r in named(rec, "fem::submit")}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(metrics, "SPAN_CAP", 5)
    tracing(True)
    for _ in range(8):
        with span("fem::x"):
            with span("fem::y"):
                pass
    tracing(False)
    rec = take_spans()
    assert len(rec["records"]) == 5 and rec["dropped"] == 11
    assert sorted(r["id"] for r in rec["records"]) == [0, 1, 2, 3, 4]


def test_threads_record_without_losing_a_span():
    """More threads than cores, switching every microsecond: every span
    kept once, ids unique, each thread's parents its own."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing(True)

        def work(k):
            for _ in range(300):
                with span("fem::outer", batch=k):
                    with span("fem::inner"):
                        pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        tracing(False)
    finally:
        sys.setswitchinterval(old)
    rec = take_spans()
    recs = [r for r in rec["records"] if r["name"] != "fem::gc"]
    assert len(recs) == 24 * 600 and rec["dropped"] == 0
    assert len({r["id"] for r in recs}) == len(recs)
    outer = {r["id"]: r for r in recs if r["name"] == "fem::outer"}
    for r in recs:
        if r["name"] == "fem::inner":
            up = outer[r["parent"]]
            assert up["thread"] == r["thread"] and up["batch"] == r["batch"]


def test_clock_is_the_profiler_host_events_clock():
    """A span and a record_function opened around the same call start
    within 50 us of each other (the median of 20 such pairs)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing(True)
        for k in range(20):
            with record_function(f"probe{k}"), span("fem::probe", batch=k):
                x.sum()
        tracing(False)
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    spans = named(take_spans(), "fem::probe")
    assert len(spans) == len(starts) == 20
    gaps = [abs(r["start_ns"] - starts[f"probe{r['batch']}"]) for r in spans]
    assert statistics.median(gaps) < 50_000, gaps


def test_a_forced_collection_is_a_gc_span():
    tracing(True)
    with span("fem::drain", batch=3):
        gc.collect()
    tracing(False)
    rec = take_spans()
    (d,) = named(rec, "fem::drain")
    gcs = [r for r in named(rec, "fem::gc") if r["parent"] == d["id"]]
    assert gcs and all(d["start_ns"] <= g["start_ns"] <= g["end_ns"] <= d["end_ns"] for g in gcs)
    assert gcs[0]["batch"] == 3
    assert metrics._gc_hook not in gc.callbacks


def test_profile_writes_the_spans_beside_the_trace(files, tmp_path):
    """`map --profile DIR` turns tracing on and writes spans.json beside
    trace.json, on its clock: a trace event's `ts` + the trace's
    `baseTimeNanoseconds` / 1000 is Unix-epoch us, and the spans lie among
    its host events."""
    d = files
    assert cli.main(["index", "12", "3", str(d / "ref.fa"), str(tmp_path / "ref.index")]) == 0
    prof = tmp_path / "prof"
    assert cli.main(["map", "-e", "2", "--ref", str(d / "ref.fa"), "--index",
                     str(tmp_path / "ref.index"), "--read1", str(d / "reads.fq"), "-o",
                     str(tmp_path / "p.sam"), "--batch-size", "64", "--device", "cpu",
                     "--profile", str(prof)]) == 0
    rec = json.loads((prof / "spans.json").read_text())
    assert sum(r["reads"] for r in named(rec, "fem::emit")) == 200
    assert len([r for r in named(rec, "fem::submit") if r["tier"] == 0]) == 4
    trace = json.loads((prof / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"] / 1e3
    ts = [e["ts"] + base for e in trace["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    starts = [r["start_ns"] / 1e3 for r in rec["records"]]
    assert min(ts) - 1e5 < min(starts) and max(starts) < max(ts) + 1e5
    assert metrics._active is None
