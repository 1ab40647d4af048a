"""The benchmark's machinery, shared by `run.py` and the tests: finding a
cell's files by name, making its inputs, driving the program's stream,
and checking what the stream produced against the reference.

What belongs to one configuration, traffic mix or metric lives in a file
of its own, found by name: fembench/configs/<config>.json,
fembench/traffic/<mix>.json, fembench/metrics/<metric>.py (a `read(run)`
returning the metric's value, or None where it finds nothing to read).

From the program (fem_tpu_torch) this module takes the system under
test: `MappingEngine.map_stream` at the default `EngineConfig`, fed as
the command line feeds it (`fastx.stream_fastq_batches` on a FASTQ file,
through a `ThreadedBatchSource`), the inputs' types (`Reference`,
`FemIndex`), `engine.watermark_reads`, `engine.report()` and
`kernels.launches`.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import os
import resource
import statistics
import tempfile
import threading
import time

import numpy as np
import torch

from fembench import reads as reads_mod
from fembench import trace as trace_mod
from fembench.genome import make_genome
from fembench.index import build_index
from fembench.reference.fem import PlainFem

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# A window ends after this many device steps (filter-tail launches, one a
# step at any tier) if its seconds have not run out first: every run on the
# card profiles its window, the profiler keeps ~800 device operations a step
# and takes ~30 us an operation to stop and read, so a faster program cannot
# push a run past its time limit.
TRACE_STEPS = 2500
# The warm-up streams rounds of WARM_BATCHES batches until a round has
# captured no step program (every key the traffic met dispatched twice
# before it: eager and captured, then replayed), at most one pass of the
# pool.
WARM_BATCHES = 8
# The check samples CHECK_READS reads of CHECK_BATCHES pool batches drawn
# from the seed, and those batches' CHECK_TOP_READS most-mapped reads.
CHECK_BATCHES = 2
CHECK_READS = 3000
CHECK_TOP_READS = 64
COUNTERS = ("num_reads", "num_mapped_reads", "num_candidates_without_additional_qgram_filter",
            "num_candidates", "num_mappings")


# ----------------------------------------------------------------- registry

def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str, base: str = HERE) -> dict:
    """fembench/<kind>/<name>.json (kind: configs or traffic)."""
    with open(os.path.join(base, kind, name + ".json")) as f:
        return json.load(f)


def metric_reader(name: str, base: str = HERE):
    """The `read` function of fembench/metrics/<name>.py."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("fembench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that `cell` reports: an entry
    with `workloads` where it lists the cell; a per-layer one without, where
    the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench.get("per_layer", [])
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


# ------------------------------------------------------------------- inputs

@dataclasses.dataclass
class Inputs:
    """A cell's inputs: the configuration's genome and index, the run's
    read pool."""

    fem: dict
    names: list
    seqs: list
    flat: np.ndarray
    offsets: np.ndarray
    lookup: np.ndarray
    occurrences: np.ndarray
    pool: reads_mod.Pool
    batch_size: int
    timings: dict


def make_inputs(config: dict, traffic: dict, seed: int, device, batch_size: int) -> Inputs:
    """Genome, index and read pool of a configuration and mix. The genome
    comes from the configuration's own seed, the same in every run, as a
    deployment maps against one reference; the reads from `seed`."""
    t = {}
    t0 = time.perf_counter()
    names, seqs, flat, offsets = make_genome(config["genome"], config["genome"]["seed"],
                                             device=device)
    t["genome_s"] = time.perf_counter() - t0
    fem = config["fem"]
    t0 = time.perf_counter()
    lookup, occurrences = build_index(seqs, fem["kmer_size"], fem["step_size"], device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lengths = np.array([len(s) for s in seqs], np.int64)
    pool = reads_mod.make_pool(traffic, flat, offsets, lengths, batch_size, seed)
    t["pool_s"] = time.perf_counter() - t0
    return Inputs(fem, names, seqs, flat, offsets, lookup, occurrences, pool, batch_size, t)


def make_engine(inputs: Inputs, device, engine_config=None):
    """The program as `python -m fem_tpu_torch map -e E -a A -t 1` builds it:
    FemArgs of the configuration, EngineConfig() at the program's defaults
    (tests pass a smaller one to run on the CPU)."""
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.storage import FemIndex
    from fem_tpu_torch.io.fastx import Reference
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine

    f = inputs.fem
    args = FemArgs(kmer_size=f["kmer_size"], step_size=f["step_size"],
                   error_threshold=f["error_threshold"],
                   num_additional_qgrams=f["num_additional_qgrams"], num_threads=1)
    lengths = np.array([len(s) for s in inputs.seqs], np.int64)
    reference = Reference(list(inputs.names), list(inputs.seqs), lengths, inputs.offsets,
                          inputs.flat)
    index = FemIndex(f["kmer_size"], f["step_size"], inputs.lookup, inputs.occurrences)
    return MappingEngine(args, reference, index, engine_config or EngineConfig(),
                         device=device)


# --------------------------------------------------------------------- feed

class Feed:
    """The pool's FASTQ file as the command line reads it: batches of the
    engine's batch size from `fastx.stream_fastq_batches` (the native
    reader), parsed ahead on a `ThreadedBatchSource`'s thread, the file
    read again from its start at its end. Counts every pool batch's pulls
    and stamps the time the engine asked for each and the stream position
    of its last read."""

    def __init__(self, path: str, n_reads: int, batch_size: int):
        self.path, self.B = path, batch_size
        self.n_batches = n_reads // batch_size
        self.pulls = np.zeros(self.n_batches, np.int64)

    def _cycle(self, halt: threading.Event):
        from fem_tpu_torch.io.fastx import stream_fastq_batches

        while not halt.is_set():
            for batch in stream_fastq_batches(self.path, self.B):
                yield batch
                if halt.is_set():
                    return

    def stream(self, stop: threading.Event, max_pulls: int | None, log: list):
        """Batches from the file's start until `stop` is set or `max_pulls`
        were pulled; (time, end) per pull in `log`, `end` the stream
        position after the batch's last read. The reader's thread ends
        with the stream."""
        from fem_tpu_torch.pipeline.prefetch import ThreadedBatchSource

        halt = threading.Event()
        source = iter(ThreadedBatchSource(self._cycle(halt)))
        n = 0
        try:
            while not stop.is_set() and (max_pulls is None or n < max_pulls):
                asked = time.perf_counter()
                batch = next(source)
                self.pulls[n % self.n_batches] += 1
                n += 1
                log.append((asked, n * self.B))
                yield batch
        finally:
            halt.set()
            for _ in source:  # frees the reader's thread, which then ends
                pass

    def read_pulls(self) -> np.ndarray:
        """(pool,) how often each read was pulled."""
        return np.repeat(self.pulls, self.B)


# ------------------------------------------------------------------- stream

def name_prefixes(lo: int, hi: int) -> list:
    """The fewest name prefixes that start exactly the names of reads
    [lo, hi) (NAME_DIGITS digits, zero-padded)."""
    out = []
    while lo < hi:
        k = 0
        while k + 1 < reads_mod.NAME_DIGITS and lo % 10 ** (k + 1) == 0 \
                and lo + 10 ** (k + 1) <= hi:
            k += 1
        out.append(str(lo // 10 ** k).zfill(reads_mod.NAME_DIGITS - k).encode())
        lo += 10 ** k
    return out


class Sink:
    """The consumer of the stream's items: counts every item's SAM lines
    and keeps the items that hold a line of a read of the `watch` pool
    batches (those the check samples): a line starts with its read's name,
    so an item is kept where a chunk starts with, or holds after a newline,
    a prefix that only those reads' names have. `transform(chunks)` stands
    another output in the program's place (the control)."""

    def __init__(self, watch, batch_size: int, transform=None):
        self.transform = transform
        self.starts = [p for j in sorted(int(j) for j in watch)
                       for p in name_prefixes(j * batch_size, (j + 1) * batch_size)]
        self.inner = [b"\n" + p for p in self.starts]
        self.lines = 0
        self.items: list = []

    def add(self, chunks: list) -> None:
        if self.transform is not None:
            chunks = self.transform(chunks)
        keep = False
        for c in chunks:
            if c:
                self.lines += c.count(b"\n")
                keep = keep or any(c.startswith(p) for p in self.starts) \
                    or any(p in c for p in self.inner)
        if keep:
            self.items.append(chunks)


def host_state() -> dict:
    """The machine's CPU time in jiffies (/proc/stat: all, idle and iowait,
    stolen by the hypervisor) and this process's CPU seconds and
    involuntary context switches: for the run's log."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        v = [0] * 8
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"all": sum(v), "idle": v[3] + v[4], "steal": v[7],
            "cpu_s": ru.ru_utime + ru.ru_stime, "ivcsw": ru.ru_nivcsw}


def host_share(h0: dict, h1: dict, seconds: float) -> dict:
    """Between two host_state readings: the machine's busy and stolen
    shares (%), the cores this process kept busy, its involuntary switches."""
    d = {k: h1[k] - h0[k] for k in h0}
    every = max(d["all"], 1)
    return {"machine_busy_pct": 100.0 * (every - d["idle"]) / every,
            "steal_pct": 100.0 * d["steal"] / every,
            "process_cores": d["cpu_s"] / seconds if seconds > 0 else 0.0,
            "involuntary_switches": d["ivcsw"]}


class GcClock:
    """Seconds the interpreter's garbage collector ran, while installed."""

    def __init__(self):
        self.seconds, self._t = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def fifth_rates(marks: list, t0: float, t_end: float) -> list:
    """Reads/s in each fifth of the window, from (time, watermark) marks."""
    out, w_prev = [], 0
    for k in range(1, 6):
        edge = t0 + (t_end - t0) * k / 5
        w = max((m for t, m in marks if t <= edge), default=0)
        out.append((w - w_prev) * 5 / (t_end - t0) if t_end > t0 else 0.0)
        w_prev = w
    return out


def run_stream(engine, feed: Feed, seconds: float | None = None,
               max_pulls: int | None = None, sink: Sink | None = None, span=None,
               max_steps: int | None = None) -> dict:
    """Map the feed through `engine.map_stream` (unordered, the default
    depth): until `seconds` have passed (the window) or `max_pulls`
    batches (a warm-up pass) or `max_steps` device steps
    (`kernels.launches["filter_tail"]`); then the feed stops and the stream
    drains.

    The window's rate is (watermark at its end - at its start) / its
    seconds: reads whose every record, retried reads' included, reached
    the consumer. A batch's latency runs from the engine pulling it from
    the feed to the first item after which the watermark covers its last
    read; the window's tail is over the batches completed inside it.
    `sink` takes every item's records; `span(name)` is a context manager
    marking the consumer's calls in a trace."""
    import contextlib

    from fem_tpu_torch import kernels

    span = span or (lambda name: contextlib.nullcontext())
    steps0 = kernels.launches["filter_tail"]
    stop = threading.Event()
    pull_log: list = []
    totals = dict.fromkeys(COUNTERS, 0)
    latencies: list = []
    feed.pulls[:] = 0
    report0 = engine.report()
    w0 = engine.watermark_reads
    h0 = host_state()
    t0 = time.perf_counter()
    t_end = w_end = h_end = None
    done = 0  # pulls whose batch completed
    marks: list = []
    gc_clock = GcClock().__enter__()
    it = engine.map_stream(feed.stream(stop, max_pulls, pull_log))
    while True:
        with span("fembench::stream_next"):
            item = next(it, None)
        if item is None:
            break
        with span("fembench::sink"):
            now = time.perf_counter()
            chunks, stats = item
            if sink is not None:
                sink.add(chunks)
            for k in COUNTERS:
                totals[k] += getattr(stats, k)
            w = engine.watermark_reads - w0
            if t_end is None:
                marks.append((now, w))
            while done < len(pull_log) and pull_log[done][1] <= w:
                if t_end is None:
                    latencies.append(now - pull_log[done][0])
                done += 1
            if t_end is None and ((seconds is not None and now - t0 >= seconds) or (
                    max_steps is not None
                    and kernels.launches["filter_tail"] - steps0 >= max_steps)):
                t_end, w_end, h_end = now, w, host_state()
                gc_s = gc_clock.seconds
                stop.set()
    t_drained = time.perf_counter()
    gc_clock.__exit__()
    if t_end is None:
        t_end, w_end, h_end = t_drained, engine.watermark_reads - w0, host_state()
        gc_s = gc_clock.seconds
    report1 = engine.report()
    return {
        "seconds": t_end - t0,
        "drained_s": t_drained - t0,
        "reads_completed": w_end,
        "pulled_reads": len(pull_log) * feed.B,
        "pulled_batches": len(pull_log),
        "latencies_s": latencies,
        "totals": totals,
        "items": sink.items if sink is not None else [],
        "lines": sink.lines if sink is not None else 0,
        "read_pulls": feed.read_pulls(),
        "retried_reads": report1["retried_reads"] - report0["retried_reads"],
        "tier_dispatches": report1["tier_dispatches"] - report0["tier_dispatches"],
        "fallback_reads": report1["fallback_reads"] - report0["fallback_reads"],
        "programs": [[p["key"], p["dispatches"]] for p in report1["programs"]],
        "host": dict(host_share(h0, h_end, t_end - t0), gc_s=gc_s,
                     fifth_rates=fifth_rates(marks, t0, t_end)),
    }


def warm_up(engine, feed: Feed) -> dict:
    """Rounds of WARM_BATCHES batches until a round captured no step
    program (every key it dispatched had dispatched twice before it), or
    a pass of the pool: the reads, retries and seconds it took."""
    t0 = time.perf_counter()
    before: dict = {}
    rounds = pulled = retried = 0
    while True:
        w = run_stream(engine, feed, max_pulls=WARM_BATCHES)
        rounds += 1
        pulled += w["pulled_reads"]
        retried += w["retried_reads"]
        after = {tuple(k): n for k, n in w["programs"]}
        settled = all(before.get(k, 0) >= 2 for k in after)
        before = after
        if settled or pulled >= feed.n_batches * feed.B:
            break
    return {"rounds": rounds, "reads": pulled, "retried": retried, "keys": sorted(after),
            "seconds": time.perf_counter() - t0, "last_round_rate": w["reads_completed"] / w["seconds"]}


# -------------------------------------------------------------------- check

def parse_items(items: list, pool_size: int, want: np.ndarray) -> dict:
    """The kept items' SAM lines: how many are not a record of a pool read
    (`bad`), and the lines of the reads that `want` marks, {read:
    Counter(line)}."""
    bad = 0
    got: dict = collections.defaultdict(collections.Counter)
    power = 10 ** np.arange(reads_mod.NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    for chunks in items:
        for chunk in chunks:
            if not chunk:
                continue
            arr = np.frombuffer(chunk, np.uint8)
            ends = np.flatnonzero(arr == 10)
            if arr[-1] != 10:
                bad += 1
            if not ends.size:
                continue
            starts = np.concatenate([[0], ends[:-1] + 1])
            fits = starts + reads_mod.NAME_DIGITS < ends
            digits = arr[np.minimum(starts[:, None] + np.arange(reads_mod.NAME_DIGITS),
                                    arr.shape[0] - 1)].astype(np.int64) - ord("0")
            ok = fits & ((digits >= 0) & (digits <= 9)).all(1)
            ok &= arr[np.minimum(starts + reads_mod.NAME_DIGITS, arr.shape[0] - 1)] == 9
            idx = np.where(ok, digits @ power, 0)
            ok &= idx < pool_size
            bad += int((~ok).sum())
            for s, e, r in zip(starts[ok & want[idx]].tolist(), ends[ok & want[idx]].tolist(),
                               idx[ok & want[idx]].tolist()):
                got[r][chunk[s: e + 1]] += 1
    return {"bad": bad, "got": got}


def watched_batches(n_batches: int, seed: int) -> np.ndarray:
    """The pool batches whose reads the check samples: CHECK_BATCHES of
    them, drawn from the seed before the window."""
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(n_batches, size=min(CHECK_BATCHES, n_batches), replace=False))


def sample_reads(batches: np.ndarray, batch_size: int, seed: int, nmap: np.ndarray,
                 n_reads: int = CHECK_READS) -> np.ndarray:
    """The reads whose records are compared, all of the watched batches:
    `n_reads` drawn from the seed, and the CHECK_TOP_READS with the most
    mappings."""
    rng = np.random.default_rng([seed, 4])
    reads = (batches[:, None] * batch_size + np.arange(batch_size)).reshape(-1)
    pick = rng.choice(reads, size=min(n_reads, reads.size), replace=False)
    top = reads[np.argsort(-nmap[reads], kind="stable")[:CHECK_TOP_READS]]
    return np.unique(np.concatenate([pick, top]))


def check_run(window: dict, inputs: Inputs, seed: int, device, watched: np.ndarray,
              control=None, check_reads: int = CHECK_READS) -> dict:
    """Compare the window's stream with the reference: the five counters
    summed over the stream against the reference's over every read the
    stream was given (each as often as given); the stream's SAM lines
    against the reference's mappings; and every line of a sample of the
    `watched` batches' reads against the reference's records of that read,
    as often as given (`check_reads` of them and the most-mapped).
    `control(totals)` gives the counters the control reports. Returns {name: (value, limit)}, the reference's seconds."""
    t0 = time.perf_counter()
    f = inputs.fem
    plain = PlainFem(f["kmer_size"], f["step_size"], f["error_threshold"],
                     f["num_additional_qgrams"], inputs.lookup, inputs.occurrences,
                     inputs.names, inputs.seqs, device)
    mapped = plain.map_reads(inputs.pool.codes)
    pulls = window["read_pulls"]
    want = mapped.counters(torch.from_numpy(pulls))
    sample = sample_reads(watched, inputs.batch_size, seed, mapped.nmap.cpu().numpy(),
                          check_reads)
    pool = inputs.pool
    recs = plain.records(mapped, [(int(i), pool.names(i, i + 1).tobytes(),
                                   pool.chars(i, i + 1).tobytes(), pool.quals(i, i + 1))
                                  for i in sample])
    ref_s = time.perf_counter() - t0
    totals = control(window["totals"]) if control else window["totals"]
    mask = np.zeros(pool.size, bool)
    mask[sample] = True
    parsed = parse_items(window["items"], pool.size, mask)
    wrong = 0
    for i in sample.tolist():
        expect = collections.Counter()
        for r in recs[i]:  # a read's records may repeat a line
            expect[r] += int(pulls[i])
        if parsed["got"].get(i, collections.Counter()) != +expect:
            wrong += 1
    short = {"num_reads": "reads_gap", "num_mapped_reads": "mapped_gap",
             "num_candidates_without_additional_qgram_filter": "prefilter_gap",
             "num_candidates": "candidates_gap", "num_mappings": "mappings_gap"}
    checks = {"wrong_reads": (wrong, 0), "bad_lines": (parsed["bad"], 0),
              "lines_gap": (abs(window["lines"] - want["num_mappings"]), 0)}
    for k in COUNTERS:
        checks[short[k]] = (abs(totals[k] - want[k]), 0)
    del plain, mapped
    gc.collect()
    return {"checks": checks, "reference_s": ref_s, "sampled_reads": int(sample.size),
            "check_s": time.perf_counter() - t0}


def best_only_records(chunks: list) -> list:
    """The control's records: FEM's all-mapping guarantee broken as a
    best-mapper breaks it, each read keeping its primary record only."""
    return [b"".join(line + b"\n" for line in c.split(b"\n")[:-1]
                     if not int(line.split(b"\t", 2)[1]) & 256) for c in chunks]


def best_only_counters(totals: dict) -> dict:
    """The control's counters: it counts the mappings it kept."""
    return dict(totals, num_mappings=totals["num_mapped_reads"])


CONTROLS = {"best_only": (best_only_records, best_only_counters)}


# --------------------------------------------------------------------- cell

def run_cell(bench: dict, workload: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device, start_time: float, log,
             engine_config=None, control: str | None = None, keep: dict | None = None) -> dict:
    """One run of a cell: make the inputs and write the reads' FASTQ file
    (under the temporary directory, removed at the end), build the engine,
    warm it up (`warm_up`), drive the window, free the engine, check the
    window's output against the reference, and read the cell's metrics
    (end-to-end ones, or with `trace` the per-layer ones; on a card the
    window runs under torch.profiler, its device alone, or with `trace` the
    host's calls too). Returns the result line's fields; `device` and the checks
    included. `keep`, where given, receives what the metric readers read
    (the window without its records, the trace's summary)."""
    from fem_tpu_torch.pipeline.engine import EngineConfig

    dev = torch.device(device)
    B = (engine_config or EngineConfig()).batch_size
    inputs = make_inputs(config, traffic, seed, dev, B)
    fd, path = tempfile.mkstemp(prefix="fembench-", suffix=".fq")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        size = reads_mod.write_fastq(inputs.pool, path)
        log(f"[setup] genome {inputs.timings['genome_s']:.2f} s, index "
            f"{inputs.timings['index_s']:.2f} s ({inputs.occurrences.shape[0]} occurrences), "
            f"pool {inputs.timings['pool_s']:.2f} s ({inputs.pool.size} reads, mean "
            f"{inputs.pool.edits.mean():.3f} edits), FASTQ {time.perf_counter() - t0:.2f} s "
            f"({size} B)")
        return _run(bench, workload, inputs, Feed(path, inputs.pool.size, B), seed, seconds,
                    trace, dev, start_time, log, engine_config, control, keep)
    finally:
        os.unlink(path)


def _run(bench, workload, inputs, feed, seed, seconds, trace, dev, start_time, log,
         engine_config, control, keep) -> dict:
    from fem_tpu_torch import kernels

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = make_engine(inputs, dev, engine_config)
    log(f"[setup] engine {time.perf_counter() - t0:.2f} s")
    warm = warm_up(engine, feed)
    log(f"[setup] warm-up {warm['seconds']:.2f} s: {warm['rounds']} rounds, {warm['reads']} reads, "
        f"the last at {warm['last_round_rate']:.1f} reads/s, retried {warm['retried']}, "
        f"step programs {warm['keys']}")
    launches0 = dict(kernels.launches)
    prof = None
    if trace or on_card:
        # Every run on the card profiles the device (reads_per_device_s is
        # read from its trace); a traced run adds the host's calls and the
        # harness's spans for the per-layer metrics.
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = ([ProfilerActivity.CPU] if trace else []) + \
            ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.__enter__()
    setup_s = time.time() - start_time
    watched = watched_batches(feed.n_batches, seed)
    records, counters = CONTROLS[control] if control else (None, None)
    window = run_stream(engine, feed, seconds=seconds, sink=Sink(watched, feed.B, records),
                        span=record_function if trace else None,
                        max_steps=TRACE_STEPS)
    if on_card:
        torch.cuda.synchronize(dev)
    traced = None
    if prof is not None:
        t0 = time.perf_counter()
        prof.__exit__(None, None, None)
        log(f"[trace] the profiler stopped in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        traced = trace_mod.collect(prof, window["drained_s"])
        seen = {k: trace_mod.kernel_seconds(traced, k)[1] for k in ("filter_tail", "banded_myers")}
        log(f"[trace] {sum(c for _, c in traced['ops'].values())} device operations of "
            f"{len(traced['ops'])} kinds, read in {time.perf_counter() - t0:.2f} s; the "
            f"profiler saw {seen} of the port's kernels")
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launched = {k: kernels.launches[k] - launches0.get(k, 0) for k in kernels.launches}
    host = window["host"]
    lat = window["latencies_s"]
    p95 = f"{statistics.quantiles(lat, n=100)[94] * 1e3:.3f} ms" if len(lat) >= 20 else "-"
    log(f"[window] {window['seconds']:.3f} s, {window['reads_completed']} reads completed, "
        f"{window['pulled_reads']} pulled, {len(lat)} batches completed inside (p95 {p95}), "
        f"drained at {window['drained_s']:.3f} s; retried {window['retried_reads']}, "
        f"tier dispatches {window['tier_dispatches']}, host-mapped {window['fallback_reads']}, "
        f"step programs {window['programs']}, launches {launched}, peak device {peak} B")
    log(f"[host] machine busy {host['machine_busy_pct']:.1f}%, stolen {host['steal_pct']:.2f}%, "
        f"this process {host['process_cores']:.2f} cores, "
        f"{host['involuntary_switches']} involuntary switches, garbage collection "
        f"{host['gc_s']:.3f} s in the window; reads/s by fifth of it "
        f"{[round(r, 1) for r in host['fifth_rates']]}")
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check = check_run(window, inputs, seed, dev, watched, counters)
    log(f"[check] reference {check['reference_s']:.2f} s, check {check['check_s']:.2f} s, "
        f"{check['sampled_reads']} reads' records compared")
    run = {"window": window, "setup_s": setup_s, "trace": traced, "fem": inputs.fem,
           "read_length": inputs.pool.codes.shape[1]}
    if keep is not None:
        keep.update(run, window={k: v for k, v in window.items()
                                 if k not in ("items", "read_pulls")})
    e2e, layer = cell_metrics(bench, workload["name"])
    metrics = {}
    for m in (layer if trace else e2e):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = check["checks"]
    out = {
        "correct": all(v <= limit for v, limit in checks.values()),
        "attempted": window["pulled_reads"],
        "failed": max(window["pulled_reads"] - window["totals"]["num_reads"], 0),
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(peak)},
        "checks": {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()},
    }
    if trace and traced is not None:
        out["device"]["busy_s"] = traced["busy_s"]
        out["device"]["window_s"] = traced["window_s"]
        out["breakdown"] = trace_mod.breakdown(traced)
    return out
