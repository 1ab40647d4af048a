"""GRCh38-scale differential run of the PyTorch/CUDA port against fem_baseline.

The port of tools/grch38_scale.py, run through the command line as users run
it. A synthetic genome with GRCh38's 24-chromosome length profile (about 20%
repeats: segments of 500-5,000 bp re-inserted with 1% divergence; seed 2024)
of --gb gigabases (3.0 by default) is indexed and mapped:

  synthesize  the genome, written as FASTA (sim.write_fasta);
  reads       --reads simulated 100 bp reads with up to 5 errors (seed 77)
              as FASTQ, and a FASTQ of the first --golden-reads of them;
              then the tool lets the genome go;
  index       `python -m fem_tpu_torch index 12 3` and `fem_baseline index
              12 3`; the two files must be byte-equal (compared by digest);
              the occurrence count is printed (999,999,915 at 3.0 Gb, two
              under the u32 CSR guard);
  map         `python -m fem_tpu_torch map -e 5 -a 1` with the command
              line's defaults (B=10,000, tier 0's cap_occ derived from the
              index: 576 at 3.0 Gb, 256 at 0.25 Gb; cap_cand 256, verify
              16 and accept 4 slots a read, the default ladder) on one
              device (the first card alone), unsharded; its SAM record multiset and five counters
              against `fem_baseline map -e 5 -a 1` on the same reads (once a
              --baseline-threads count, each equal), the golden oracle
              (`map --engine golden`) on the first reads as their records in
              read order, and every kernel launched (on the card);
  map_grid    the same map with --index-shards N (4 by default; 1 skips
              it) on a (1, N) grid, every cell on the first card; on a
              machine with N cards or more also once over N cards
              (map_grid_cards). Each equal to the same fem_baseline run.

The tool's process holds file paths, not indexes: every build and map is a
process of its own, whose peak RSS (os.wait4) is printed beside its
seconds; a map also writes --engine-json (peak device memory, retries,
kernel launches by shape, each grid cell's occurrences and reference
bytes, the step programs: on the card a map whose dispatch after a key's
first replays no CUDA graph fails, the grid's included). fem_baseline's reads/s are net of its load: its wall on the reads
less its wall on an empty read file. One line a stage, the card's name and
power limit on each; the last line is a JSON object of all stages. The run
stops at the first stage that differs, and exits 1.

    python tools/torch_grch38_scale.py                          # on the card
    python tools/torch_grch38_scale.py --device cpu --gb 0.003 --reads 300 \\
        --batch-size 64 --index-shards 2 --golden-reads 16 --baseline-threads 2

Disk: the FASTA, two index files, the reads and the SAMs, about 20 GB at
3.0 Gb (checked before anything is written; --workdir, default a new
directory under the system's temporary directory, removed after unless
--keep). Host memory: a map process holds the reference (three copies of
3 GB) and the index (8 GB); the grid's holds the shards (11 GB) beside
them while it builds them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from fem_tpu_torch.pipeline import cli  # noqa: E402  (no torch: cli imports it in map)

# tools/grch38_scale.py's genome: GRCh38's chromosome lengths (Mb), the
# seed, and its repeat content (segment lengths, divergence, share).
PROFILE_MB = (248, 242, 198, 190, 182, 171, 159, 145, 138, 134,
              135, 133, 114, 107, 102, 90, 83, 80, 59, 64,
              47, 51, 156, 57)
GENOME_SEED = 2024
SEGMENT_BP = (500, 5000)
DIVERGENCE = 0.01
REPEAT_SHARE = 0.2
READ_SEED = 77
READ_LENGTH = 100
E, A, K, STEP = 5, 1, 12, 3
KERNELS = ("filter_tail", "banded_myers", "occ_slab", "verify_slab", "accept_slab")
COUNTER_NAMES = ("reads", "mapped reads", "candidates before the additional q-gram filter",
                 "candidates", "mappings")


class StageFailed(Exception):
    """A stage's output differs from its reference."""


def chromosome_lengths(gb: float) -> np.ndarray:
    """The profile scaled to `gb` gigabases, as tools/grch38_scale.py
    scales it."""
    profile = np.array(PROFILE_MB, dtype=np.float64)
    return (profile / profile.sum() * gb * 1e9).astype(np.int64)


def genome(gb: float, seed: int = GENOME_SEED) -> list:
    """[(name, seq)] of tools/grch38_scale.py's synthetic genome scaled to
    `gb` gigabases: the same lengths, the same random stream, the same
    bytes."""
    lengths = chromosome_lengths(gb)
    rng = np.random.default_rng(seed)
    to_acgt = bytes.maketrans(bytes(range(4)), b"ACGT")
    out = []
    for i, ln in enumerate(lengths):
        codes = rng.integers(0, 4, size=int(ln), dtype=np.int8)
        target = int(ln * REPEAT_SHARE)
        placed = 0
        while placed < target:
            seg_len = int(rng.integers(*SEGMENT_BP))
            src = int(rng.integers(0, max(int(ln) - seg_len, 1)))
            dst = int(rng.integers(0, max(int(ln) - seg_len, 1)))
            seg = codes[src : src + seg_len].copy()
            muts = rng.random(seg_len) < DIVERGENCE
            seg[muts] = rng.integers(0, 4, size=int(muts.sum()), dtype=np.int8)
            codes[dst : dst + seg_len] = seg
            placed += seg_len
        out.append((b"chr%d" % (i + 1), codes.tobytes().translate(to_acgt)))
        del codes
    return out


def index_bytes(gb: float) -> int:
    """Size of a k=12 step=3 index file of the genome: header, the
    4^12 + 1 u32 offsets, the u64 count and 8 bytes an occurrence."""
    windows = int(sum(len(range(0, int(n) - K + 1, STEP)) for n in chromosome_lengths(gb)))
    return 8 + 4 * ((1 << 2 * K) + 1) + 8 + 8 * windows


def rss_peak_self() -> int:
    """This process's peak RSS in bytes since the last `reset_rss_peak`."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def reset_rss_peak() -> None:
    """Start this process's peak RSS anew (Linux: clear_refs 5)."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def gib(n: int | None) -> str:
    return "not used" if n is None else f"{n / 2**30:.2f} GiB"


class Runner:
    """Runs the stages' processes and keeps their logs under workdir/logs."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.logs = os.path.join(workdir, "logs")
        os.makedirs(self.logs, exist_ok=True)
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = REPO + os.pathsep + self.env.get("PYTHONPATH", "")

    def run(self, tag: str, argv: list, env: dict | None = None) -> dict:
        """Run argv to its end; its seconds, peak RSS and stderr. Raises
        with the stderr's tail if it fails."""
        out_path = os.path.join(self.logs, tag + ".out")
        err_path = os.path.join(self.logs, tag + ".err")
        t0 = time.perf_counter()
        with open(out_path, "wb") as out, open(err_path, "wb") as err:
            p = subprocess.Popen(argv, stdout=out, stderr=err, cwd=self.workdir,
                                 env=dict(self.env, **(env or {})))
            _, status, usage = os.wait4(p.pid, 0)
            p.returncode = os.waitstatus_to_exitcode(status)
        seconds = time.perf_counter() - t0
        with open(err_path, "r", errors="replace") as f:
            stderr = f.read()
        if p.returncode != 0:
            raise RuntimeError(f"{tag}: {' '.join(map(str, argv))} exited {p.returncode}:\n"
                               f"{stderr[-3000:]}")
        return {"seconds": seconds, "rss_bytes": usage.ru_maxrss * 1024, "stderr": stderr}

    def port(self, tag: str, *args, env: dict | None = None) -> dict:
        return self.run(tag, [sys.executable, "-m", "fem_tpu_torch", *map(str, args)], env)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def digests(paths: list) -> list:
    """sha256 of each file, the files read side by side."""
    out = [None] * len(paths)

    def one(i):
        out[i] = sha256(paths[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(paths))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def occurrences_in(path: str) -> int:
    """The occurrence count of an index file (after k, step and the lookup)."""
    with open(path, "rb") as f:
        k = int(np.fromfile(f, "<i4", 1)[0])
        f.seek(8 + 4 * ((1 << 2 * k) + 1))
        return int(np.fromfile(f, "<u8", 1)[0])


def sam_records(path: str) -> list:
    """The SAM file's record lines (no header), in file order."""
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if ln and not ln.startswith(b"@")]


def counters(stderr: str) -> list:
    from fem_tpu_torch.bench import _counters_from_stderr

    got = _counters_from_stderr(stderr)
    if len(got) != 5:
        raise RuntimeError(f"no five counter lines in: {stderr[-2000:]}")
    return got


def kernels_launched(launches: dict) -> bool:
    """Each of KERNELS launched at least once; a count that is missing
    is none."""
    return all(launches.get(k, 0) > 0 for k in KERNELS)


def first_difference(got: list, want: list) -> str:
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"record {i}: {g[:120]!r} vs {w[:120]!r}"
    return f"{len(got)} records vs {len(want)}"


def records_by_read(records: list, names: list) -> bytes:
    """The records of the reads `names`, a read's records in the order the
    file holds them, the reads in the order given (the engine emits each
    read's records together; its stream is not in read order)."""
    by_name: dict = {}
    for r in records:
        by_name.setdefault(r.split(b"\t", 1)[0], []).append(r)
    return b"\n".join(r for n in names for r in by_name.get(n, []))


def stage_synthesize(a, paths: dict) -> tuple[dict, list]:
    from fem_tpu_torch import sim

    reset_rss_peak()
    t0 = time.perf_counter()
    seqs = genome(a.gb)
    sim.write_fasta(paths["fa"], seqs)
    total = sum(len(s) for _, s in seqs)
    st = {"stage": "synthesize", "ok": True, "seconds": time.perf_counter() - t0,
          "rss_bytes": rss_peak_self(), "device_bytes": None, "bases": total,
          "chromosomes": len(seqs), "fasta_bytes": os.path.getsize(paths["fa"])}
    return st, seqs


def stage_index(a, run: Runner, baseline: str, paths: dict) -> dict:
    port = run.port("index_port", "index", K, STEP, paths["fa"], paths["ix"])
    base = run.run("index_baseline", [baseline, "index", str(K), str(STEP), paths["fa"],
                                      paths["ix_base"]])
    t0 = time.perf_counter()
    d_port, d_base = digests([paths["ix"], paths["ix_base"]])
    digest_s = time.perf_counter() - t0
    n = occurrences_in(paths["ix"])
    st = {"stage": "index", "ok": d_port == d_base, "seconds": port["seconds"],
          "rss_bytes": port["rss_bytes"], "device_bytes": None,
          "baseline_seconds": base["seconds"], "baseline_rss_bytes": base["rss_bytes"],
          "digest_seconds": digest_s, "index_bytes": os.path.getsize(paths["ix"]),
          "baseline_index_bytes": os.path.getsize(paths["ix_base"]),
          "sha256": d_port, "baseline_sha256": d_base, "occurrences": n,
          "u32_headroom": (1 << 32) - 1 - n}
    m = re.search(r"Built index in ([\d.]+)s", port["stderr"])
    st["build_seconds"] = float(m.group(1)) if m else None
    if not st["ok"]:
        st["why"] = "the port's index file differs from fem_baseline's"
    return st


def stage_reads(a, paths: dict, seqs: list) -> dict:
    from fem_tpu_torch import sim

    reset_rss_peak()
    t0 = time.perf_counter()
    reads = sim.simulate_reads(seqs, a.reads, read_length=READ_LENGTH, max_errors=E,
                               seed=READ_SEED)
    sim.write_fastq(paths["fq"], reads)
    sim.write_fastq(paths["fq_golden"], reads[: a.golden_reads])
    sim.write_fastq(paths["fq_empty"], [])
    return {"stage": "reads", "ok": True, "seconds": time.perf_counter() - t0,
            "rss_bytes": rss_peak_self(), "device_bytes": None, "reads": len(reads),
            "golden_reads": min(a.golden_reads, len(reads)),
            "golden_names": [r.name.decode() for r in reads[: a.golden_reads]]}


def baseline_maps(a, run: Runner, baseline: str, paths: dict) -> dict:
    """fem_baseline on the reads once a thread count (the records of each
    must be equal), and on an empty read file for its load time."""
    flags = ["map", "-e", str(E), "-a", str(A), "--ref", paths["fa"],
             "--index", paths["ix_base"]]
    load = run.run("baseline_load", [baseline, *flags, "-t", "1", "--read1",
                                     paths["fq_empty"], "-o", os.devnull])
    out = {"load_seconds": load["seconds"], "by_threads": {}}
    for t in a.baseline_threads:
        sam = os.path.join(run.workdir, f"baseline_t{t}.sam")
        r = run.run(f"baseline_map_t{t}", [baseline, *flags, "-t", str(t), "--read1",
                                           paths["fq"], "-o", sam])
        recs = sorted(sam_records(sam))
        if "records" not in out:
            out["records"], out["counters"] = recs, counters(r["stderr"])
            out["file_records"] = sam_records(sam)
            out["sam"] = sam
        elif recs != out["records"]:
            why = f"fem_baseline -t {t} differs from -t {a.baseline_threads[0]}"
            print(f"FAIL fem_baseline: {why}", flush=True)
            raise StageFailed(why)
        if not a.keep or out["sam"] != sam:
            os.unlink(sam)
        net = r["seconds"] - load["seconds"]
        out["by_threads"][str(t)] = {
            "seconds": r["seconds"], "rss_bytes": r["rss_bytes"],
            "reads_per_s": a.reads / net if net > 0 else None}
    return out


def stage_map(a, run: Runner, name: str, paths: dict, base: dict, golden: tuple,
              shards: int = 1, env: dict | None = None) -> dict:
    """One `python -m fem_tpu_torch map` against fem_baseline's records and
    counters, and the golden oracle's records of its reads: `golden` is
    (read names, the oracle's records of them in read order)."""
    sam = os.path.join(run.workdir, f"{name}.sam")
    ej = os.path.join(run.workdir, f"{name}.json")
    argv = ["map", "-e", E, "-a", A, "--ref", paths["fa"], "--index", paths["ix"],
            "--read1", paths["fq"], "-o", sam, "--device", a.device, "--engine-json", ej]
    if a.batch_size:
        argv += ["--batch-size", a.batch_size]
    if shards > 1:
        argv += ["--index-shards", shards]
    r = run.port(name, *argv, env=env)
    with open(ej) as f:
        eng = json.load(f)
    file_recs = sam_records(sam)
    if not a.keep:
        os.unlink(sam)
    recs = sorted(file_recs)
    got = counters(r["stderr"])
    st = {"stage": name, "seconds": r["seconds"], "rss_bytes": r["rss_bytes"],
          "device_bytes": max(eng["peak_device_bytes"].values(), default=None),
          "peak_device_bytes": eng["peak_device_bytes"],
          "records_equal": recs == base["records"], "counters_equal": got == base["counters"],
          "records": len(recs), "counters": got, "baseline_counters": base["counters"],
          "retried": eng["retried_reads"], "tier_dispatches": eng["tier_dispatches"],
          "dispatches_by_tier": eng["dispatches_by_tier"], "host_mapped": eng["fallback_reads"],
          "steady_reads_per_s": eng["steady_reads_per_s"], "stream_seconds": eng["stream_s"],
          "load_seconds": eng["load_s"], "kernel_launches": eng["kernel_launches"],
          "launches_by_shape": eng["launches_by_shape"], "cells": eng["cells"],
          "programs": eng["programs"],
          "baseline_reads_per_s": {t: v["reads_per_s"] for t, v in base["by_threads"].items()}}
    launched = kernels_launched(eng["kernel_launches"]) if a.device != "cpu" else True
    st["kernels_launched"] = launched
    why = []
    if not st["records_equal"]:
        why.append("SAM records differ from fem_baseline's: "
                   + first_difference(recs, base["records"]))
    if not st["counters_equal"]:
        why += [f"{n}: engine {g}, fem_baseline {w}"
                for n, g, w in zip(COUNTER_NAMES, got, base["counters"]) if g != w]
    if not launched:
        why.append(f"a kernel never launched: {eng['kernel_launches']}")
    if a.device != "cpu" and cli.eager_dispatches(eng["programs"]):
        why.append("a dispatch after its key's first replayed no graph: "
                   + cli.programs_line(eng["programs"]))
    names, oracle = golden
    st["golden_equal"] = records_by_read(file_recs, names) == oracle
    st["golden_baseline_equal"] = records_by_read(base["file_records"], names) == oracle
    if not st["golden_equal"]:
        why.append(f"the golden oracle's records of the first {len(names)} reads differ")
    if not st["golden_baseline_equal"]:
        why.append("fem_baseline's records of the golden reads differ from the oracle's")
    st["ok"] = not why
    if why:
        st["why"] = "; ".join(why)
    return st


def print_stage(st: dict, card: str) -> None:
    head = (f"{'PASS' if st['ok'] else 'FAIL'} {st['stage']} on {card}: "
            f"{st['seconds']:.1f} s, peak host RSS {gib(st['rss_bytes'])}, "
            f"peak device memory {gib(st['device_bytes'])}")
    s = st["stage"]
    if s == "synthesize":
        more = (f"{st['bases']:,} bases over {st['chromosomes']} chromosomes, FASTA "
                f"{st['fasta_bytes']:,} bytes")
    elif s == "index":
        more = (f"{st['occurrences']:,} occurrences ({st['u32_headroom']:,} under the u32 "
                f"CSR guard), {st['index_bytes']:,} bytes, byte-equal to fem_baseline's "
                f"{st['ok']} (sha256 {st['sha256'][:16]}, {st['digest_seconds']:.1f} s); "
                f"the build {st['build_seconds']} s of the process; fem_baseline index "
                f"{st['baseline_seconds']:.1f} s, peak host RSS "
                f"{gib(st['baseline_rss_bytes'])}")
    elif s == "reads":
        more = f"{st['reads']:,} reads, the first {st['golden_reads']} for the golden oracle"
    elif s == "golden":
        more = f"the oracle on {st['reads']} reads, {st['records']} records"
    else:
        cells = "; ".join(f"cell {tuple(c['cell'])}: {c['occurrences']:,} occurrences, "
                          f"{c['ref_bytes']:,} reference bytes" for c in st["cells"])
        base = ", ".join(f"-t {t} {v:,.1f}" if v else f"-t {t} not measured"
                         for t, v in st["baseline_reads_per_s"].items())
        steady = st["steady_reads_per_s"]
        more = (f"records_equal={st['records_equal']} counters_equal={st['counters_equal']} "
                f"({st['records']:,} records, mappings {st['counters'][4]:,}) "
                + f"golden_equal={st['golden_equal']} "
                + f"retried={st['retried']:,} ({st['retried'] / max(st['counters'][0], 1):.2%}) "
                f"tier_dispatches={st['tier_dispatches']} by tier {st['dispatches_by_tier']} "
                f"host_mapped={st['host_mapped']}; steady "
                + (f"{steady:,.1f}" if steady else "not measured")
                + f" reads/s (stream {st['stream_seconds']:.1f} s; loads "
                f"{ {k: round(v, 1) for k, v in st['load_seconds'].items()} } s) vs "
                f"fem_baseline {base} reads/s net of its load; launches "
                f"{st['kernel_launches']}, filter_tail by cap_occ+cap_cand "
                f"{st['launches_by_shape']['filter_tail']}, banded_myers by slots x lanes "
                f"{st['launches_by_shape']['banded_myers']}; {cells}; step programs "
                f"{cli.programs_line(st['programs'])}")
    print(f"{head}; {more}" + (f"; {st['why']}" if "why" in st else ""), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--gb", type=float, default=3.0, help="genome size in gigabases")
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="the map's --batch-size (default: the command line's, 10,000)")
    ap.add_argument("--index-shards", type=int, default=4,
                    help="shards of the grid stage (1: no grid stage)")
    ap.add_argument("--golden-reads", type=int, default=64)
    ap.add_argument("--baseline-threads", default=None,
                    help="fem_baseline -t counts, comma-separated (default: 1 and the "
                         "host's CPU count)")
    ap.add_argument("--baseline", default=None,
                    help="the fem_baseline binary (default: built from the checkout)")
    ap.add_argument("--workdir", default=None,
                    help="directory for the files (default: a new temporary one)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the workdir's files (the SAMs too: each map's <stage>.sam, "
                         "the first fem_baseline run's baseline_t<threads>.sam)")
    a = ap.parse_args(argv)
    n = os.cpu_count() or 1
    a.baseline_threads = ([int(x) for x in a.baseline_threads.split(",")]
                          if a.baseline_threads else sorted({1, n}))
    return a


def run(a) -> dict:
    """All stages; a summary with every stage's figures and `ok`."""
    import torch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch_grch38_scale: no CUDA device (use --device cpu on the CPU)")
    from fem_tpu_torch.native.build import build_baseline

    card = device_line(a.device)
    made_workdir = a.workdir is None
    workdir = a.workdir or tempfile.mkdtemp(prefix="grch38_scale_")
    os.makedirs(workdir, exist_ok=True)
    paths = {k: os.path.join(workdir, f) for k, f in (
        ("fa", "ref.fa"), ("ix", "ref.index"), ("ix_base", "ref.baseline.index"),
        ("fq", "reads.fq"), ("fq_golden", "golden.fq"), ("fq_empty", "empty.fq"))}
    need = (int(a.gb * 1e9 * 81 / 80) + 2 * index_bytes(a.gb) + a.reads * 250
            + 3 * a.reads * 4000)  # FASTA, two indexes, FASTQ, SAMs of up to ~15 records a read
    free = shutil.disk_usage(workdir).free
    with open("/proc/meminfo") as f:
        host_mem = int(f.readline().split()[1]) * 1024
    print(f"[scale] {card}; host memory {gib(host_mem)}, {os.cpu_count()} CPUs; workdir "
          f"{workdir}: {free / 1e9:.1f} GB free, about {need / 1e9:.1f} GB needed", flush=True)
    if free < need:
        raise SystemExit(f"torch_grch38_scale: {workdir} has {free / 1e9:.1f} GB free, "
                         f"the run needs about {need / 1e9:.1f} GB")
    runner = Runner(workdir)
    summary = {"device": card, "gb": a.gb, "reads": a.reads, "host_memory_bytes": host_mem,
               "stages": [], "ok": False}
    t_all = time.perf_counter()
    try:
        baseline = a.baseline or build_baseline()

        def done(st):
            summary["stages"].append(st)
            print_stage(st, card)
            if not st["ok"]:
                raise StageFailed(st.get("why", st["stage"]))

        st, seqs = stage_synthesize(a, paths)
        done(st)
        st = stage_reads(a, paths, seqs)
        del seqs  # the index and map processes below need the memory
        names = [n.encode() for n in st.pop("golden_names")]
        done(st)
        done(stage_index(a, runner, baseline, paths))

        g = runner.port("golden", "map", "-e", E, "-a", A, "--ref", paths["fa"], "--index",
                        paths["ix"], "--read1", paths["fq_golden"], "-o",
                        os.path.join(workdir, "golden.sam"), "--engine", "golden")
        golden_recs = sam_records(os.path.join(workdir, "golden.sam"))
        golden = (names, b"\n".join(golden_recs))
        done({"stage": "golden", "ok": True, "seconds": g["seconds"], "rss_bytes": g["rss_bytes"],
              "device_bytes": None, "reads": len(names), "records": len(golden_recs)})

        base = baseline_maps(a, runner, baseline, paths)
        summary["baseline"] = {k: v for k, v in base.items()
                               if k not in ("records", "file_records", "sam")}
        print(f"[scale] fem_baseline map -e {E} -a {A}: load {base['load_seconds']:.1f} s; "
              + "; ".join(f"-t {t}: {v['seconds']:.1f} s, peak host RSS {gib(v['rss_bytes'])}, "
                          f"{v['reads_per_s'] or 0:,.1f} reads/s net of its load"
                          for t, v in base["by_threads"].items()), flush=True)
        # The command line puts every card of a machine into a data grid by
        # default: the one-card stages see the first card only.
        one_card = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "0")
                    .split(",")[0]} if a.device.startswith("cuda") else None
        done(stage_map(a, runner, "map", paths, base, golden, env=one_card))
        if a.index_shards > 1:
            done(stage_map(a, runner, "map_grid", paths, base, golden, a.index_shards,
                           env=one_card))
            if a.device.startswith("cuda") and torch.cuda.device_count() >= a.index_shards:
                done(stage_map(a, runner, "map_grid_cards", paths, base, golden,
                               a.index_shards))
        summary["ok"] = True
    except StageFailed:
        pass
    finally:
        summary["seconds"] = time.perf_counter() - t_all
        if made_workdir and not a.keep:
            shutil.rmtree(workdir, ignore_errors=True)
    return summary


def main(argv: list | None = None) -> int:
    a = parse_args(argv)
    summary = run(a)
    print(f"[scale] {'PASS' if summary['ok'] else 'FAIL'}: {len(summary['stages'])} stages in "
          f"{summary['seconds']:.1f} s on {summary['device']}", flush=True)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
