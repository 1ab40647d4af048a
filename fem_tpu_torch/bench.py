"""Benchmark: all-mapping reads/s per GPU (the port of the repo's bench.py).

    python -m fem_tpu_torch.bench [--device cpu]

Config mirrors the north-star operating point (BASELINE.json config 3:
human-chr21-scale genome — synthetic 46 Mb with 30% repeat content, the
repo ships no fixtures and the environment has no egress — 100 bp
single-end reads carrying the full e-error budget, k=12/step=3, e=5,
group seeding, src/FEM_map.c:67-72 flags), with bench.py's operating
points, FEM_BENCH_* variables and defaults.

Prints ONE headline JSON line: {"metric", "value", "unit", "vs_baseline",
"scoring", "whole_run_rps", "records_equal", "device", ...} plus one
auxiliary JSON line (before the headline) for the adversarial
satellite-genome workload. Two CPU baselines run first on the same
workload, before any worker opens the device:

  * the reference binary, built unmodified from the reference's sources
    with its own flags by refbuild/build.sh (FEM_REFERENCE_DIR), at -t 1
    and -t 2, best-effort: where its sources are absent the JSON has no
    `vs_reference_binary`;
  * `fem_baseline`, the C++ reimplementation (byte-identical output) — the
    `vs_baseline` denominator. Its build failing is an error: equality
    against it is the point of the bench.

Every timed device run is also a correctness run: each worker digests the
FULL SAM record multiset it emitted, and the parent maps the identical
timed read subset with fem_baseline and asserts record-multiset + counter
equality (the reference's t>1 contract, SURVEY.md §2.4). The equality of
EVERY swept worker count is kept and reported (`records_equal_by_workers`),
and the run exits non-zero if any of them is unequal. A worker that fails
fails the bench.

All device work happens in worker processes (`--worker`), each with its
own engine on the device: `--device cuda` (the default) raises where CUDA
is absent; `--device cpu` runs the kernels' plain versions, for tests at a
tiny size, and its lines say that they are not a GPU measurement.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

_DIG_MOD = 1 << 128
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest_lines(chunks) -> tuple[int, int]:
    """Order-independent multiset digest over SAM record lines: sum of
    per-record blake2b-128 digests mod 2^128 + record count. Equal digests
    + equal counts == equal record multisets (the reference's unordered
    t>1 emission contract, SURVEY.md §2.4)."""
    dig = 0
    cnt = 0
    for chunk in chunks:
        for line in chunk.split(b"\n"):
            if line and not line.startswith(b"@"):
                cnt += 1
                dig = (dig + int.from_bytes(
                    hashlib.blake2b(line, digest_size=16).digest(), "little"
                )) % _DIG_MOD
    return dig, cnt


def _counters_from_stderr(stderr: str) -> list[int]:
    out = []
    for pat in [
        r"The number of read: (\d+)",
        r"The number of mapped read: (\d+)",
        r"additional q-gram filter: (\d+)",
        r"The number of candidate: (\d+)",
        r"The number of mapping: (\d+)",
    ]:
        m = re.search(pat, stderr)
        if not m:
            return []
        out.append(int(m.group(1)))
    return out


def _batch_for(nworkers: int) -> int:
    """Per-worker-count operating point (bench.py's): B=16384 for one
    process, 8192 each when two share the device."""
    env = os.environ.get("FEM_BENCH_BATCH")
    if env:
        return int(env)
    return 16384 if nworkers == 1 else 8192


def _timed_read_ranges(num_reads, batch_size, nworkers, n_warm):
    """Reconstruct exactly which reads the workers timed: worker w takes
    batches i with i % nworkers == w and skips its first n_warm as warmup
    (mirrors worker())."""
    total_batches = -(-num_reads // batch_size)
    ranges = []
    for w in range(nworkers):
        mine = [i for i in range(total_batches) if i % nworkers == w]
        for i in mine[n_warm:]:
            ranges.append((i * batch_size, min((i + 1) * batch_size, num_reads)))
    return sorted(ranges)


def _verify_against_baseline(bin_, fixture_dir, reads, e, ranges, worker_stats):
    """Map the exact timed read subset with fem_baseline (byte-identical
    to the reference binary) and compare record-multiset digest + the five
    MappingStats counters against the workers' aggregates."""
    timed = [r for lo, hi in ranges for r in reads[lo:hi]]
    if not timed:
        return None
    from fem_tpu_torch import sim

    with tempfile.TemporaryDirectory() as d:
        fq = os.path.join(d, "timed.fq")
        sam = os.path.join(d, "timed.sam")
        sim.write_fastq(fq, timed)
        t0 = time.time()
        p = subprocess.run(
            [bin_, "map", "-e", str(e), "-a", "1", "-t", "1",
             "--ref", os.path.join(fixture_dir, "ref.fa"),
             "--index", os.path.join(fixture_dir, "ref.index"),
             "--read1", fq, "-o", sam],
            check=True, capture_output=True, text=True)
        base_counters = _counters_from_stderr(p.stderr)
        with open(sam, "rb") as f:
            dig, cnt = _digest_lines([f.read()])
    eng_counters = [
        worker_stats["num_reads"], worker_stats["num_mapped_reads"],
        worker_stats["num_candidates_without_additional_qgram_filter"],
        worker_stats["num_candidates"], worker_stats["num_mappings"],
    ]
    equal = (
        dig == worker_stats["rec_digest"]
        and cnt == worker_stats["rec_count"]
        and base_counters == eng_counters
    )
    print(
        f"[bench] full-run equality over {len(timed)} timed reads: "
        f"records_equal={dig == worker_stats['rec_digest']} "
        f"({cnt} vs {worker_stats['rec_count']} records), "
        f"counters_equal={base_counters == eng_counters} "
        f"(baseline map {time.time()-t0:.1f}s)",
        file=sys.stderr)
    return {"records_equal": bool(equal), "records_checked": int(cnt),
            "reads_checked": len(timed)}


def _sweep(bin_, fixture_dir, counts, device, reads, e, phase="", extra_env=None) -> dict:
    """Each worker count in turn ({n: result}): its run and the equality of
    the reads it timed against fem_baseline."""
    out = {}
    for n in counts:
        res = run_workers(fixture_dir, n, device, phase=phase, extra_env=extra_env)
        ranges = _timed_read_ranges(len(reads), _batch_for(n), n, 1)
        res["equality"] = _verify_against_baseline(
            bin_, fixture_dir, reads, e, ranges, res["stats"])
        out[n] = res
    return out


def _line_fields(sweep: dict) -> dict:
    """A JSON line's fields over every swept worker count: the best count's
    rates (the score), each count's, the kernels' launches, and equality
    over all of them."""
    best = max(sweep.values(), key=lambda r: r["best"])
    out = {
        "value": round(best["best"], 1),
        "whole_run_rps": round(best["whole_run"], 1),
        "rps_by_workers": {str(n): round(r["best"], 1) for n, r in sweep.items()},
        "whole_run_rps_by_workers": {str(n): round(r["whole_run"], 1)
                                     for n, r in sweep.items()},
        "kernel_launches": {k: sum(r["launches"][k] for r in sweep.values())
                            for k in best["launches"]},
    }
    eqs = {n: r["equality"] for n, r in sweep.items() if r["equality"] is not None}
    if eqs:
        out.update({
            "records_equal": all(q["records_equal"] for q in eqs.values()),
            "records_equal_by_workers": {str(n): q["records_equal"] for n, q in eqs.items()},
            "records_checked": sum(q["records_checked"] for q in eqs.values()),
            "reads_checked": sum(q["reads_checked"] for q in eqs.values()),
        })
    return out


def _build_binaries():
    """Build fem_baseline (a failure raises) and, best-effort, the
    reference binary."""
    from fem_tpu_torch.native.build import build_baseline

    bin_ = build_baseline()
    ref_bin = None
    try:
        out = subprocess.run(
            [os.path.join(_REPO, "refbuild", "build.sh")],
            check=True, capture_output=True, text=True)
        ref_bin = out.stdout.strip().splitlines()[-1]
    except (OSError, subprocess.CalledProcessError) as exc:
        print(f"[bench] reference binary build failed ({exc})",
              file=sys.stderr)
    return bin_, ref_bin


def _device_name(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" for
    a CPU run. The parent never opens the device itself: the workers do."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def run_workers(fixture_dir, n, device, phase="", extra_env=None):
    """Spawn n worker subprocesses over interleaved batch shards; returns
    the aggregated result dict. A worker that fails raises, with the end
    of its stderr."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["FEM_BENCH_BATCH_EFFECTIVE"] = str(_batch_for(n))
    env.update(extra_env or {})
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "fem_tpu_torch.bench", "--worker",
             fixture_dir, str(w), str(n), "--device", device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for w in range(n)
    ]
    outs = [p.communicate() for p in procs]
    for w, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"[bench]{phase} worker failed rc={p.returncode}: {err[-2000:]}")
        for line in err.splitlines():
            if line.startswith("[build]"):  # which worker built, how long the others waited
                print(f"[bench]{phase} worker {w}: {line}", file=sys.stderr)
    stats = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    timed_reads = sum(s["reads"] for s in stats)
    slowest = max(s["seconds"] for s in stats)
    # Best-half score: all workers' half-i reads / slowest half-i time.
    n_halves = min(len(s["halves"]) for s in stats)
    best = max(
        sum(s["halves"][i]["reads"] for s in stats)
        / max(s["halves"][i]["seconds"] for s in stats)
        for i in range(n_halves)
    )
    agg_stats = {
        k: sum(s["stats"][k] for s in stats) for k in stats[0]["stats"]
    }
    agg_stats["rec_digest"] = sum(int(s["rec_digest"]) for s in stats) % _DIG_MOD
    agg_stats["rec_count"] = sum(s["rec_count"] for s in stats)
    retried = sum(s["retried"] for s in stats)
    fallbacks = sum(s["fallbacks"] for s in stats)
    warm = max(s["warmup_seconds"] for s in stats)
    launches = {k: sum(s["kernel_launches"][k] for s in stats)
                for k in stats[0]["kernel_launches"]}
    print(
        f"[bench]{phase} {n} worker process(es): {best:,.0f} reads/s best "
        f"half ({timed_reads/slowest:,.0f} whole-run, {timed_reads} timed "
        f"reads, slowest worker {slowest:.2f}s, warmup {warm:.1f}s) | "
        f"stats { {k: v for k, v in agg_stats.items() if not k.startswith('rec_')} } | "
        f"retried {retried} | host fallbacks {fallbacks} | kernel launches {launches}",
        file=sys.stderr)
    return {
        "best": best, "whole_run": timed_reads / slowest,
        "timed_reads": timed_reads, "stats": agg_stats,
        "retried": retried, "fallbacks": fallbacks, "warm": warm,
        "launches": launches,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m fem_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="torch device of the workers (default cuda; cpu for tests)")
    p.add_argument("--worker", nargs=3, metavar=("DIR", "WID", "N"),
                   help="run as worker WID of N over the fixtures in DIR")
    args = p.parse_args(argv)
    device = args.device
    if args.worker:
        worker(args.worker[0], int(args.worker[1]), int(args.worker[2]), device)
        return 0
    device_name = _device_name(device)
    on_gpu = device_name != "cpu"
    per = "per GPU" if on_gpu else "on the CPU (plain torch versions; not a GPU measurement)"
    # Default config mirrors the north-star operating point (BASELINE.json
    # config 3: human-chr21-scale genome, 100bp reads, e=5 all-mapping).
    genome_mb = float(os.environ.get("FEM_BENCH_GENOME_MB", "46"))
    # 327680 reads / B=16384 = 20 batches: >= 9 steady-state batches per
    # worker.
    num_reads = int(os.environ.get("FEM_BENCH_READS", "327680"))
    e = int(os.environ.get("FEM_BENCH_E", "5"))
    repeat_fraction = float(os.environ.get("FEM_BENCH_REPEATS", "0.3"))
    adversarial_reads = int(os.environ.get("FEM_BENCH_ADV_READS", "163840"))

    from fem_tpu_torch import sim
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.index.storage import save_index
    from fem_tpu_torch.io import fastx

    t0 = time.time()
    seqs = sim.random_genome(
        int(genome_mb * 1e6), num_seqs=1, seed=7, repeat_fraction=repeat_fraction
    )
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.fa")
        sim.write_fasta(p, seqs)
        ref = fastx.read_fasta(p)
    index = build_index(ref, 12, 3)
    # Honest operating point: reads carry up to e errors (incl. indels) —
    # the advertised capability (src/FEM_map.c:30), not an easier subset.
    reads = sim.simulate_reads(
        seqs, num_reads, read_length=100, max_errors=e, seed=9
    )
    print(f"[bench] setup {time.time()-t0:.1f}s (genome {genome_mb}Mb "
          f"repeats={repeat_fraction}, {num_reads} reads, e={e}; device {device_name})",
          file=sys.stderr)

    # CPU baselines FIRST, before any worker loads the device.
    reference_rps = None
    reference_t2_rps = None
    if os.environ.get("FEM_BENCH_SKIP_BASELINE") == "1":
        # Fast-iteration mode: reuse a recorded fem_baseline rate instead
        # of the CPU baseline runs (bench.py's recorded default); the
        # binary is still built for the equality check.
        from fem_tpu_torch.native.build import build_baseline

        baseline_rps = float(os.environ.get("FEM_BENCH_BASELINE_RPS", "57400"))
        bin_ = build_baseline()
    else:
        bin_, ref_bin = _build_binaries()
        with tempfile.TemporaryDirectory() as d:
            fa = os.path.join(d, "ref.fa")
            fq = os.path.join(d, "reads.fq")
            ix = os.path.join(d, "ref.index")
            sam = os.path.join(d, "out.sam")
            sim.write_fasta(fa, seqs)
            sim.write_fastq(fq, reads)
            subprocess.run([bin_, "index", "12", "3", fa, ix], check=True,
                           capture_output=True)

            def timed_map(b, t):
                t0 = time.time()
                subprocess.run(
                    [b, "map", "-e", str(e), "-a", "1", "-t", str(t),
                     "--ref", fa, "--index", ix, "--read1", fq, "-o", sam],
                    check=True, capture_output=True)
                return num_reads / (time.time() - t0)

            if ref_bin:
                # The index file format is bit-identical between the two
                # builders (tests/test_reference_binary.py), so the
                # reference binary maps from the same index.
                try:
                    reference_rps = timed_map(ref_bin, 1)
                    reference_t2_rps = timed_map(ref_bin, 2)
                    print(
                        f"[bench] reference binary (refbuild/FEM): "
                        f"{reference_rps:,.0f} reads/s @ -t 1, "
                        f"{reference_t2_rps:,.0f} reads/s @ -t 2",
                        file=sys.stderr)
                except subprocess.CalledProcessError as exc:
                    print(f"[bench] reference binary run failed ({exc})",
                          file=sys.stderr)
            baseline_rps = timed_map(bin_, 1)
        print(f"[bench] fem_baseline (1 CPU thread): {baseline_rps:,.0f} reads/s",
              file=sys.stderr)

    workers = int(os.environ.get("FEM_BENCH_WORKERS", "2"))
    counts = ([workers] if workers > 1 else []) + (
        [] if os.environ.get("FEM_BENCH_SKIP_SINGLE") == "1" else [1])

    with tempfile.TemporaryDirectory() as fixture_dir:
        sim.write_fasta(os.path.join(fixture_dir, "ref.fa"), seqs)
        sim.write_fastq(os.path.join(fixture_dir, "reads.fq"), reads)
        save_index(index, os.path.join(fixture_dir, "ref.index"))
        sweep = _sweep(bin_, fixture_dir, counts, device, reads, e)
    fields = _line_fields(sweep)

    # Adversarial phase: satellite-repeat genome (tools/soak.py geometry)
    # exercising the capacity overflow path — the workload where the
    # reference's unbounded merge (src/filter.c:80-131) pays no retry tax.
    adv_sweep = {}
    if adversarial_reads > 0 and os.environ.get("FEM_BENCH_SKIP_ADV") != "1":
        t0 = time.time()
        adv_seqs = sim.satellite_genome(
            int(genome_mb * 1e6), num_seqs=2, seed=13, satellite_fraction=0.03,
            unit_range=(24, 160), copies_range=(48, 512),
        )
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "ref.fa")
            sim.write_fasta(p, adv_seqs)
            adv_ref = fastx.read_fasta(p)
        adv_index = build_index(adv_ref, 12, 3)
        adv_reads = sim.simulate_reads(
            adv_seqs, adversarial_reads, read_length=100, max_errors=e, seed=14
        )
        print(f"[bench] adversarial setup {time.time()-t0:.1f}s "
              f"(satellite genome, {adversarial_reads} reads)", file=sys.stderr)
        with tempfile.TemporaryDirectory() as fixture_dir:
            fx = {k: os.path.join(fixture_dir, f) for k, f in
                  (("fa", "ref.fa"), ("fq", "reads.fq"), ("ix", "ref.index"))}
            sim.write_fasta(fx["fa"], adv_seqs)
            sim.write_fastq(fx["fq"], adv_reads)
            save_index(adv_index, fx["ix"])
            with tempfile.TemporaryDirectory() as d:
                t0 = time.time()
                subprocess.run(
                    [bin_, "map", "-e", str(e), "-a", "1", "-t", "1",
                     "--ref", fx["fa"], "--index", fx["ix"], "--read1", fx["fq"],
                     "-o", os.path.join(d, "out.sam")],
                    check=True, capture_output=True)
                adv_base_rps = adversarial_reads / (time.time() - t0)
            print(f"[bench] adversarial fem_baseline: {adv_base_rps:,.0f} "
                  f"reads/s", file=sys.stderr)
            # bench.py's adversarial operating point: vpr=8/apr=8 fit the
            # satellite workload's ~9.4 mappings and ~10 candidates per
            # read, and overflow goes to the exact host mapper.
            adv_env = {"FEM_BENCH_TIERS": "none",
                       "FEM_BENCH_CAP_CAND": "64",
                       "FEM_BENCH_VPR": "8",
                       "FEM_BENCH_APR": "8"}
            adv_counts = [int(x) for x in os.environ.get(
                "FEM_BENCH_ADV_WORKERS", "2,1").split(",")]
            adv_sweep = _sweep(bin_, fixture_dir, adv_counts, device, adv_reads, e,
                               " [adversarial]", adv_env)
        adv_fields = _line_fields(adv_sweep)
        best = max(adv_sweep.values(), key=lambda r: r["best"])
        adv_result = {
            "metric": f"adversarial all-mapping reads/s {per} "
            f"(satellite-repeat {genome_mb}Mb genome, 100bp SE, e={e})",
            "value": adv_fields.pop("value"),
            "unit": "reads/s",
            "scoring": "best-half, max over worker counts "
            f"({adv_counts})",
            "whole_run_rps": adv_fields.pop("whole_run_rps"),
            "retried_reads": best["retried"],
            "host_fallbacks": best["fallbacks"],
            "vs_baseline": round(best["best"] / adv_base_rps, 2),
            "device": device_name,
            **adv_fields,
        }
        print(json.dumps(adv_result))

    reads_per_s = fields.pop("value")
    result = {
        "metric": f"all-mapping reads/s {per} (synthetic {genome_mb}Mb "
        f"genome, {int(repeat_fraction*100)}% repeats, 100bp SE, "
        f"k=12 step=3 e={e} a=1)",
        "value": reads_per_s,
        "unit": "reads/s",
        "scoring": "best-half over distinct steady-state batches, max over "
        "worker counts (whole_run_rps = same run without half selection)",
        "whole_run_rps": fields.pop("whole_run_rps"),
        "vs_baseline": round(reads_per_s / baseline_rps, 2),
        "device": device_name,
        **fields,
    }
    if adv_sweep:
        result["adversarial_rps"] = adv_result["value"]
    if reference_rps:
        result["vs_reference_binary"] = round(reads_per_s / reference_rps, 2)
        result["reference_binary_rps"] = round(reference_rps, 1)
    if reference_t2_rps:
        result["vs_reference_binary_t2"] = round(
            reads_per_s / reference_t2_rps, 2)
    print(json.dumps(result))
    unequal = [n for sw in (sweep, adv_sweep) for n, r in sw.items()
               if r["equality"] is not None and not r["equality"]["records_equal"]]
    if unequal:
        print(f"[bench] {len(unequal)} worker-count run(s) differ from fem_baseline",
              file=sys.stderr)
        return 1
    return 0


def worker(d: str, wid: int, nworkers: int, device: str) -> None:
    """Bench worker process: map an interleaved batch shard on `device`,
    print one JSON line {reads, seconds, stats, retried, fallbacks,
    warmup_seconds, rec_digest, rec_count} of steady-state mapping (first
    batch excluded as warmup). Records emitted during the timed region are
    kept and digested AFTER timing (order-independent multiset digest) so
    the parent can assert full-run record equality against fem_baseline."""
    batch_size = int(os.environ.get(
        "FEM_BENCH_BATCH_EFFECTIVE", _batch_for(nworkers)))
    e = int(os.environ.get("FEM_BENCH_E", "5"))
    # bench.py's caps for this workload (tools/demand_stats.py, r3):
    # cap_occ 80 bounds the 8-pair-aligned row fetch (e=5: 7 seeds x >=8
    # slots + slack -> 0.1% read retries), candidates per lane max out at
    # 6 (cap_cand 16) and verify demand at ~1.6/read (vpr 2); accepted hits
    # concentrate around 1.45/read, so apr 0.85 = 1.7 slots/read.
    cap_occ = int(os.environ.get("FEM_BENCH_CAP_OCC", "80"))
    cap_cand = int(os.environ.get("FEM_BENCH_CAP_CAND", "16"))
    verify_per_read = int(os.environ.get("FEM_BENCH_VPR", "2"))
    accept_per_read = float(os.environ.get("FEM_BENCH_APR", "0.85"))

    from fem_tpu_torch import kernels
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.storage import load_index
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
    from fem_tpu_torch.stats import MappingStats

    ref = fastx.read_fasta(os.path.join(d, "ref.fa"))
    index = load_index(os.path.join(d, "ref.index"))
    args = FemArgs(kmer_size=index.kmer_size, step_size=index.step_size,
                   error_threshold=e, num_additional_qgrams=1)
    # FEM_BENCH_TIERS=none (the default, as bench.py) routes
    # capacity-overflow reads straight to the exact host C++ mapper instead
    # of the device retry ladder.
    tiers = () if os.environ.get("FEM_BENCH_TIERS", "none") == "none" else None
    engine = MappingEngine(
        args, ref, index,
        EngineConfig(batch_size=batch_size, cap_occ=cap_occ, cap_cand=cap_cand,
                     verify_per_read=verify_per_read,
                     accept_per_read=accept_per_read, tiers=tiers),
        device=device,
    )
    batches = [
        b for i, b in enumerate(fastx.stream_fastq_batches(
            os.path.join(d, "reads.fq"), batch_size=batch_size))
        if i % nworkers == wid
    ]
    n_warm = 1  # first use: allocator, pinned buffers, library loads
    t0 = time.time()
    for _ in engine.map_stream(batches[:n_warm]):
        pass
    warm_s = time.time() - t0
    # Two timed halves over distinct batches; the parent scores the better
    # half ("scoring") and carries the whole-run number too.
    timed = batches[n_warm:]
    half = max(len(timed) // 2, 1)
    total = MappingStats()
    halves = []
    blobs = []
    for part in (timed[:half], timed[half:]):
        if not part:
            continue
        sub = MappingStats()
        t0 = time.time()
        for recs, stats in engine.map_stream(part):
            sub += stats
            blobs.extend(recs)  # cheap list append; digested after timing
        halves.append({"reads": sub.num_reads, "seconds": time.time() - t0})
        total += sub
    dig, cnt = _digest_lines(blobs)
    print(json.dumps({
        "reads": total.num_reads,
        "seconds": sum(h["seconds"] for h in halves),
        "halves": halves, "stats": total.__dict__,
        "retried": engine.retried_reads, "fallbacks": engine.fallback_reads,
        "warmup_seconds": warm_s,
        "rec_digest": str(dig), "rec_count": cnt,
        "kernel_launches": dict(kernels.launches),
    }))


if __name__ == "__main__":
    sys.exit(main())
