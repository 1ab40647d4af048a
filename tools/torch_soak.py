"""Differential soak of the PyTorch/CUDA port: the engine against fem_baseline.

Maps simulated reads against a satellite-repeat genome (3% tandem arrays)
with the engine at B=8192, cap_occ=80, cap_cand=64, verify_per_read=4,
accept_per_read=1 and the default retry ladder, and holds the sorted SAM
record set and the five counters against fem_baseline, the standalone C++
mapper with the reference's semantics, on the same reads. Two lines by
default: e=5 on 500,000 100 bp reads and e=7 on 300,000 150 bp reads (e=7
needs reads of at least 123 bp for FEM's step bound step <= L/(e+2) - k + 1);
reads carry up to e errors, indels included. Heavy-tail reads overflow
tier 0 and go through the ladder, whose filter tail runs at 640 + 512 and
5120 + 4096.

Each line prints the equality, mappings, retried reads and their share,
tier dispatches by tier, host-mapped reads, the engine's steady reads/s
(after the first two items, so the retry tax is in it and the warm-up is
not) beside fem_baseline's on one thread, the filter tail's launches by
(cap_occ, cap_cand), and the device (the card's name and power limit from
nvidia-smi). The last line is a JSON object of all lines. Exits 1 if any
line differs from fem_baseline.

    python tools/torch_soak.py                      # on the card
    python tools/torch_soak.py --device cpu --genome-mb 0.25 \\
        --satellite-fraction 0.15 --reads 2000 --batch-size 256 --e 5

FEM_SOAK_READS sets the reads of every line, FEM_SOAK_E the lines (e.g.
"5" or "2,5,7"), FEM_SOAK_GENOME_MB and FEM_SOAK_BATCH the genome and the
batch; the flags override them. FEM_TPU_TIERS names another ladder.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

# The lines docs/SOAK.md's r5 run made: e -> reads.
DEFAULT_READS = {5: 500_000, 7: 300_000}
COUNTER_NAMES = ("reads", "mapped reads", "candidates before the additional q-gram filter",
                 "candidates", "mappings")


def read_length(e: int) -> int:
    """150 bp from e=7 on (FEM's step bound at k=12 step=3), else 100 bp."""
    return 150 if e >= 7 else 100


def sorted_records(lines) -> list:
    recs = [ln for ln in lines if ln and not ln.startswith(b"@")]
    recs.sort()
    return recs


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def soak_line(e: int, num_reads: int, seqs, ref, index, fa: str, ix: str, bin_: str,
              d: str, batch: int, device: str, seed: int) -> dict:
    from fem_tpu_torch import kernels, sim
    from fem_tpu_torch.bench import _counters_from_stderr
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.io.fastx import stream_fastq_batches
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
    from fem_tpu_torch.stats import MappingStats

    length = read_length(e)
    t0 = time.perf_counter()
    fq = os.path.join(d, f"reads_e{e}.fq")
    sim.write_fastq(fq, sim.simulate_reads(seqs, num_reads, read_length=length,
                                           max_errors=e, seed=seed))
    setup_s = time.perf_counter() - t0

    bsam = os.path.join(d, f"base_e{e}.sam")
    t0 = time.perf_counter()
    p = subprocess.run([bin_, "map", "-e", str(e), "-a", "1", "-t", "1", "--ref", fa,
                        "--index", ix, "--read1", fq, "-o", bsam],
                       check=True, capture_output=True, text=True)
    base_s = time.perf_counter() - t0
    base_counters = _counters_from_stderr(p.stderr)
    if len(base_counters) != 5:
        raise RuntimeError(f"fem_baseline printed no five counters: {p.stderr[-2000:]}")

    engine = MappingEngine(
        FemArgs(error_threshold=e, num_additional_qgrams=1), ref, index,
        EngineConfig(batch_size=batch, cap_occ=80, cap_cand=64, verify_per_read=4,
                     accept_per_read=1),
        device=device)
    kernels.reset_launches()
    total = MappingStats()
    lines = []
    warm_items, n_items, steady_t0, steady_reads0 = 2, 0, None, 0
    t0 = time.perf_counter()
    for chunks, stats in engine.map_stream(stream_fastq_batches(fq, batch_size=batch)):
        for c in chunks:
            lines.extend(c.split(b"\n"))
        total += stats
        n_items += 1
        if n_items == warm_items:
            steady_t0, steady_reads0 = time.perf_counter(), total.num_reads
    t_end = time.perf_counter()
    eng_s = t_end - t0
    steady = (total.num_reads - steady_reads0) / (t_end - steady_t0) if (
        steady_t0 is not None and total.num_reads > steady_reads0) else num_reads / eng_s
    counters = [total.num_reads, total.num_mapped_reads,
                total.num_candidates_without_additional_qgram_filter,
                total.num_candidates, total.num_mappings]

    got = sorted_records(lines)
    del lines
    with open(bsam, "rb") as f:
        want = sorted_records(f.read().split(b"\n"))
    os.unlink(bsam)
    os.unlink(fq)
    records_equal = got == want
    out = {
        "e": e, "read_length": length, "reads": num_reads,
        "records_equal": records_equal, "counters_equal": counters == base_counters,
        "records": len(got), "counters": counters, "baseline_counters": base_counters,
        "mappings": total.num_mappings, "retried": engine.retried_reads,
        "retried_share": engine.retried_reads / num_reads,
        "tier_dispatches": engine.tier_dispatches,
        "dispatches_by_tier": dict(sorted(engine.dispatches_by_tier.items())),
        "host_mapped": engine.fallback_reads,
        "steady_reads_per_s": steady, "whole_run_reads_per_s": num_reads / eng_s,
        "baseline_reads_per_s": num_reads / base_s,
        "filter_tail_launches_by_shape": {
            f"{cap}+{cc}": n for (cap, cc), n in
            sorted(kernels.launches_by_shape()["filter_tail"].items())},
        "setup_s": setup_s,
    }
    out["ok"] = out["records_equal"] and out["counters_equal"]
    return out


def main(argv: list | None = None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--e", default=env("FEM_SOAK_E", "5,7"),
                    help="error thresholds, one line each (default 5,7)")
    ap.add_argument("--reads", type=int, default=int(env("FEM_SOAK_READS", "0")) or None,
                    help="reads of every line (default: 500,000 at e=5, 300,000 at e=7)")
    ap.add_argument("--genome-mb", type=float, default=float(env("FEM_SOAK_GENOME_MB", "46")))
    ap.add_argument("--satellite-fraction", type=float, default=0.03)
    ap.add_argument("--batch-size", type=int, default=int(env("FEM_SOAK_BATCH", "8192")))
    ap.add_argument("--seed", type=int, default=13, help="genome seed; reads take seed + 1")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_soak: no CUDA device (use --device cpu to run on the CPU)")

    from fem_tpu_torch import sim
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.native.build import build_baseline

    es = [int(x) for x in a.e.split(",")]
    card = device_line(a.device)
    t0 = time.perf_counter()
    seqs = sim.satellite_genome(int(a.genome_mb * 1e6), num_seqs=2, seed=a.seed,
                                satellite_fraction=a.satellite_fraction,
                                unit_range=(24, 160), copies_range=(48, 512))
    bin_ = build_baseline()
    results = []
    with tempfile.TemporaryDirectory() as d:
        fa, ix = os.path.join(d, "ref.fa"), os.path.join(d, "ref.index")
        sim.write_fasta(fa, seqs)
        ref = fastx.read_fasta(fa)
        index = build_index(ref, 12, 3)
        subprocess.run([bin_, "index", "12", "3", fa, ix], check=True, capture_output=True)
        print(f"[soak] {card}: {a.genome_mb} Mb satellite genome "
              f"({a.satellite_fraction:.0%} arrays), index in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        for e in es:
            n = a.reads or DEFAULT_READS.get(e, 300_000)
            r = soak_line(e, n, seqs, ref, index, fa, ix, bin_, d, a.batch_size,
                          a.device, a.seed + 1)
            results.append(r)
            print(f"{'PASS' if r['ok'] else 'FAIL'} e={e} ({r['read_length']} bp, {n:,} reads) "
                  f"on {card}: records_equal={r['records_equal']} "
                  f"counters_equal={r['counters_equal']} mappings={r['mappings']:,} "
                  f"retried={r['retried']:,} ({100 * r['retried_share']:.2f}%) "
                  f"tier_dispatches={r['tier_dispatches']} by tier "
                  f"{r['dispatches_by_tier']} host_mapped={r['host_mapped']} "
                  f"steady {r['steady_reads_per_s']:,.1f} reads/s (whole run "
                  f"{r['whole_run_reads_per_s']:,.1f}) vs fem_baseline "
                  f"{r['baseline_reads_per_s']:,.1f} reads/s; filter_tail launches by "
                  f"cap_occ+cap_cand {r['filter_tail_launches_by_shape']}", flush=True)
            if not r["counters_equal"]:
                for name, g, w in zip(COUNTER_NAMES, r["counters"], r["baseline_counters"]):
                    print(f"  {name}: engine {g}, fem_baseline {w}", flush=True)
    print(json.dumps({"device": card, "lines": results}))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
