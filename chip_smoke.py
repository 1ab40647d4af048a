#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure raises and the script
exits non-zero without its result line:

  1. device   the card (nvidia-smi name and power limit), torch, CUDA and
              nvcc versions; no CUDA device is an error, never a CPU run.
  2. build    nvcc builds fem_tpu_torch/csrc/*.cu for sm_90a.
  3. setup    the bench operating point (bench.py, BASELINE.json config 3):
              a synthetic 46 Mb genome with 30% repeats, k=12 step=3 index,
              65,536 simulated 100 bp reads with up to 5 errors.
  4. kernels  each CUDA kernel against its plain torch version on the card,
              at the main path's shapes; outputs are integers and must be
              exactly equal. Times are CUDA-event medians.
  5. main     MappingEngine.map_stream on the card at e=5 a=1, B=16384,
              cap_occ=80, cap_cand=16, vpr=2, apr=0.85, tier 0 only. Both
              kernels must have launched, and the SAM record multiset and
              the five counters must equal fem_baseline's on the same reads.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

GENOME_BP = 46_000_000
NUM_READS = 65_536
BATCH = 16_384
E, A = 5, 1
KMER, STEP = 12, 3
_DIG_MOD = 1 << 128


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired integer tensors."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def digest_lines(chunks) -> tuple[int, int]:
    """Order-independent digest of SAM record lines (as bench.py): the sum
    of per-record blake2b-128 digests mod 2^128, and the record count."""
    dig = cnt = 0
    for chunk in chunks:
        for line in chunk.split(b"\n"):
            if line and not line.startswith(b"@"):
                cnt += 1
                dig = (dig + int.from_bytes(
                    hashlib.blake2b(line, digest_size=16).digest(), "little"
                )) % _DIG_MOD
    return dig, cnt


def counters_from_stderr(stderr: str) -> list[int]:
    """The five counters the reference prints (src/FEM_map.c:214-218)."""
    out = []
    for pat in (r"The number of read: (\d+)", r"The number of mapped read: (\d+)",
                r"additional q-gram filter: (\d+)", r"The number of candidate: (\d+)",
                r"The number of mapping: (\d+)"):
        m = re.search(pat, stderr)
        check(m is not None, f"fem_baseline printed no counter {pat!r}")
        out.append(int(m.group(1)))
    return out


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke runs only on a GPU")
    from fem_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda} | nvcc {nvcc}")
    return smi


def phase_build() -> None:
    from fem_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.library()
    log(f"[build] {kernels.LIB_PATH} built in {time.perf_counter() - t0:.1f} s")


def phase_setup(workdir: str):
    from fem_tpu import sim
    from fem_tpu.index.build import build_index
    from fem_tpu.index.storage import save_index
    from fem_tpu.io import fastx

    t0 = time.perf_counter()
    seqs = sim.random_genome(GENOME_BP, num_seqs=1, seed=7, repeat_fraction=0.3)
    paths = {k: os.path.join(workdir, f) for k, f in
             (("fa", "ref.fa"), ("fq", "reads.fq"), ("ix", "ref.index"))}
    sim.write_fasta(paths["fa"], seqs)
    ref = fastx.read_fasta(paths["fa"])
    index = build_index(ref, KMER, STEP)
    save_index(index, paths["ix"])
    reads = sim.simulate_reads(seqs, NUM_READS, read_length=100, max_errors=E, seed=9)
    sim.write_fastq(paths["fq"], reads)
    log(f"[setup] {GENOME_BP / 1e6:.0f} Mb genome, {index.num_occurrences} occurrences, "
        f"{NUM_READS} reads in {time.perf_counter() - t0:.1f} s")
    return ref, index, paths


def _myers_inputs(ref, e: int, rng, dev):
    """Verify slots at the main path's shape: 2 slots per read-strand lane
    of a 16,384-read batch, Lmax 128. Lane l's read is the diagonal of slot
    2l's reference window with up to e+1 substitutions (the mutated copies
    of tests/test_verify_pallas.py), so part of the slots are accepted;
    slot 2l+1 points elsewhere, a few of them into the trailing gap."""
    NB, Lmax = 2 * BATCH, 128
    V = 2 * NB
    L0 = int(ref.lengths[0])
    v_lane = np.arange(V, dtype=np.int32) // 2
    v_sid = np.zeros(V, np.int32)
    v_pos = rng.integers(0, L0 - Lmax - 2 * e, V).astype(np.int32)
    v_pos[1:64:2] = rng.integers(L0 - Lmax, L0 + 40, 32)
    lens = np.full(NB, 100, np.int32)
    lens[NB // 2 :] = rng.integers(40, Lmax + 1, NB - NB // 2)
    off = int(ref.offsets[0]) + v_pos[0::2].astype(np.int64) + e
    both = ref.flat_codes[off[:, None] + np.arange(Lmax)[None, :]]
    n_edits = rng.integers(0, e + 2, NB)
    for j in range(e + 1):
        rows = np.flatnonzero(n_edits > j)
        both[rows, rng.integers(0, Lmax, rows.size)] = rng.integers(0, 4, rows.size)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return t(v_sid), t(v_pos), t(v_lane), t(both), t(lens)


def phase_kernels(ref, index, dev) -> list[dict]:
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain
    from fem_tpu_torch.ops.types import BIG, SENTINEL_SID, device_index_from_host
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    rng = np.random.default_rng(2024)
    dindex = device_index_from_host(index, ref, dev)
    rows = []

    # Banded Myers: V = 65,536 slots, Lmax = 128, e in {0, 2, 5, 7}.
    err, ms, plain_ms = 0, None, None
    for e in (0, 2, 5, 7):
        args = _myers_inputs(ref, e, rng, dev)
        got = verify_candidates(dindex, *args, e)
        want = verify_candidates_plain(dindex, *args, e)
        torch.cuda.synchronize()
        d = max_abs_err(got, want)
        n_acc = int(want.accepted.sum())
        log(f"[kernels] banded_myers e={e} V={args[0].shape[0]}: max_abs_err {d}, "
            f"{n_acc} accepted")
        check(d == 0, f"banded_myers differs from its plain version at e={e}")
        check(0 < n_acc < args[0].shape[0], "banded_myers check accepts all or none")
        err = max(err, d)
        if e == E:
            ms = cuda_ms(lambda: verify_candidates(dindex, *args, e), 20)
            plain_ms = cuda_ms(lambda: verify_candidates_plain(dindex, *args, e), 5)
    rows.append({"name": "banded_myers", "route": "cuda",
                 "source": "fem_tpu_torch/csrc/banded_myers.cu",
                 "replaces": "fem_tpu/ops/verify_pallas.py:122",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(f"[kernels] banded_myers at e={E}: {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # Filter tail: NB = 32,768 lanes, G = 3 groups, clustered slabs
    # (tests/test_filter_kernel.py:_random_slabs), plus cap_cand + cap_occ = 512.
    err, ms, plain_ms = 0, None, None
    NB, G = 2 * BATCH, STEP
    for CAP, CC, a in ((80, 16, 0), (80, 16, 1), (80, 16, 2), (480, 32, 1)):
        sid = rng.integers(0, 3, (NB, G, CAP))
        diag = rng.integers(0, 40, (NB, G, CAP)) + rng.integers(0, 4, (NB, G, CAP))
        valid = rng.random((NB, G, CAP)) < 0.4
        sid = torch.from_numpy(np.where(valid, sid, SENTINEL_SID).astype(np.int32)).to(dev)
        diag = torch.from_numpy(np.where(valid, diag, BIG).astype(np.int32)).to(dev)
        got = filter_tail(sid, diag, CC, E, a)
        want = filter_tail_plain(sid, diag, CC, E, a)
        torch.cuda.synchronize()
        d = max_abs_err(got, want)
        log(f"[kernels] filter_tail NB={NB} G={G} CAP={CAP} CC={CC} e={E} a={a}: "
            f"max_abs_err {d}, {int(want[2].sum())} lanes overflow")
        check(d == 0, f"filter_tail differs from its plain version at CAP={CAP} a={a}")
        err = max(err, d)
        if (CAP, CC, a) == (80, 16, A):
            ms = cuda_ms(lambda: filter_tail(sid, diag, CC, E, a), 20)
            plain_ms = cuda_ms(lambda: filter_tail_plain(sid, diag, CC, E, a), 3)
    rows.append({"name": "filter_tail", "route": "cuda",
                 "source": "fem_tpu_torch/csrc/filter_tail.cu",
                 "replaces": "fem_tpu/ops/filter_tail_pallas.py:213",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(f"[kernels] filter_tail at CAP=80 CC=16 a={A}: {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return rows


def phase_main(ref, index, paths, dev) -> dict:
    from fem_tpu.config import FemArgs
    from fem_tpu.golden.model import MappingStats
    from fem_tpu.io import fastx
    from fem_tpu.native.build import build_baseline
    from fem_tpu_torch import kernels
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine, StageTimer

    args = FemArgs(kmer_size=KMER, step_size=STEP, error_threshold=E,
                   num_additional_qgrams=A)
    config = EngineConfig(batch_size=BATCH, cap_occ=80, cap_cand=16,
                          verify_per_read=2, accept_per_read=0.85)
    engine = MappingEngine(args, ref, index, config, device=dev)
    batches = list(fastx.stream_fastq_batches(paths["fq"], batch_size=BATCH))
    log(f"[main] device index {engine.dindex.nbytes() / 2**30:.3f} GiB on {dev}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    recs, total = [], MappingStats()
    t0 = time.perf_counter()
    for r, st in engine.map_stream(batches[:1]):  # first batch: warm-up
        recs.extend(r)
        total += st
    warm_s = time.perf_counter() - t0
    engine.stage_timer = StageTimer(torch.device(dev))
    steady = MappingStats()
    t0 = time.perf_counter()
    for r, st in engine.map_stream(batches[1:]):
        recs.extend(r)
        steady += st
    steady_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    total += steady
    log(f"[main] kernel launches on the main path: {launches}")
    check(all(n > 0 for n in launches.values()), "a kernel of the main path never launched")
    rps = steady.num_reads / steady_s
    stage_ms = {k: round(v, 3) for k, v in engine.stage_timer.ms.items()}
    log(f"[main] steady {rps:,.1f} reads/s ({steady.num_reads} reads in {steady_s:.3f} s, "
        f"first batch {warm_s:.3f} s) | host-fallback reads {engine.fallback_reads} | "
        f"peak device memory {peak / 2**30:.3f} GiB")
    log(f"[main] device stage ms over {len(batches) - 1} steady batches: {stage_ms}")

    # The oracle: fem_baseline (byte-identical to the reference binary) on
    # the same reads; record multiset and counters must be equal.
    t0 = time.perf_counter()
    sam = os.path.join(os.path.dirname(paths["fq"]), "baseline.sam")
    p = subprocess.run(
        [build_baseline(), "map", "-e", str(E), "-a", str(A), "-t", "1",
         "--ref", paths["fa"], "--index", paths["ix"], "--read1", paths["fq"],
         "-o", sam], check=True, capture_output=True, text=True)
    with open(sam, "rb") as f:
        want_dig, want_cnt = digest_lines([f.read()])
    want_counters = counters_from_stderr(p.stderr)
    got_dig, got_cnt = digest_lines(recs)
    got_counters = [total.num_reads, total.num_mapped_reads,
                    total.num_candidates_without_additional_qgram_filter,
                    total.num_candidates, total.num_mappings]
    log(f"[main] fem_baseline check ({time.perf_counter() - t0:.1f} s): "
        f"records {got_cnt} vs {want_cnt}, digest equal {got_dig == want_dig}, "
        f"counters {got_counters} vs {want_counters}")
    check(got_cnt == want_cnt and got_dig == want_dig,
          "SAM record multiset differs from fem_baseline")
    check(got_counters == want_counters, "counters differ from fem_baseline")
    check(total.num_reads == NUM_READS, "not every read was mapped")
    return launches


def main() -> int:
    smi = phase_device()
    dev = "cuda:0"
    phase_build()
    with tempfile.TemporaryDirectory() as workdir:
        ref, index, paths = phase_setup(workdir)
        rows = phase_kernels(ref, index, dev)
        launches = phase_main(ref, index, paths, dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"[done] card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
