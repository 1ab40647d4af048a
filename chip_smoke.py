#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure raises and the script
exits non-zero without its result line:

  1. device   the card (nvidia-smi name and power limit), torch, CUDA and
              nvcc versions; no CUDA device is an error, never a CPU run.
  2. build    nvcc builds fem_tpu_torch/csrc/*.cu for sm_90a (ptxas -v usage
              printed); g++ builds the port's native host library and the
              fem_baseline oracle from fem_tpu_torch/native/src/.
  3. setup    the bench operating point (bench.py, BASELINE.json config 3):
              a synthetic 46 Mb genome with 30% repeats, k=12 step=3 index,
              65,536 simulated 100 bp reads with up to 5 errors.
  4. kernels  each CUDA kernel against its plain torch version on the card,
              at the main path's shapes, on synthetic inputs; outputs are
              integers and must be exactly equal. Times are CUDA-event
              medians of the wrapper's call (Myers' includes its small
              accept compare): `ms` back to back (inputs as warm as the
              50 MB L2 keeps them), `ms_cold` with the L2 overwritten
              before every launch, `ms_single` one launch at a time on an
              idle device (the host's launch gap is in it); `ms_profiler`
              is the kernel alone, by torch.profiler.
  5. main     MappingEngine.map_stream on the card at e=5 a=1, B=16384,
              cap_occ=80, cap_cand=16, vpr=2, apr=0.85, tier 0 only. Both
              kernels must have launched, and the SAM record multiset and
              the five counters must equal fem_baseline's on the same reads.
  6. replay   each kernel again on the inputs the main path gave it in one
              steady batch (captured while that batch is mapped once more,
              after the timed and counted run): equal to the plain version,
              then timed warm and cold like phase 4. On the main path the
              slabs were written just before the kernel runs, so the warm
              number is the nearer one there.

Each kernel's bound is the least time the card could take for the same
inputs: the bytes it must move (inputs once, outputs once) over 3.35 TB/s,
or its unavoidable int32 operations over 64 lanes x SMs x the max SM clock
nvidia-smi reports, whichever is larger. No single PyTorch call computes
either function, so library_ms is null.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64
# int32 instructions a Myers step cannot do without: 11 for the recurrence of
# myers_core.h:step with three-input logic (LOP3), 6 for the least Eq from
# bit planes (three funnel shifts, three logic operations over xors and band).
MYERS_OPS_PER_STEP = 17
# Times of the first versions of the kernels at the phase-4 shapes, one
# launch at a time (as `ms_single` here): another call on the same card
# model (NVIDIA H100 80GB HBM3, 700 W). Logged for reference only; not in
# the kernel table, whose numbers are all this run's.
EARLIER_MS_SINGLE = {"filter_tail": 0.554, "banded_myers": 0.108}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


_l2_scratch = None


def flush_l2() -> None:
    """Overwrite 256 MB, five times the L2, so the next launch finds its
    inputs in device memory only."""
    global _l2_scratch
    if _l2_scratch is None:
        _l2_scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    _l2_scratch.add_(1)


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Median time of fn() in ms by CUDA events, after one warm-up call.
    Warm: a sample is a run of `reps` calls between two events, over
    `reps`; the device is first kept busy for a few ms, so the host has
    every call enqueued before the first starts and its launch gaps are not
    in the time. Cold: the L2 is overwritten before every timed call."""
    fn()
    times = []
    for _ in range(reps if cold else 5):
        for _ in range(1 if cold else 24):
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if cold else reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / (1 if cold else reps))
    return statistics.median(times)


def single_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one fn() at a time on an idle device, in
    ms, after one warm-up call: the host's launch gaps are in it."""
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


def profiler_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the CUDA kernel whose name contains `kernel`,
    from torch.profiler over reps + 2 calls of fn(). The trace may lose a
    launch made while it starts, so at least `reps` of them must be in it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 2):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            count += ev.count
    check(reps <= count <= reps + 2 and total > 0,
          f"torch.profiler saw {kernel} {count} times in {reps + 2} calls, {total} us")
    return total / count / 1e3


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


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """Peak int32 ALU rate: lanes x SMs x the max SM clock."""
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def bound(nbytes: int, ops: int) -> dict:
    """bound_ms, the larger of bytes over the memory rate and operations
    over the int32 rate, and which of the two it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / int32_ops_per_s() * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(nbytes), "bound_int32_ops": int(ops)}


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke runs only on a GPU")
    from fem_tpu_torch import kernels

    smi = _smi("name,power.limit")
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda} | nvcc {nvcc} | "
        f"max SM clock {_smi('clocks.max.sm')}, int32 peak "
        f"{int32_ops_per_s() / 1e12:.2f} Top/s")
    return smi


def phase_build() -> None:
    from fem_tpu_torch import kernels
    from fem_tpu_torch.native import build as native_build

    name = "?"
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.library()
    log(f"[build] {kernels.LIB_PATH} built in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"(filter_tail_kernelILi\d+|banded_myers_kernel)", m.group(1))
            name = name.group(1) if name else m.group(1)
        elif "registers" in line or "spill" in line:
            log(f"[build] ptxas {name}: {line.replace('ptxas info    :', '').strip()}")
    t0 = time.perf_counter()
    lib, base = native_build.build_native(force=True), native_build.build_baseline(force=True)
    log(f"[build] {lib} and {base} built in {time.perf_counter() - t0:.1f} s")


def phase_setup(workdir: str):
    from fem_tpu_torch import sim
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.index.storage import save_index
    from fem_tpu_torch.io import fastx

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


def tail_bound(sid, diag, cc: int) -> tuple[dict, str]:
    """Bound of one filter_tail call on these slabs, and a line about them.
    Bytes: both slabs in, cc (sid, pos) pairs and one flag a lane out.
    Operations: one validity compare a slot, and n log2 n compare-exchanges
    for a group's n valid keys (sort) plus n to merge and fold them."""
    from fem_tpu_torch.ops.types import SENTINEL_SID

    NB = sid.shape[0]
    n = (sid != SENTINEL_SID).sum(dim=2).double()  # valid keys per (lane, group)
    ops = sid.numel() + int((n * (torch.log2(n.clamp(min=2)).ceil() + 1)).sum())
    nbytes = sid.numel() * 4 + diag.numel() * 4 + NB * (cc * 8 + 1)
    note = (f"valid keys per (lane, group): mean {float(n.mean()):.2f}, "
            f"max {int(n.max())}, groups over 32 keys {float((n > 32).double().mean()):.1%}")
    return bound(nbytes, ops), note


def myers_bound(v_sid, v_pos, v_lane, both, lens, e: int, used) -> tuple[dict, str]:
    """Bound of one banded_myers call on these slots, and a line about them.
    Bytes: per slot in use 12 of indices, its window (length + 2e) and 8 of
    results; each read that is used, once; 8 of results per unused slot.
    Operations: MYERS_OPS_PER_STEP int32 instructions a step (recurrence
    and least Eq), `length` steps a slot in use."""
    V = v_sid.shape[0]
    NB, Lmax = both.shape
    n_used = V if used is None else min(int(used), V)
    lane = v_lane[:n_used].long().clamp(0, NB - 1)
    steps = lens[lane].clamp(0, Lmax).long()
    reads = torch.unique(lane)
    nbytes = (n_used * 20 + int((steps + 2 * e).sum()) + (V - n_used) * 8
              + int(lens[reads].clamp(0, Lmax).sum()) + 4 * reads.numel())
    note = (f"slots in use {n_used} of {V}, mean length "
            f"{float(steps.double().mean()) if n_used else 0.0:.1f}, reads used {reads.numel()}")
    return bound(nbytes, int(steps.sum()) * MYERS_OPS_PER_STEP), note


def compare_and_time(name: str, what: str, kernel, plain, plain_reps: int) -> dict:
    """kernel() against plain() on the same inputs (exact), then the times."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    d = max_abs_err(got, want)
    check(d == 0, f"{name} differs from its plain version on {what}")
    return {"max_abs_err": d, "ms": cuda_ms(kernel, 20),
            "ms_single": single_ms(kernel, 20),
            "ms_cold": cuda_ms(kernel, 20, cold=True),
            "ms_profiler": profiler_ms(kernel, f"{name}_kernel"),
            "plain_ms": cuda_ms(plain, plain_reps)}


def phase_kernels(ref, index, dev) -> list[dict]:
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain
    from fem_tpu_torch.ops.types import BIG, SENTINEL_SID, device_index_from_host
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    rng = np.random.default_rng(2024)
    dindex = device_index_from_host(index, ref, dev)
    rows = []

    # Banded Myers: V = 65,536 slots, Lmax = 128, e in {0, 2, 5, 7}; then the
    # slab half in use, as the main path leaves it.
    row = {"name": "banded_myers", "route": "cuda",
           "source": "fem_tpu_torch/csrc/banded_myers.cu",
           "replaces": "fem_tpu/ops/verify_pallas.py:122", "library_ms": None}
    err = 0
    for e in (0, 2, 5, 7):
        args = _myers_inputs(ref, e, rng, dev)
        V = args[0].shape[0]
        for used in (None, torch.tensor(V // 2, device=dev)):
            got = verify_candidates(dindex, *args, e, used=used)
            want = verify_candidates_plain(dindex, *args, e, used=used)
            torch.cuda.synchronize()
            d = max_abs_err(got, want)
            n_acc = int(want.accepted.sum())
            log(f"[kernels] banded_myers e={e} V={V} used={'all' if used is None else int(used)}: "
                f"max_abs_err {d}, {n_acc} accepted")
            check(d == 0, f"banded_myers differs from its plain version at e={e}")
            check(0 < n_acc < V, "banded_myers check accepts all or none")
            err = max(err, d)
        if e == E:
            row.update(compare_and_time(
                "banded_myers", "synthetic slots",
                lambda: verify_candidates(dindex, *args, e),
                lambda: verify_candidates_plain(dindex, *args, e), 5))
            bnd, note = myers_bound(*args, e, None)
            row.update(bnd)
            log(f"[kernels] banded_myers synthetic: {note}")
    row["max_abs_err"] = max(err, row["max_abs_err"])
    rows.append(row)
    _log_times("[kernels] banded_myers", f"at e={E}", row, row)

    # Filter tail: NB = 32,768 lanes, G = 3 groups, clustered slabs
    # (tests/test_filter_kernel.py:_random_slabs), plus cap_cand + cap_occ = 512.
    row = {"name": "filter_tail", "route": "cuda",
           "source": "fem_tpu_torch/csrc/filter_tail.cu",
           "replaces": "fem_tpu/ops/filter_tail_pallas.py:213", "library_ms": None}
    err = 0
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
            row.update(compare_and_time(
                "filter_tail", "synthetic slabs",
                lambda: filter_tail(sid, diag, CC, E, a),
                lambda: filter_tail_plain(sid, diag, CC, E, a), 3))
            bnd, note = tail_bound(sid, diag, CC)
            row.update(bnd)
            log(f"[kernels] filter_tail synthetic: {note}")
    row["max_abs_err"] = max(err, row["max_abs_err"])
    rows.append(row)
    _log_times("[kernels] filter_tail", f"at CAP=80 CC=16 a={A}", row, row)
    for r in rows:
        log(f"[kernels] {r['name']}: its first version read "
            f"{EARLIER_MS_SINGLE[r['name']]} ms one launch at a time in another call "
            f"on the same card model; this run {r['ms_single']:.4f} ms so timed")
    return rows


def _log_times(head: str, what: str, res: dict, bnd: dict) -> None:
    log(f"{head} {what}: {res['ms']:.4f} ms warm, {res['ms_cold']:.4f} ms cold, "
        f"{res['ms_single']:.4f} ms one launch at a time, {res['ms_profiler']:.4f} ms "
        f"by the profiler, plain {res['plain_ms']:.3f} ms, bound "
        f"{bnd['bound_ms'] * 1e3:.2f} us by {bnd['bound_by']}")


def phase_replay(rows: list[dict], captured: dict) -> None:
    """Each kernel on the inputs one steady batch of the main path gave it."""
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    by_name = {r["name"]: r for r in rows}
    check(set(captured) == set(by_name), f"captured inputs of {sorted(captured)} only")

    (sid, diag, cc, e, a), _ = captured["filter_tail"]
    res = compare_and_time("filter_tail", "the main path's slabs",
                           lambda: filter_tail(sid, diag, cc, e, a),
                           lambda: filter_tail_plain(sid, diag, cc, e, a), 3)
    bnd, note = tail_bound(sid, diag, cc)
    _record_replay(by_name["filter_tail"], res, bnd,
                   f"NB={sid.shape[0]} G={sid.shape[1]} CAP={sid.shape[2]} CC={cc} "
                   f"e={e} a={a}; {note}")

    (dindex, v_sid, v_pos, v_lane, both, lens, e), kw = captured["banded_myers"]
    used = kw["used"]
    res = compare_and_time(
        "banded_myers", "the main path's slab",
        lambda: verify_candidates(dindex, v_sid, v_pos, v_lane, both, lens, e, used=used),
        lambda: verify_candidates_plain(dindex, v_sid, v_pos, v_lane, both, lens, e, used=used),
        5)
    bnd, note = myers_bound(v_sid, v_pos, v_lane, both, lens, e, used)
    _record_replay(by_name["banded_myers"], res, bnd,
                   f"V={v_sid.shape[0]} Lmax={both.shape[1]} e={e}; {note}")


def _record_replay(row: dict, res: dict, bnd: dict, what: str) -> None:
    row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
    row.update(ms_main_inputs=res["ms"], ms_main_inputs_cold=res["ms_cold"],
               ms_main_inputs_single=res["ms_single"],
               ms_main_inputs_profiler=res["ms_profiler"],
               plain_ms_main_inputs=res["plain_ms"],
               bound_ms_main_inputs=bnd["bound_ms"], bound_by_main_inputs=bnd["bound_by"])
    _log_times(f"[replay] {row['name']}", f"on the main path's inputs ({what})", res, bnd)


def _capture_first_call(module, attr: str, into: dict, key: str):
    """Wrap module.attr so that its first call's arguments are kept (tensors
    cloned) in into[key]; returns the function that undoes the wrap."""
    real = getattr(module, attr)
    keep = lambda x: x.clone() if torch.is_tensor(x) else x

    def wrapped(*args, **kwargs):
        if key not in into:
            into[key] = ([keep(x) for x in args], {k: keep(v) for k, v in kwargs.items()})
        return real(*args, **kwargs)

    setattr(module, attr, wrapped)
    return lambda: setattr(module, attr, real)


def phase_main(ref, index, paths, dev) -> tuple[dict, dict]:
    from fem_tpu_torch import kernels
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.native.build import build_baseline
    from fem_tpu_torch.ops import candidates as candidates_mod
    from fem_tpu_torch.pipeline import engine as engine_mod
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine, StageTimer
    from fem_tpu_torch.stats import MappingStats

    args = FemArgs(kmer_size=KMER, step_size=STEP, error_threshold=E,
                   num_additional_qgrams=A)
    config = EngineConfig(batch_size=BATCH, cap_occ=80, cap_cand=16,
                          verify_per_read=2, accept_per_read=0.85)
    engine = MappingEngine(args, ref, index, config)  # the default device: the card
    check(engine.device.type == "cuda", "MappingEngine did not default to the card")
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
    first_steady = None  # the first steady batch's records
    for r, st in engine.map_stream(batches[1:]):
        first_steady = r if first_steady is None else first_steady
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

    # The kernels' inputs in one steady batch, for phase 6: that batch is
    # mapped once more, outside the timed and counted run above.
    captured: dict = {}
    undo = [_capture_first_call(candidates_mod, "filter_tail", captured, "filter_tail"),
            _capture_first_call(engine_mod, "verify_candidates", captured, "banded_myers")]
    again = [r for rs, _ in engine.map_stream(batches[1:2]) for r in rs]
    for restore in undo:
        restore()
    check(digest_lines(again) == digest_lines(first_steady),
          "the batch mapped again for capture gave other records")

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
    return launches, captured


def main() -> int:
    smi = phase_device()
    dev = "cuda:0"
    phase_build()
    with tempfile.TemporaryDirectory() as workdir:
        ref, index, paths = phase_setup(workdir)
        rows = phase_kernels(ref, index, dev)
        launches, captured = phase_main(ref, index, paths, dev)
        phase_replay(rows, captured)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["bound_us"] = row["bound_ms"] * 1e3
    log(f"[done] card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
