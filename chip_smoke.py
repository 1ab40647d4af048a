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
              is the kernel alone, by torch.profiler. Besides the tier-0
              shapes of the benign point: the adversarial point's tier-0
              shapes (the filter tail at 80 + 64 over 32,768 lanes, banded
              Myers at 262,144 slots over 32,768 lanes); the filter tail
              at the default ladder's tier-1 (cap_occ 640 + cap_cand 512,
              a block of 256 threads a lane) and tier-2 (5120 + 4096, a
              block of 1024 threads a lane, its scratch in shared memory)
              shapes; banded Myers at tier 2's 262,144 slots with 300 in
              use: each a row of its own. The filter tail at 4096 + 4096
              and at 12288 + 4096 (scratch in a global-memory workspace):
              equality. Which program a width takes is the wrapper's
              `plan` (csrc/filter_tail_core.h:ft::plan), read here too.
              Banded Myers over a 2.2 GB flat reference on the card (code 4
              throughout) whose chromosome is written past byte 2^31, as
              the 3 Gb genome's last chromosomes lie: exactly equal to the
              plain version at e = 5 and 7.
  5. main     the engine on the card through the pipelined
              MappingEngine.map_stream (depth EngineConfig.pipeline_depth)
              with the default retry ladder, twice:
              benign       the bench point, e=5 a=1, B=16384, cap_occ=80,
                           cap_cand=16, vpr=2, apr=0.85. After the counted
                           run the same batches are mapped one at a time
                           (map_batch in a loop) and pipelined again, in
                           turns, and both rates are printed.
              adversarial  a 46 Mb genome with 3% satellite arrays
                           (bench.py's adversarial line), 65,536 reads,
                           cap_occ=80, cap_cand=64, vpr=8, apr=8: the
                           ladder's own path. Reads must be retried, the
                           filter tail must launch above cap_cand +
                           cap_occ = 512, and tier 2 must be reached.
              The step runs as one CUDA graph per (tier, Lmax): first one
              eager tier-0 dispatch with every host sync an error
              (torch.cuda.set_sync_debug_mode), then the counted run, in
              which each key's first dispatch runs eagerly and is then
              captured and every later one replays the graph; a line
              names the keys, each capture's time, each graph's memory
              and replays, and every dispatch must have gone through
              them. In each the kernels must have launched (counts set
              to 0 before the run and read after it; a replay counts the
              launches its capture recorded, so one launch of each kernel
              a dispatch; a row's launches are the wrappers' count at that
              row's shape), and the SAM record multiset and the five
              counters must equal fem_baseline's on the same reads. Each
              point is then mapped again for its steady rates, once under
              torch.profiler for the device's busy and idle share of the
              wall (printed only if the trace holds the replays' kernels),
              and once with the eager step (engine.eager_step) and a
              StageTimer: its per-stage device times and its submit_batch
              times beside the graphs'; every such run must give the
              counted run's records. Last, the benign reads go once
              through an engine without a ladder (tiers=()), read from
              the FASTQ file by a ThreadedBatchSource: its overflow reads
              must reach the host mapper and its records must be the
              counted run's.
  6. replay   each kernel again on the inputs a main path gave it (the
              first tier-0 calls and the first tier-1 filter-tail call of
              the benign stream; the first tier-0, tier-1 and tier-2
              calls of the adversarial one), captured while the stream is
              mapped once more with the eager step (a replay calls no
              wrapper) after the timed and counted runs: equal to the plain
              version, then timed warm and cold like phase 4. On the main
              path the slabs were written just before the kernel runs, so
              the warm number is the nearer one there. The occurrence
              slab's rows are made here, on its main-path inputs alone
              (its seed tables come from the steps before it): the benign
              tier 0 (cap_occ 80 over 32,768 lanes), the adversarial tier 1
              (640 over 1,024) and tier 2 (5120 over 128).
  7. cli      the command line on the benign point's files, as a user runs
              it (fem_tpu_torch/pipeline/cli.py): `index 12 3` must write
              phase 3's index bytes; `map` with the benign point's flags
              (B=16384, --cap-occ 80 --cap-cand 16 --verify-per-read 2
              --accept-per-read 0.85, the default ladder) in this process,
              the kernels' counts set to 0 just before and read just after:
              both kernels launched at the tier-0 shapes, SAM records and
              the five stderr counters == fem_baseline, the --stats-json
              file agreeing; `map --checkpoint` (the ordered stream), each
              checkpoint's offset on disk when it is written, then a crash
              after the first checkpoint (a garbage tail) and a resume that
              must be byte-equal to the full run; `python -m fem_tpu_torch
              map -t 1` and `-t 2` as processes of their own, in turns,
              each equal to the in-process run. Walls include process
              start and index load; the peak device memory is the
              in-process run's. A kernel row's `launches_cli` is the
              in-process run's count at the row's shape.
  8. bench    `python -m fem_tpu_torch.bench` as a process of its own at
              131,072 benign and 65,536 adversarial reads (bench.py's
              defaults are 327,680 and 163,840): both JSON lines must be
              equal to fem_baseline for every swept worker count (2 and 1),
              and its workers must have launched both kernels.
  9. parallel the grids of fem_tpu_torch/parallel/, every cell on cuda:0
              (a grid may name one card more than once; a machine with more
              cards says so and still names cuda:0 only). On the benign
              point through the pipelined stream with the default ladder: a
              data grid of 2, then coordinate-sharded (data, index) grids
              (1, 4) and (2, 2); the adversarial point on (1, 2), its
              retries through the sharded ladder (retried reads, tier
              dispatches, and the host-mapped reads beyond phase 5's, which
              are the halo-risk reads, printed); the CLI in this process
              with --index-shards 2; two `python -m fem_tpu_torch map`
              processes on cuda:0 joined by torch.distributed
              (--coordinator on a free local port), once independent and
              once as one (2, 2) grid with --index-shards 2 (gloo: NCCL
              refuses two ranks on one GPU; the [dist] lines must say so).
              Every run: records and counters == fem_baseline, every kernel
              launched. Grids run through their GridPrograms, one per
              (tier, Lmax): every dispatch padded to its tier's batch size
              and split evenly over the data rows, each cell's step a CUDA
              graph a segment (one on a data grid, three on an index grid,
              the rows' reductions eager between them). For each grid in
              this process (data 2, (1, 4), (2, 2), adversarial (1, 2)):
              the first tier-0 dispatch eagerly under
              set_sync_debug_mode("error"); the counted run, whose every
              dispatch after a key's first must be a replay (a line gives
              the keys and each cell's capture time, graph memory and
              replays) with one launch of each kernel a cell a dispatch
              (the occurrence slab two on an index grid: the cell's own
              bound, then its slab at the bound reduced over the index
              axis); a
              run under torch.profiler, which must see each kernel as often
              as the wrappers counted; a run with engine.eager_step, which
              must give the same records; for data 2 and (1, 4), steady
              reads/s with the eager step and through the graphs in turns
              (eager, graphs, graphs, eager), with the card's name and
              power limit. The inputs replayed in phase 6's manner are
              captured with the eager step (a replay calls no wrapper). The
              CLI in this process runs under torch.profiler (its counts
              against the wrappers'), and it and both ranks of each
              two-process run write --engine-json, whose step programs must
              all have replayed after each key's first dispatch. (The two
              processes' first dispatch is not held under the sync debug
              mode: their gloo reductions between the segments go through
              host memory by design; the segments are the (2, 2) grid's,
              held here.) Kernel rows at the per-shard shapes: the filter
              tail over 32,768 lanes (a (1, n_ip) row) and 16,384 (n_dp =
              2), banded Myers at 16,384 slots over 32,768 lanes, on
              synthetic inputs and replayed on a (1, 4) shard's own (for
              Myers, a shard whose reference slice has negative offsets);
              the occurrence slab on a (1, 4) cell's own inputs, both of
              its launches held, the second a row.
  10. configs the parameter sweep of tests/test_config_matrix.py (e=7 a=2,
              e=0, e=5 a=0, k=10 step=5, 148 bp reads, 76 bp at step 2)
              and the soak's e=7 150 bp line (Lmax 160, the widest band),
              on the benign point's genome: 20,000 reads each (one full
              tier-0 batch and one padded batch of 3,616) through the
              pipelined stream and the step graphs, with the benign
              point's caps and the default ladder; records and counters
              == fem_baseline (64-bit counters: outside FEM's step bound,
              e7_a2 and len76_step2, no read maps and the pre-filter
              counter passes 2^32); retried reads, dispatches by tier,
              host-mapped reads, the keys captured and their capture
              times printed.
  11. scale   tools/torch_grch38_scale.py as a process of its own, cut to
              0.25 Gb and 20,000 reads: the GRCh38 profile's 24 chromosomes,
              `python -m fem_tpu_torch index 12 3` byte-equal to
              fem_baseline's, `map -e 5 -a 1` at the command line's
              defaults (B=10,000, 256 + 256, 16 verify slots a lane)
              unsharded and on a (1, 4) grid on cuda:0, each equal to
              fem_baseline in records and counters and to the golden
              oracle on the first 64 reads, every kernel launched, every
              dispatch after a key's first a replay of the step graphs (the
              grid's GridPrograms of four cells included); a line a stage
              (seconds, peak host RSS, peak device memory, retries, launches
              by shape, each shard's occurrences, the step programs). Then
              the maps' first batch again in this process: unsharded with the eager
              step, the filter tail's call at 256 + 256 over 20,000 lanes
              and Myers' at 320,000 slots; on a (1, 4) grid on cuda:0, a
              cell's filter tail at 256 + 256 and its Myers at 80,000
              slots against the cell's own reference slice; the occurrence
              slab at 256 over 20,000 lanes, unsharded and a cell's second
              launch. Each is held against its plain version and timed, a
              row of its own whose launches are the tool's map's count at
              that shape (the unsharded map's, or the grid's). The
              unsharded seed tables also feed the occurrence slab at the
              ladder's wider cap_occ, 2048 over 1,024 lanes and 16,384
              over 128 (the lanes over 256 first), in its three modes:
              exactly equal to the plain version, timed warm.

Each kernel's bound is the least time the card could take for the same
inputs: the bytes it must move (inputs once, outputs once) over 3.35 TB/s,
or its unavoidable int32 operations over 64 lanes x SMs x the max SM clock
nvidia-smi reports, whichever is larger (the occurrence slab's bytes: its
seed tables and the occurrences its runs cover in, its two int32 slabs,
flags and bounds out; occ_bound_of). No single PyTorch call computes any
of these functions, so library_ms is null.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

GENOME_BP = 46_000_000
NUM_READS = 65_536
BATCH = 16_384
E, A = 5, 1
KMER, STEP = 12, 3
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
# The default retry ladder both operating points below derive (cap_occ 80,
# B 16,384): (reads, cap_occ, cap_cand) of a tier, and tier 2's verify slots.
TIER1 = (512, 640, 512)
TIER2 = (64, 5120, 4096)
TIER2_VERIFY_SLOTS = 262_144
# The adversarial point's tier 0: (cap_occ, cap_cand), and its verify slots
# (2 * B * verify_per_read, as many as tier 2's but over 2 * B lanes).
ADV_TAIL = (80, 64)
ADV_VERIFY_SLOTS = 262_144
# Phase 11: tools/torch_grch38_scale.py cut to 0.25 Gb and 20,000 reads; its
# maps run the command line's defaults.
SCALE_ARGS = ["--gb", "0.25", "--reads", "20000"]
SCALE_BATCH = 10_000
SCALE_TAIL = (256, 256)
SCALE_VERIFY_SLOTS = 2 * SCALE_BATCH * 16
# Phase 4: a flat reference of 2.2 GB whose chromosome starts past byte 2^31.
FAR_REF_BYTES = 2_200_000_000
FAR_OFFSET = 2**31 + 12_345
# Which launches a row of the kernel table counts: the kernel, a test of
# the shape kernels.count_launch was given, and the main path it is read on.
ROW_LAUNCHES = {
    "filter_tail": ("filter_tail", lambda s: s == (80, 16), "benign"),
    "banded_myers": ("banded_myers", lambda s: s == (4 * BATCH, 2 * BATCH), "benign"),
    "filter_tail_adv": ("filter_tail", lambda s: s == ADV_TAIL, "adversarial"),
    "banded_myers_adv": ("banded_myers",
                         lambda s: s == (ADV_VERIFY_SLOTS, 2 * BATCH), "adversarial"),
    "filter_tail_tier1": ("filter_tail", lambda s: s == TIER1[1:], "adversarial"),
    "filter_tail_tier2": ("filter_tail", lambda s: s == TIER2[1:], "adversarial"),
    "banded_myers_tier2": ("banded_myers", lambda s: s[0] == TIER2_VERIFY_SLOTS
                           and s[1] <= 2 * TIER2[0], "adversarial"),
    # Phase 9's cells: a (1, 4) grid's cells map 16,384 reads each against
    # a quarter of the index, with a quarter of the verify slots; a (2, 2)
    # grid's, 8,192 reads.
    "filter_tail_shard": ("filter_tail", lambda s: s == (80, 16), "grid_1x4"),
    "filter_tail_shard_dp2": ("filter_tail", lambda s: s == (80, 16), "grid_2x2"),
    "banded_myers_shard": ("banded_myers", lambda s: s == (BATCH, 2 * BATCH), "grid_1x4"),
    # Phase 10's tier-0 steps at the sweep's widths: e=7 a=2 on 150 bp reads
    # (Lmax 160, the 15-bit band), and e=4 on 76 bp reads (Lmax 96).
    "filter_tail_e7_a2": ("filter_tail", lambda s: s == (80, 16), "configs_e7_len150"),
    "banded_myers_lmax160": ("banded_myers", lambda s: s == (4 * BATCH, 2 * BATCH),
                             "configs_e7_len150"),
    "banded_myers_lmax96": ("banded_myers", lambda s: s == (4 * BATCH, 2 * BATCH),
                            "configs_len76_step2"),
    # Phase 11's unsharded map at the command line's defaults: B = 10,000,
    # cap_occ 256 + cap_cand 256, 16 verify slots a read-strand lane.
    "filter_tail_scale": ("filter_tail", lambda s: s == SCALE_TAIL, "scale"),
    "banded_myers_scale": ("banded_myers",
                           lambda s: s == (SCALE_VERIFY_SLOTS, 2 * SCALE_BATCH), "scale"),
    # Its (1, 4) grid on one card: a cell's B reads against a quarter of the
    # index, with a quarter of the verify slots.
    "filter_tail_scale_shard": ("filter_tail", lambda s: s == SCALE_TAIL, "scale_grid"),
    "banded_myers_scale_shard": ("banded_myers",
                                 lambda s: s == (SCALE_VERIFY_SLOTS // 4, 2 * SCALE_BATCH),
                                 "scale_grid"),
    # The occurrence slab, keyed (cap_occ, lanes), each row on the inputs its
    # main path gave it (phase 6, 9 and 11): the benign tier 0, the
    # adversarial point's tiers 1 and 2, a (1, 4) cell's second launch (the
    # slab at the bound reduced over the index axis; its launches count both
    # of the cell's), and phase 11's unsharded map and (1, 4) cell.
    "occ_slab": ("occ_slab", lambda s: s == (80, 2 * BATCH), "benign"),
    "occ_slab_tier1": ("occ_slab", lambda s: s == (TIER1[1], 2 * TIER1[0]), "adversarial"),
    "occ_slab_tier2": ("occ_slab", lambda s: s[0] == TIER2[1] and s[1] <= 2 * TIER2[0],
                       "adversarial"),
    "occ_slab_shard": ("occ_slab", lambda s: s == (80, 2 * BATCH), "grid_1x4"),
    "occ_slab_scale": ("occ_slab", lambda s: s == (SCALE_TAIL[0], 2 * SCALE_BATCH), "scale"),
    "occ_slab_scale_shard": ("occ_slab", lambda s: s == (SCALE_TAIL[0], 2 * SCALE_BATCH),
                             "scale_grid"),
}
# Where each kernel's launches by shape lie in a run's record.
SHAPES_KEY = {"filter_tail": "tail_shapes", "banded_myers": "myers_shapes",
              "occ_slab": "occ_shapes"}
# The wider cap_occ of the command line's default ladder (cap_occ 256, B
# 10,000): (tier, reads, cap_occ), held on phase 11's tier-0 seed tables.
SCALE_WIDER = ((1, 512, 2048), (2, 64, 16384))


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


def cuda_ms(fn, reps: int, cold: bool = False, samples: int = 5) -> float:
    """Median time of fn() in ms by CUDA events, after one warm-up call.
    Warm: a sample is a run of `reps` calls between two events, over
    `reps`; the device is first kept busy for a few ms, so the host has
    every call enqueued before the first starts and its launch gaps are not
    in the time. Cold: the L2 is overwritten before every timed call."""
    fn()
    times = []
    for _ in range(reps if cold else samples):
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
    from torch.profiler over reps + 11 calls of fn(), the first finished
    before the others start. The trace can lose the launches made while it
    starts (more of them the shorter the kernel), so at least `reps` must
    be in it; a trace that lost more is taken again, three times at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()  # a first launch inside the trace, finished before the timed ones
            torch.cuda.synchronize()
            for _ in range(reps + 10):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                total += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                count += ev.count
        if reps <= count <= reps + 11 and total > 0:
            return total / count / 1e3
        log(f"[profiler] saw {kernel} {count} times in {reps + 11} calls, {total} us "
            f"(attempt {attempt + 1})")
    raise RuntimeError(f"torch.profiler lost launches of {kernel} in three traces")


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired integer tensors."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def digest_lines(chunks) -> tuple[int, int]:
    """Order-independent digest of SAM record lines, the bench's: the sum of
    per-record blake2b-128 digests mod 2^128, and the record count."""
    from fem_tpu_torch.bench import _digest_lines

    return _digest_lines(chunks)


def counters_from_stderr(stderr: str) -> list[int]:
    """The five counters the reference prints (src/FEM_map.c:214-218), read
    as the bench reads them; a missing one is an error."""
    from fem_tpu_torch.bench import _counters_from_stderr

    out = _counters_from_stderr(stderr)
    check(len(out) == 5, f"no five counter lines in: {stderr[-2000:]}")
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
            name = re.search(
                r"(filter_tail_(?:block_|ws_)?kernelILi\d+|banded_myers_kernel"
                r"|occ_slab_kernelILi\d+)",
                m.group(1))
            name = name.group(1) if name else m.group(1)
        elif "registers" in line or "spill" in line:
            log(f"[build] ptxas {name}: {line.replace('ptxas info    :', '').strip()}")
    t0 = time.perf_counter()
    lib, base = native_build.build_native(force=True), native_build.build_baseline(force=True)
    log(f"[build] {lib} and {base} built in {time.perf_counter() - t0:.1f} s")


def phase_setup(workdir: str, tag: str, seqs, read_seed: int):
    """Reference, index and reads of one operating point, as files under
    workdir/tag (fem_baseline reads them) and in memory."""
    from fem_tpu_torch import sim
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.index.storage import save_index
    from fem_tpu_torch.io import fastx

    t0 = time.perf_counter()
    os.makedirs(os.path.join(workdir, tag))
    paths = {k: os.path.join(workdir, tag, f) for k, f in
             (("fa", "ref.fa"), ("fq", "reads.fq"), ("ix", "ref.index"))}
    sim.write_fasta(paths["fa"], seqs)
    ref = fastx.read_fasta(paths["fa"])
    index = build_index(ref, KMER, STEP)
    save_index(index, paths["ix"])
    reads = sim.simulate_reads(seqs, NUM_READS, read_length=100, max_errors=E, seed=read_seed)
    sim.write_fastq(paths["fq"], reads)
    freq = np.diff(index.lookup.astype(np.int64))
    log(f"[setup] {tag}: {GENOME_BP / 1e6:.0f} Mb genome, {index.num_occurrences} "
        f"occurrences, largest seed frequency {int(freq.max())}, {NUM_READS} reads "
        f"in {time.perf_counter() - t0:.1f} s")
    return ref, index, paths


def benign_genome():
    """The bench operating point (bench.py, BASELINE.json config 3)."""
    from fem_tpu_torch import sim

    return sim.random_genome(GENOME_BP, num_seqs=1, seed=7, repeat_fraction=0.3)


def satellite_genome():
    """bench.py's adversarial line: 3% of the genome in satellite arrays."""
    from fem_tpu_torch import sim

    return sim.satellite_genome(GENOME_BP, num_seqs=2, seed=13, satellite_fraction=0.03,
                                unit_range=(24, 160), copies_range=(48, 512))


def _myers_inputs(ref, e: int, rng, dev, NB: int = 2 * BATCH, V: int | None = None,
                  Lmax: int = 128):
    """Verify slots at the main path's shape: 2 slots per read-strand lane
    of a 16,384-read batch, Lmax 128 (or V slots over NB lanes, or another
    Lmax; half the reads take lengths up to the full Lmax). Lane l's
    read is the diagonal of slot 2l's reference window with up to e+1
    substitutions (the mutated copies of tests/test_verify_pallas.py), so
    part of the slots are accepted; slot 2l+1 points elsewhere, a few of
    them into the trailing gap. With fewer than 2 slots a lane, the lanes
    no slot names hold windows from elsewhere."""
    V = 2 * NB if V is None else V
    L0 = int(ref.lengths[0])
    v_lane = (np.arange(V, dtype=np.int32) // 2) % NB
    v_sid = np.zeros(V, np.int32)
    v_pos = rng.integers(0, L0 - Lmax - 2 * e, V).astype(np.int32)
    v_pos[1:64:2] = rng.integers(L0 - Lmax, L0 + 40, 32)
    lens = np.full(NB, min(100, Lmax), np.int32)
    lens[NB // 2 :] = rng.integers(40, Lmax + 1, NB - NB // 2)
    starts = v_pos[0 : 2 * NB : 2]
    if starts.shape[0] < NB:  # fewer slots than 2 a lane: the other reads are random windows
        starts = np.concatenate([starts, rng.integers(0, L0 - Lmax - 2 * e, NB - starts.shape[0])])
    off = int(ref.offsets[0]) + starts.astype(np.int64) + e
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


def occ_bound_of(off_s, lfreq_s, start_s, lane_ok, cap: int, mode: str) -> tuple[dict, str]:
    """Bound of one occurrence-slab call at `cap` slots, and a line about it.
    `mode` is "own" (bound and slab), "bound" (no slab) or "given" (the
    slab at a bound read in). Bytes: the three int64 seed tables and the
    lane flags in, the occurrences the runs cover within cap slots (8
    each) in; out the two int32 slabs unless "bound", the flags and the
    int64 bound unless "given" (which reads its bound instead).
    Operations: one compare a slot written, or a slot covered."""
    NB, G, S = off_s.shape
    items = NB * G
    fc = lfreq_s.clamp(max=cap + 1)
    srow = off_s & 7
    fc8 = torch.where(fc > 0, ((srow + fc + 7) // 8) * 8, 0)
    first = torch.cumsum(fc8, dim=2) - fc8 + srow  # each run's first slot
    covered = ((first + fc).clamp(max=cap) - first).clamp(min=0) * lane_ok[..., None]
    n_occ = int(covered.sum())
    nbytes = items * S * 24 + items + n_occ * 8
    nbytes += 0 if mode == "bound" else items * cap * 8
    nbytes += items * 8 if mode == "given" else items * 9
    ops = n_occ if mode == "bound" else items * cap
    note = (f"{n_occ / items:.2f} occurrences a group read, groups over cap_occ "
            f"{float((fc8.sum(dim=2) > cap).double().mean()):.2%}")
    return bound(nbytes, ops), note


def occ_parts(res) -> list:
    """An occurrence-slab result's tensors, the ones its mode writes."""
    return [x for x in res if x is not None]


def compare_and_time(name: str, what: str, kernel, plain, plain_reps: int,
                     plain_samples: int = 5, cuda_name: str | None = None) -> dict:
    """kernel() against plain() on the same inputs (exact), then the times.
    `cuda_name` is the CUDA kernel's name in the profiler's trace."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    d = max_abs_err(got, want)
    check(d == 0, f"{name} differs from its plain version on {what}")
    return {"max_abs_err": d, "ms": cuda_ms(kernel, 20),
            "ms_single": single_ms(kernel, 20),
            "ms_cold": cuda_ms(kernel, 20, cold=True),
            "ms_profiler": profiler_ms(kernel, cuda_name or f"{name}_kernel"),
            "plain_ms": cuda_ms(plain, plain_reps, samples=plain_samples)}


def phase_kernels(ref, index, dev) -> list[dict]:
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain
    from fem_tpu_torch.ops.types import device_index_from_host
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
    # The parameter sweep's widths (phase 10): Lmax 96 (76 bp reads, e=4),
    # 160 (150 bp, e=7: the 15-bit band and a fifth 32-base chunk of
    # myers_core.h's loop) and 256 (eight chunks).
    for Lmax, e in ((96, 4), (160, 7), (256, 7)):
        args = _myers_inputs(ref, e, rng, dev, Lmax=Lmax)
        V = args[0].shape[0]
        for used in (None, torch.tensor(V // 2, device=dev)):
            got = verify_candidates(dindex, *args, e, used=used)
            want = verify_candidates_plain(dindex, *args, e, used=used)
            torch.cuda.synchronize()
            d = max_abs_err(got, want)
            n_acc = int(want.accepted.sum())
            log(f"[kernels] banded_myers Lmax={Lmax} e={e} V={V} used="
                f"{'all' if used is None else int(used)}: max_abs_err {d}, {n_acc} accepted")
            check(d == 0, f"banded_myers differs from its plain version at Lmax {Lmax}")
            check(0 < n_acc < V, f"banded_myers check at Lmax {Lmax} accepts all or none")
            err = max(err, d)
    row["max_abs_err"] = max(err, row["max_abs_err"], _myers_past_2_31(ref, rng, dev))
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
        sid, diag = _clustered_slabs(rng, NB, G, CAP, dev)
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
    rows += _adversarial_rows(ref, dindex, rng, dev)
    rows += _tier_rows(ref, dindex, rng, dev)
    return rows


def _myers_past_2_31(ref, rng, dev) -> int:
    """Banded Myers over a flat reference of FAR_REF_BYTES (a filler of code
    4 on the card) whose one chromosome, the benign genome's, is written at
    byte FAR_OFFSET, past 2^31: the windows the 3 Gb genome's last
    chromosomes give. Exactly equal to the plain version at e = 5 and 7, on
    the main path's 65,536 slots. Returns the largest difference (0)."""
    from fem_tpu_torch.ops.types import DeviceIndex
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    L0 = int(ref.lengths[0])
    flat = torch.full((FAR_REF_BYTES,), 4, dtype=torch.uint8, device=dev)
    flat[FAR_OFFSET : FAR_OFFSET + L0] = torch.from_numpy(ref.codes_of(0)).to(dev)
    empty = torch.zeros(1, dtype=torch.int64, device=dev)
    far = DeviceIndex(occ=empty, lookup=empty, freq_table=empty.int(), ref_flat=flat,
                      ref_offsets=torch.tensor([FAR_OFFSET], dtype=torch.int64, device=dev),
                      ref_lengths=torch.tensor([L0], dtype=torch.int32, device=dev),
                      num_occurrences=0)
    err = 0
    for e in (E, 7):
        args = _myers_inputs(ref, e, rng, dev)
        got = verify_candidates(far, *args, e)
        want = verify_candidates_plain(far, *args, e)
        torch.cuda.synchronize()
        d = max_abs_err(got, want)
        n_acc = int(want.accepted.sum())
        last = FAR_OFFSET + int(args[1].max()) + args[3].shape[1] + 2 * e
        log(f"[kernels] banded_myers e={e} V={args[0].shape[0]} over a {FAR_REF_BYTES:,}-byte "
            f"reference, windows at bytes {FAR_OFFSET + int(args[1].min()):,} to {last:,} "
            f"(2^31 = {2**31:,}): max_abs_err {d}, {n_acc} accepted")
        check(d == 0, f"banded_myers differs from its plain version past byte 2^31 at e={e}")
        check(0 < n_acc < args[0].shape[0], "banded_myers past 2^31 accepts all or none")
        err = max(err, d)
    del flat, far
    torch.cuda.empty_cache()
    return err


def _clustered_slabs(rng, NB: int, G: int, CAP: int, dev):
    """Tier-0 slabs: 40% of the slots valid, three chromosomes, diagonals
    clustered within 43 (tests/test_filter_kernel.py:_random_slabs)."""
    from fem_tpu_torch.ops.types import BIG, SENTINEL_SID

    sid = rng.integers(0, 3, (NB, G, CAP))
    diag = rng.integers(0, 40, (NB, G, CAP)) + rng.integers(0, 4, (NB, G, CAP))
    valid = rng.random((NB, G, CAP)) < 0.4
    return (torch.from_numpy(np.where(valid, sid, SENTINEL_SID).astype(np.int32)).to(dev),
            torch.from_numpy(np.where(valid, diag, BIG).astype(np.int32)).to(dev))


def _adversarial_rows(ref, dindex, rng, dev) -> list[dict]:
    """The kernels at the adversarial point's tier-0 shapes, where most of
    its reads go: the filter tail at cap_occ 80 + cap_cand 64 over 32,768
    lanes (the kernel's 256-key slab), banded Myers at 262,144 slots over
    32,768 lanes. Each a row of the kernel table."""
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    NB, (CAP, CC) = 2 * BATCH, ADV_TAIL
    sid, diag = _clustered_slabs(rng, NB, STEP, CAP, dev)
    tail = {"name": "filter_tail_adv", "route": "cuda",
            "source": "fem_tpu_torch/csrc/filter_tail.cu",
            "replaces": "fem_tpu/ops/filter_tail_pallas.py:213", "library_ms": None}
    tail.update(compare_and_time(
        "filter_tail", f"synthetic slabs at {CAP} + {CC}",
        lambda: filter_tail(sid, diag, CC, E, A),
        lambda: filter_tail_plain(sid, diag, CC, E, A), 3))
    bnd, note = tail_bound(sid, diag, CC)
    tail.update(bnd)
    log(f"[kernels] filter_tail_adv NB={NB} G={STEP} CAP={CAP} CC={CC} e={E} a={A}: {note}")
    _log_times("[kernels] filter_tail_adv", "synthetic", tail, tail)

    V = ADV_VERIFY_SLOTS
    args = _myers_inputs(ref, E, rng, dev, NB=NB, V=V)
    myers = {"name": "banded_myers_adv", "route": "cuda",
             "source": "fem_tpu_torch/csrc/banded_myers.cu",
             "replaces": "fem_tpu/ops/verify_pallas.py:122", "library_ms": None}
    half = torch.tensor(V // 2, device=dev)
    got = verify_candidates(dindex, *args, E, used=half)
    want = verify_candidates_plain(dindex, *args, E, used=half)
    torch.cuda.synchronize()
    d = max_abs_err(got, want)
    n_acc = int(want.accepted.sum())
    log(f"[kernels] banded_myers_adv e={E} V={V} lanes={NB} used={V // 2}: "
        f"max_abs_err {d}, {n_acc} accepted")
    check(d == 0, "banded_myers differs from its plain version at the adversarial shape")
    check(0 < n_acc < V, "banded_myers_adv check accepts all or none")
    del got, want
    myers.update(compare_and_time(
        "banded_myers", "synthetic slots at the adversarial shape",
        lambda: verify_candidates(dindex, *args, E),
        lambda: verify_candidates_plain(dindex, *args, E), 2, 3))
    bnd, note = myers_bound(*args, E, None)
    myers.update(bnd)
    log(f"[kernels] banded_myers_adv synthetic: {note}")
    _log_times("[kernels] banded_myers_adv", f"at e={E}", myers, myers)
    return [tail, myers]


def _wide_slabs(rng, NB: int, G: int, CAP: int, dev):
    """Slabs of a retry tier: 40% of the slots valid, three chromosomes,
    diagonals spread over 3 * CAP so that hundreds of candidates survive."""
    from fem_tpu_torch.ops.types import BIG, SENTINEL_SID

    sid = rng.integers(0, 3, (NB, G, CAP))
    diag = rng.integers(0, 3 * CAP, (NB, G, CAP))
    valid = rng.random((NB, G, CAP)) < 0.4
    return (torch.from_numpy(np.where(valid, sid, SENTINEL_SID).astype(np.int32)).to(dev),
            torch.from_numpy(np.where(valid, diag, BIG).astype(np.int32)).to(dev))


def _tier_rows(ref, dindex, rng, dev) -> list[dict]:
    """The kernels at the default ladder's shapes above tier 0 (the ladder
    MappingEngine derives from cap_occ=80, cap_cand=16, B=16384: tier 1 is
    512 reads at 640 + 512, tier 2 is 64 reads at 5120 + 4096 with 262,144
    verify slots), each a row of the kernel table."""
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain, plan
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    rows = []
    tier2 = plan(*TIER2[1:])
    check(tier2.in_shared_memory and tier2.threads == 1024,
          f"the default tier 2 is not a 1024-thread lane in shared memory: {tier2}")
    tail = {"route": "cuda", "source": "fem_tpu_torch/csrc/filter_tail.cu",
            "replaces": "fem_tpu/ops/filter_tail_pallas.py:213", "library_ms": None}
    shapes = (("filter_tail_tier1", 2 * TIER1[0], *TIER1[1:], 3, 5),
              ("filter_tail_tier2", 2 * TIER2[0], *TIER2[1:], 1, 2))
    for name, NB, CAP, CC, plain_reps, plain_samples in shapes:
        sid, diag = _wide_slabs(rng, NB, STEP, CAP, dev)
        how = plan(CAP, CC)
        row = dict(tail, name=name)
        row.update(compare_and_time(
            "filter_tail", f"synthetic slabs at {CAP} + {CC}",
            lambda: filter_tail(sid, diag, CC, E, A),
            lambda: filter_tail_plain(sid, diag, CC, E, A), plain_reps, plain_samples,
            cuda_name=how.kernel))
        bnd, note = tail_bound(sid, diag, CC)
        row.update(bnd)
        rows.append(row)
        log(f"[kernels] {name} NB={NB} G={STEP} CAP={CAP} CC={CC} e={E} a={A}, "
            f"{how.kernel} with {how.threads} threads a lane, {how.words * 8:,} bytes of "
            f"scratch in {'shared memory' if how.in_shared_memory else 'a global workspace'}: "
            f"{note}")
        _log_times(f"[kernels] {name}", "synthetic", row, row)
    # Equality at 4096 + 4096 and far above tier 2, on a workspace.
    for NB, CAP, CC in ((128, 4096, 4096), (8, 12288, 4096)):
        sid, diag = _wide_slabs(rng, NB, STEP, CAP, dev)
        got = filter_tail(sid, diag, CC, E, A)
        want = filter_tail_plain(sid, diag, CC, E, A)
        torch.cuda.synchronize()
        d = max_abs_err(got, want)
        ms = cuda_ms(lambda: filter_tail(sid, diag, CC, E, A), 10)
        log(f"[kernels] filter_tail NB={NB} G={STEP} CAP={CAP} CC={CC} ({plan(CAP, CC).kernel}): "
            f"max_abs_err {d}, "
            f"{int((got[0] != 2**30).sum(dim=1).float().mean())} candidates a lane kept, "
            f"{ms:.4f} ms warm")
        check(d == 0, f"filter_tail differs from its plain version at {CAP} + {CC}")

    # Banded Myers at tier 2: 2 * 64 lanes, 262,144 slots, 300 in use.
    NB, V, n_used = 2 * TIER2[0], TIER2_VERIFY_SLOTS, 300
    args = _myers_inputs(ref, E, rng, dev, NB=NB, V=V)
    used = torch.tensor(n_used, device=dev)
    row = {"name": "banded_myers_tier2", "route": "cuda",
           "source": "fem_tpu_torch/csrc/banded_myers.cu",
           "replaces": "fem_tpu/ops/verify_pallas.py:122", "library_ms": None}
    row.update(compare_and_time(
        "banded_myers", "tier-2 slots",
        lambda: verify_candidates(dindex, *args, E, used=used),
        lambda: verify_candidates_plain(dindex, *args, E, used=used), 2, 3))
    bnd, note = myers_bound(*args, E, used)
    row.update(bnd)
    rows.append(row)
    log(f"[kernels] banded_myers_tier2: {note}")
    _log_times("[kernels] banded_myers_tier2", f"at e={E}", row, row)
    return rows


def _log_times(head: str, what: str, res: dict, bnd: dict) -> None:
    log(f"{head} {what}: {res['ms']:.4f} ms warm, {res['ms_cold']:.4f} ms cold, "
        f"{res['ms_single']:.4f} ms one launch at a time, {res['ms_profiler']:.4f} ms "
        f"by the profiler, plain {res['plain_ms']:.3f} ms, bound "
        f"{bnd['bound_ms'] * 1e3:.2f} us by {bnd['bound_by']}")


def phase_replay(rows: list[dict], captured: dict, suffix: str) -> None:
    """Each kernel on the inputs one main path gave it; `captured` maps a
    kernel-table row's name to the arguments of one wrapper call, and the
    row gains ms_<suffix> and the like."""
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain, plan
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    by_name = {r["name"]: r for r in rows}
    for key, (args, kw) in captured.items():
        if key.startswith("filter_tail"):
            sid, diag, cc, e, a = args
            wide = sid.shape[2] + cc
            slow = wide > 4096  # the plain version's loop is seconds long there
            res = compare_and_time(
                "filter_tail", f"the {suffix} of {key}",
                lambda: filter_tail(sid, diag, cc, e, a),
                lambda: filter_tail_plain(sid, diag, cc, e, a),
                1 if slow else 3, 2 if slow else 5,
                cuda_name=plan(sid.shape[2], cc).kernel)
            bnd, note = tail_bound(sid, diag, cc)
            what = (f"NB={sid.shape[0]} G={sid.shape[1]} CAP={sid.shape[2]} CC={cc} "
                    f"e={e} a={a}; {note}")
            if plan(sid.shape[2], cc).route == 1:
                _threads_sweep(f"[replay] {key} on the {suffix.replace('_', ' ')}",
                               sid, diag, cc, e, a)
        else:
            dindex, v_sid, v_pos, v_lane, both, lens, e = args
            used = kw["used"]
            res = compare_and_time(
                "banded_myers", f"the {suffix} of {key}",
                lambda: verify_candidates(dindex, v_sid, v_pos, v_lane, both, lens, e, used=used),
                lambda: verify_candidates_plain(dindex, v_sid, v_pos, v_lane, both, lens, e,
                                                used=used), 2, 3)
            bnd, note = myers_bound(v_sid, v_pos, v_lane, both, lens, e, used)
            what = f"V={v_sid.shape[0]} Lmax={both.shape[1]} e={e}; {note}"
        row = by_name[key]
        row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
        row.update({f"ms_{suffix}": res["ms"], f"ms_{suffix}_cold": res["ms_cold"],
                    f"ms_{suffix}_single": res["ms_single"],
                    f"ms_{suffix}_profiler": res["ms_profiler"],
                    f"plain_ms_{suffix}": res["plain_ms"],
                    f"bound_ms_{suffix}": bnd["bound_ms"], f"bound_by_{suffix}": bnd["bound_by"]})
        _log_times(f"[replay] {key}", f"on the {suffix.replace('_', ' ')} ({what})", res, bnd)


def _threads_sweep(head: str, sid, diag, cc: int, e: int, a: int) -> None:
    """The block-lane filter tail on these slabs at every block size the
    kernel has, each held against the plain version, timed by CUDA events
    (warm, back to back): the evidence for the plan's choice
    (ops/filter_tail.py:plan)."""
    from fem_tpu_torch.ops.filter_tail import _filter_tail_cuda, filter_tail_plain, plan

    want = filter_tail_plain(sid, diag, cc, e, a)
    ms = {}
    for T in (128, 256, 512, 1024):
        run = lambda: _filter_tail_cuda(sid, diag, cc, e, a, threads=T)
        got = run()
        torch.cuda.synchronize()
        check(max_abs_err(got, want) == 0, f"{head}: {T} threads a lane differ from plain")
        ms[T] = round(cuda_ms(run, 20), 4)
    log(f"{head} by threads a lane (the plan takes {plan(sid.shape[2], cc).threads}): "
        f"{ms} ms warm by CUDA events")


class Probe:
    """What a run of the engine did, read from outside it: how long the
    emit threads were busy, how long each submit took on its thread.
    `capture`, when set, maps a key to a test of a kernel wrapper call's
    arguments: the first call that passes is kept (tensors cloned), for
    the replay phase. (How often each kernel launched, and at which shape,
    is the wrappers' own count in fem_tpu_torch.kernels.)"""

    def __init__(self, engine):
        from fem_tpu_torch.ops import candidates as candidates_mod
        from fem_tpu_torch.pipeline import engine as engine_mod

        self._lock = threading.Lock()
        self.capture: dict = {}
        self.captured: dict = {}
        self.reset()
        self._undo = []
        self._wrap(candidates_mod, "filter_tail")
        self._wrap(candidates_mod, "occ_slab")
        self._wrap(candidates_mod, "occ_bound")
        self._wrap(engine_mod, "verify_candidates")
        self._time(engine, "_emit_native", lambda a, k, dt: self._emitted(dt))
        self._time(engine, "submit_batch", self._submitted)

    def reset(self) -> None:
        self.emit_s = 0.0
        self.emit_calls = 0
        self.submit_s = collections.defaultdict(list)

    def _emitted(self, dt) -> None:
        with self._lock:
            self.emit_s += dt
            self.emit_calls += 1

    def _submitted(self, args, kwargs, dt) -> None:
        tier = kwargs.get("tier", args[1] if len(args) > 1 else 0)
        with self._lock:
            self.submit_s[tier].append(dt)

    def _wrap(self, owner, attr) -> None:
        real = getattr(owner, attr)
        keep = lambda x: x.clone() if torch.is_tensor(x) else x

        def wrapped(*args, **kwargs):
            for key, test in self.capture.items():
                if key not in self.captured and test(attr, args):
                    self.captured[key] = ([keep(x) for x in args],
                                          {k: keep(v) for k, v in kwargs.items()})
            return real(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, real))

    def _time(self, owner, attr, note) -> None:
        real = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                note(args, kwargs, time.perf_counter() - t0)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: delattr(owner, attr))

    def close(self) -> None:
        for undo in self._undo:
            undo()


def run_engine(engine, probe: Probe, batches, mode: str) -> dict:
    """Map `batches` once: "stream" through the pipelined map_stream,
    "one_at_a_time" through map_batch in a loop. Returns the records'
    digest, the counters, times, what the engine's counters moved by, and
    the kernels' launch counts, which are set to 0 just before the run and
    read just after it."""
    from fem_tpu_torch import kernels
    from fem_tpu_torch.stats import MappingStats

    before = (engine.retried_reads, engine.tier_dispatches, engine.fallback_reads)
    probe.reset()
    kernels.reset_launches()
    torch.cuda.synchronize()
    recs, total, first_s = [], MappingStats(), None
    t0 = time.perf_counter()
    items = (engine.map_stream(batches) if mode == "stream"
             else (engine.map_batch(b) for b in batches))
    for r, st in items:
        first_s = time.perf_counter() - t0 if first_s is None else first_s
        recs.extend(r)
        total += st
    seconds = time.perf_counter() - t0
    launches, shapes = dict(kernels.launches), kernels.launches_by_shape()
    after = (engine.retried_reads, engine.tier_dispatches, engine.fallback_reads)
    retried, dispatches, fallback = (b - a for a, b in zip(before, after))
    return {"mode": mode, "digest": digest_lines(recs), "stats": total, "seconds": seconds,
            "first_s": first_s, "reads_per_s": total.num_reads / seconds,
            "emit_s": probe.emit_s, "emit_calls": probe.emit_calls,
            "retried": retried, "dispatches": dispatches, "fallback": fallback,
            "launches": launches, "tail_shapes": shapes["filter_tail"],
            "myers_shapes": shapes["banded_myers"], "occ_shapes": shapes["occ_slab"],
            "submit_s": {t: list(v) for t, v in probe.submit_s.items()}}


def _log_run(tag: str, what: str, run: dict) -> None:
    n = run["stats"].num_reads
    log(f"[main] {tag} {what}: {run['reads_per_s']:,.1f} reads/s ({n} reads in "
        f"{run['seconds']:.3f} s, first item after {run['first_s']:.3f} s) | submit_batch "
        f"{sum(map(sum, run['submit_s'].values())):.3f} s over "
        f"{sum(map(len, run['submit_s'].values()))} calls, emit threads busy "
        f"{run['emit_s']:.3f} s over {run['emit_calls']} calls | retried "
        f"{run['retried']} ({run['retried'] / n:.2%}), tier dispatches {run['dispatches']}, "
        f"host-mapped {run['fallback']} ({run['fallback'] / n:.2%})")


_BASELINE: dict = {}  # reads file -> fem_baseline's (digest, counters)


def baseline_check(tag: str, paths: dict, run: dict, e: int = E, a: int = A,
                   num_reads: int = NUM_READS) -> list[int]:
    """The oracle: fem_baseline (byte-identical to the reference binary) on
    the same reads; record multiset and counters must be equal. Returns
    the counters. fem_baseline counts in uint64_t; so do MappingStats'
    Python ints and the device's int64 sums."""
    from fem_tpu_torch.native.build import build_baseline

    t0 = time.perf_counter()
    if paths["fq"] not in _BASELINE:  # fem_baseline once a point
        sam = os.path.join(os.path.dirname(paths["fq"]), "baseline.sam")
        p = subprocess.run(
            [build_baseline(), "map", "-e", str(e), "-a", str(a), "-t", "1",
             "--ref", paths["fa"], "--index", paths["ix"], "--read1", paths["fq"],
             "-o", sam], check=True, capture_output=True, text=True)
        with open(sam, "rb") as f:
            _BASELINE[paths["fq"]] = (digest_lines([f.read()]), counters_from_stderr(p.stderr))
    (want_dig, want_cnt), want_counters = _BASELINE[paths["fq"]]
    got_dig, got_cnt = run["digest"]
    total = run["stats"]
    got_counters = [total.num_reads, total.num_mapped_reads,
                    total.num_candidates_without_additional_qgram_filter,
                    total.num_candidates, total.num_mappings]
    log(f"[main] {tag} fem_baseline check ({time.perf_counter() - t0:.1f} s): "
        f"records {got_cnt} vs {want_cnt}, digest equal {got_dig == want_dig}, "
        f"counters {got_counters} vs {want_counters}")
    check(got_cnt == want_cnt and got_dig == want_dig,
          f"{tag}: SAM record multiset differs from fem_baseline")
    check(got_counters == want_counters, f"{tag}: counters differ from fem_baseline")
    check(total.num_reads == num_reads, f"{tag}: not every read was mapped")
    return got_counters


def phase_main(tag: str, ref, index, paths, config, dev, turns: tuple,
               capture: dict, no_ladder_pass: bool = False) -> tuple[dict, dict]:
    """One operating point through the pipelined stream with the default
    ladder, then `turns` more runs of the same batches ("stream" or
    "one_at_a_time") for the steady rates, one profiled, and one in which
    the kernel inputs named by `capture` (row name -> test of a wrapper
    call) are kept; with `no_ladder_pass`, last the reads once more through
    an engine without a ladder. Returns the counted run and the captured
    inputs."""
    from fem_tpu_torch import kernels
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.pipeline.engine import MappingEngine, StageTimer

    args = FemArgs(kmer_size=KMER, step_size=STEP, error_threshold=E,
                   num_additional_qgrams=A)
    check(config.tiers is None, "the main path runs the default ladder")
    engine = MappingEngine(args, ref, index, config)  # the default device: the card
    check(engine.device.type == "cuda", "MappingEngine did not default to the card")
    check([(t.batch_size, t.cap_occ, t.cap_cand) for t in engine.tiers] == [TIER1, TIER2]
          and engine._caps(engine.tiers[1])[0] == TIER2_VERIFY_SLOTS,
          f"{tag}: the default ladder is not the one the kernel rows were timed at")
    batches = list(fastx.stream_fastq_batches(paths["fq"], batch_size=BATCH))
    t1, t2 = engine.tiers
    log(f"[main] {tag}: device index {engine.dindex.nbytes() / 2**30:.3f} GiB on {dev}; "
        f"pipeline depth {config.pipeline_depth}; tier 1 {t1.batch_size} reads at "
        f"{t1.cap_occ} + {t1.cap_cand}, tier 2 {t2.batch_size} reads at "
        f"{t2.cap_occ} + {t2.cap_cand}")
    probe = Probe(engine)
    sync_free_dispatch(tag, engine, batches[0])

    # The counted run, through the step graphs: counts to 0 just before,
    # read just after. Each key's first dispatch runs eagerly (its launches
    # are counted as they happen) and is then captured; every later
    # dispatch replays the graph and counts the launches the capture
    # recorded. So one launch of each kernel a dispatch, as before.
    torch.cuda.reset_peak_memory_stats(dev)
    run = run_engine(engine, probe, batches, "stream")
    peak = torch.cuda.max_memory_allocated(dev)
    _log_run(tag, "pipelined stream through the step graphs, first run (the graphs' "
             "captures and the cold start in it)", run)
    log(f"[main] {tag}: kernel launches {run['launches']}; filter_tail launches by "
        f"(cap_occ, cap_cand) {run['tail_shapes']}; banded_myers launches by (slots, "
        f"lanes) {run['myers_shapes']}; occ_slab launches by (cap_occ, lanes) "
        f"{run['occ_shapes']}; peak device memory {peak / 2**30:.3f} GiB")
    run["graphs"] = check_graphs(tag, engine, len(batches) + run["dispatches"])
    _log_submits(tag, "first run through the graphs (captures in it)", run)
    check(all(n > 0 for n in run["launches"].values()),
          f"{tag}: a kernel of the main path never launched")
    check(run["launches"]["filter_tail"] == run["launches"]["banded_myers"]
          == run["launches"]["occ_slab"] == len(batches) + run["dispatches"],
          f"{tag}: not one launch of each kernel a dispatch")
    baseline_check(tag, paths, run)

    # The same batches again, in turns. Every run must give the counted
    # run's records.
    for mode in turns:
        again = run_engine(engine, probe, batches, mode)
        check(again["digest"] == run["digest"], f"{tag}: a {mode} run gave other records")
        _log_run(tag, "steady, " + ("pipelined stream" if mode == "stream"
                                    else "one batch at a time"), again)
        run.setdefault("steady_" + mode, []).append(again["reads_per_s"])
        if mode == "stream":
            _log_submits(tag, "steady pipelined run through the graphs", again)
    _profiled_run(tag, engine, probe, batches, run["digest"])

    # The eager step (engine.eager_step, the counterpart of
    # jax.disable_jit()): the StageTimer's per-stage events lie inside the
    # step, so it times the eager path; its submit times and rate are the
    # graphs' baseline in this call.
    engine.eager_step = True
    engine.stage_timer = StageTimer(torch.device(dev))
    eager = run_engine(engine, probe, batches, "stream")
    timer, engine.stage_timer = engine.stage_timer, None
    engine.eager_step = False
    check(eager["digest"] == run["digest"] and eager["stats"] == run["stats"],
          f"{tag}: the eager step gave other records or counters")
    _log_run(tag, "steady, pipelined stream with the eager step (StageTimer on)", eager)
    _log_submits(tag, "eager step", eager)
    for tier, ms in timer.ms.items():
        log(f"[main] {tag}: device stage ms over {timer.batches[tier]} "
            f"{'tier-0' if tier == 0 else 'retry-tier'} batches (eager step): "
            f"{ {k: round(v, 3) for k, v in ms.items()} }")
    run["eager_reads_per_s"] = eager["reads_per_s"]

    # The kernels' inputs, for phase 6: the stream is mapped once more,
    # outside the timed and counted runs above, with the eager step (a
    # replay calls no wrapper, so none could be seen).
    probe.capture = capture
    engine.eager_step = True
    again = run_engine(engine, probe, batches, "stream")
    engine.eager_step = False
    check(again["digest"] == run["digest"],
          f"{tag}: the stream mapped again for capture gave other records")
    check(set(probe.captured) == set(capture),
          f"{tag}: captured inputs of {sorted(probe.captured)} only")
    probe.close()
    if no_ladder_pass:
        del engine
        _no_ladder_run(tag, args, ref, index, paths, config, run)
    return run, probe.captured


def sync_free_dispatch(tag: str, engine, batch) -> None:
    """One eager tier-0 dispatch with every host sync an error
    (torch.cuda.set_sync_debug_mode): a graph captures no host read. On a
    grid in one process the reductions between its segments are device
    work too, so the whole dispatch is held."""
    engine.eager_step = True
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine.submit_batch(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    engine.drain_batch(pending)  # its retries eager too: no graph before the counted run
    engine.eager_step = False
    log(f"[main] {tag}: one eager tier-0 dispatch under set_sync_debug_mode('error'): "
        f"no host sync in the step")


def check_graphs(tag: str, engine, dispatches: int) -> dict:
    """Every step program of the engine (StepPrograms on one device,
    GridPrograms on a grid) captured, each cell's every segment, and their
    dispatches in the run just made (each key's eager first one and the
    replays) adding up to `dispatches`: every dispatch after a key's first
    replayed its graphs. One line names the keys, each cell's capture
    time, graph memory and replays. Returns the programs' descriptions."""
    from fem_tpu_torch.pipeline.cli import programs_line

    progs = [p.describe() for _, p in sorted(engine.programs.items())]
    check(progs and all(c["segments"] > 0 for p in progs for c in p["cells"]),
          f"{tag}: a step program was not captured: {programs_line(progs)}")
    check(sum(1 + p["replays"] for p in progs) == dispatches,
          f"{tag}: {dispatches} dispatches, not all through the step programs: "
          f"{programs_line(progs)}")
    log(f"[main] {tag}: through the step graphs, keys (tier, Lmax) {programs_line(progs)}")
    return {str(tuple(p["key"])): p for p in progs}


def _log_submits(tag: str, what: str, run: dict) -> None:
    for tier, secs in sorted(run["submit_s"].items()):
        log(f"[main] {tag}: submit_batch at tier {tier} on its thread, {what}: first "
            f"{secs[0] * 1e3:.2f} ms, median {statistics.median(secs) * 1e3:.2f} ms "
            f"over {len(secs)}")


def _no_ladder_run(tag: str, args, ref, index, paths, config, counted: dict) -> None:
    """The same reads through an engine with tiers=(), so that every
    capacity overflow goes to the host mapper (_map_read_fallback) and its
    records are spliced in under the pipelined stream; the batches come
    from the FASTQ file through a ThreadedBatchSource, parsed on its thread
    while the stream maps. Records must be the counted run's."""
    import dataclasses

    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.pipeline.engine import MappingEngine
    from fem_tpu_torch.pipeline.prefetch import ThreadedBatchSource

    engine = MappingEngine(args, ref, index, dataclasses.replace(config, tiers=()))
    check(engine.tiers == (), "tiers=() left a ladder")
    probe = Probe(engine)
    source = ThreadedBatchSource(fastx.stream_fastq_batches(paths["fq"], batch_size=BATCH))
    run = run_engine(engine, probe, source, "stream")
    probe.close()
    _log_run(tag, "pipelined stream without a ladder, batches parsed on a "
             "ThreadedBatchSource's thread (parse time in the wall)", run)
    check(run["digest"] == counted["digest"] and run["stats"] == counted["stats"],
          f"{tag}: the run without a ladder gave other records or counters")
    check(run["fallback"] > 0 and run["retried"] == 0 and run["dispatches"] == 0,
          f"{tag}: without a ladder the overflow reads did not reach the host mapper")
    check(run["launches"]["filter_tail"] == run["launches"]["banded_myers"]
          == run["launches"]["occ_slab"] == NUM_READS // BATCH,
          f"{tag}: the run without a ladder launched otherwise")


def profiler_counts(tag: str, prof, launches: dict) -> tuple[list, dict]:
    """The kernels and copies a torch.profiler trace of the device holds,
    as (key, device us, count); each of the port's kernels must appear as
    often as the wrappers counted (`launches`, replays included)."""
    events = [(ev.key, getattr(ev, "device_time_total", None)
               or getattr(ev, "cuda_time_total", 0), ev.count) for ev in prof.key_averages()]
    ours = {k: c for k, _, c in events if any(kernel in k for kernel in launches)}
    for kernel, counted in launches.items():
        seen = sum(c for k, c in ours.items() if kernel in k)
        check(seen == counted, f"{tag}: the profiler saw {kernel} {seen} times, the "
              f"wrappers counted {counted} launches ({ours})")
    return events, ours


def _profiled_run(tag: str, engine, probe, batches, digest, split: bool = True) -> None:
    """One more pipelined run under torch.profiler: the device's busy and
    idle share of the wall, and the kernels that take most of its time.
    The run replays graphs, whose launches the wrappers count from what
    the captures recorded: the trace must show each kernel as often as
    they counted. Then, with `split`, one more run with the host's
    activity traced too: where a submit_batch's host time goes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = run_engine(engine, probe, batches, "stream")
        torch.cuda.synchronize()
    check(again["digest"] == digest, f"{tag}: the profiled run gave other records")
    events, ours = profiler_counts(tag, prof, again["launches"])
    wall_ms = again["seconds"] * 1e3
    busy_ms = sum(t for _, t, _ in events) / 1e3
    top = sorted(events, key=lambda x: -x[1])[:6]
    log(f"[main] {tag} profiled pipelined run through the graphs: wall {wall_ms:.1f} ms "
        f"({again['reads_per_s']:,.1f} reads/s under the profiler), device busy "
        f"{busy_ms:.1f} ms over {sum(c for _, _, c in events)} kernels and copies, idle "
        f"{1 - busy_ms / wall_ms:.1%} of the wall; the replays' kernels seen, each as "
        f"often as counted {again['launches']}: "
        + ", ".join(f"{k[:60]} x{c}" for k, c in ours.items()) + "; largest: "
        + "; ".join(f"{k[:48]} {t / 1e3:.2f} ms x{c}" for k, t, c in top))
    if split:
        _submit_split(tag, engine, probe, batches, digest)


def _submit_split(tag: str, engine, probe, batches, digest) -> None:
    """The pipelined run once more with host and device traced and each
    submit_batch marked: by tier, its mean host ms and the mean ms of its
    direct children in the trace (torch ops and CUDA runtime calls);
    `other` is the rest (Python, and waits for the interpreter lock)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    real = engine.submit_batch

    def marked(batch, tier=0, origins=None):
        with record_function(f"chip_smoke::submit_batch[{tier}]"):
            return real(batch, tier, origins)

    engine.submit_batch = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = run_engine(engine, probe, batches, "stream")
            torch.cuda.synchronize()
    finally:
        engine.submit_batch = real
    check(again["digest"] == digest, f"{tag}: the run with the host traced gave other records")
    split = {}
    for ev in prof.events():
        if ev.name.startswith("chip_smoke::submit_batch["):
            d = split.setdefault(int(ev.name[len("chip_smoke::submit_batch["):-1]),
                                 {"calls": 0, "total": 0.0, "children": collections.Counter()})
            d["calls"] += 1
            d["total"] += ev.cpu_time_total
            for child in ev.cpu_children:
                d["children"][child.name] += child.cpu_time_total
    check(0 in split, f"{tag}: the trace holds no tier-0 submit_batch")
    for tier, d in sorted(split.items()):
        n = d["calls"]
        kids = {k: v / n / 1e3 for k, v in d["children"].most_common(6)}
        kids["other"] = (d["total"] - sum(d["children"].values())) / n / 1e3
        log(f"[main] {tag}: submit_batch at tier {tier} under the profiler (host traced), "
            f"{n} calls, mean {d['total'] / n / 1e3:.3f} ms: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in kids.items()))


# Phase 7's tuning flags: the benign point's EngineConfig on the command line.
CLI_TUNE = ["--batch-size", str(BATCH), "--cap-occ", "80", "--cap-cand", "16",
            "--verify-per-read", "2", "--accept-per-read", "0.85"]
COUNTER_KEYS = ("num_reads", "num_mapped_reads", "num_candidates_without_additional_qgram_filter",
                "num_candidates", "num_mappings")
# Phase 8: the bench at a reduced read count (bench.py's defaults are
# 327,680 benign and 163,840 adversarial reads).
BENCH_ENV = {"FEM_BENCH_READS": "131072", "FEM_BENCH_ADV_READS": "65536"}
REPO = os.path.dirname(os.path.abspath(__file__))


def _child_env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


def _run_cli(argv: list[str]) -> tuple[int, str, float]:
    """fem_tpu_torch.pipeline.cli.main(argv) in this process: its exit
    code, its stderr and its wall in seconds."""
    import contextlib
    import io

    from fem_tpu_torch.pipeline import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def _sam_digest(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        return digest_lines([f.read()])


def _time_line(err: str) -> str:
    m = re.search(r"^Time: ([0-9.]+)s$", err, re.M)
    return f"{float(m.group(1)):.2f} s" if m else "not printed"


def phase_cli(workdir: str, paths: dict) -> dict:
    """The command line on the benign point's files, as a user runs it:
    `index` (byte-equal to phase 3's index), `map` in this process (kernel
    launches by shape, records and counters == fem_baseline, the stats
    JSON), `map --checkpoint` with a simulated crash and a resume (byte-equal
    to the full checkpointed run; every checkpoint's offset on disk), and
    `python -m fem_tpu_torch map -t 1` and `-t 2` as processes of their own,
    in turns, each equal to the in-process run. Returns the kernels'
    launches by shape in the in-process run."""
    from fem_tpu_torch import kernels
    from fem_tpu_torch.pipeline import cli
    from fem_tpu_torch.stats import MappingStats

    d = os.path.join(workdir, "cli")
    os.makedirs(d)
    ix = os.path.join(d, "ref.index")
    rc, err, wall = _run_cli(["index", str(KMER), str(STEP), paths["fa"], ix])
    check(rc == 0, f"cli index failed: {err[-2000:]}")
    with open(ix, "rb") as a, open(paths["ix"], "rb") as b:
        check(a.read() == b.read(), "the CLI's index differs from phase 3's")
    log(f"[cli] index 12 3: {wall:.1f} s, byte-equal to phase 3's ({os.path.getsize(ix)} bytes)")
    base = ["map", "-e", str(E), "-a", str(A), "--ref", paths["fa"], "--index", ix,
            "--read1", paths["fq"], *CLI_TUNE]

    # map in this process: the counts set to 0 just before, read just after.
    sam, js = os.path.join(d, "t1.sam"), os.path.join(d, "t1.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rc, err, wall = _run_cli(base + ["-o", sam, "--stats-json", js])
    shapes = kernels.launches_by_shape()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"cli map failed: {err[-2000:]}")
    counters = counters_from_stderr(err)
    with open(js) as f:
        stats = json.load(f)
    log(f"[cli] map -t 1 in this process: {wall:.2f} s wall (reference and index load "
        f"included) = {NUM_READS / wall:,.1f} reads/s; its Time line (engine set-up and "
        f"mapping) {_time_line(err)}; stats JSON {stats['reads_per_s']:,.1f} reads/s, "
        f"retried {stats['retried_reads']}, host-mapped {stats['fallback_reads']}; peak "
        f"device memory {peak / 2**30:.3f} GiB; filter_tail launches by (cap_occ, cap_cand) "
        f"{shapes['filter_tail']}, banded_myers by (slots, lanes) {shapes['banded_myers']}, "
        f"occ_slab by (cap_occ, lanes) {shapes['occ_slab']}")
    check(shapes["filter_tail"].get((80, 16), 0) > 0
          and shapes["banded_myers"].get((4 * BATCH, 2 * BATCH), 0) > 0
          and shapes["occ_slab"].get((80, 2 * BATCH), 0) > 0,
          "cli map: a kernel was launched no time at the tier-0 shapes")
    check(stats["mapping_stats"] == dict(zip(COUNTER_KEYS, counters))
          and stats["reads"] == NUM_READS, "cli map: the stats JSON disagrees with stderr")
    full = {"digest": _sam_digest(sam), "stats": MappingStats(*counters)}
    baseline_check("cli", paths, full)

    # --checkpoint, then a crash after the first checkpoint and a resume.
    ck, ck_sam, crash_sam = (os.path.join(d, f) for f in ("progress", "ck.sam", "crash.sam"))
    seen = []
    real = cli._write_checkpoint

    def checked(path, hist):
        seen.append((hist[-1][1], os.path.getsize(ck_sam)))
        real(path, hist)

    cli._write_checkpoint = checked
    try:
        rc, err, wall = _run_cli(base + ["-o", ck_sam, "--checkpoint", ck])
    finally:
        cli._write_checkpoint = real
    check(rc == 0, f"cli map --checkpoint failed: {err[-2000:]}")
    with open(ck) as f:
        hist = [tuple(map(int, line.split())) for line in f if line.strip()]
    with open(ck_sam, "rb") as f:
        ck_bytes = f.read()
    check([h[0] for h in hist] == [BATCH * (i + 1) for i in range(NUM_READS // BATCH)]
          and hist[-1][1] == len(ck_bytes), f"cli map --checkpoint: history {hist}")
    check(all(off == size for off, size in seen) and len(seen) == len(hist),
          f"a checkpoint's offset was not on disk: {seen}")
    check(digest_lines([ck_bytes]) == full["digest"]
          and counters_from_stderr(err) == counters,
          "cli map --checkpoint (ordered stream) gave other records or counters")
    with open(ck, "w") as f:
        f.write(f"{hist[0][0]} {hist[0][1]}\n")
    with open(crash_sam, "wb") as f:
        f.write(ck_bytes[:hist[0][1]] + b"read999\tGARBAGE-PARTIAL-RECORD")
    rc, err2, wall2 = _run_cli(base + ["-o", crash_sam, "--checkpoint", ck])
    check(rc == 0 and f"Resuming after {hist[0][0]} reads." in err2,
          f"cli map resume failed: {err2[-2000:]}")
    with open(crash_sam, "rb") as f:
        check(f.read() == ck_bytes, "the resumed run is not byte-equal to the full run")
    log(f"[cli] map --checkpoint: {wall:.2f} s, {len(hist)} checkpoints, each offset on "
        f"disk when written; crash after {hist[0][0]} reads with a garbage tail, resume "
        f"{wall2:.2f} s: byte-equal to the full run ({len(ck_bytes)} bytes)")

    # -t 1 and -t 2 as processes of their own, in turns.
    torch.cuda.empty_cache()
    for t in (1, 2, 2, 1):
        out = os.path.join(d, f"p{t}.sam")
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "fem_tpu_torch", *base, "-t", str(t),
                            "-o", out], env=_child_env(), capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"python -m fem_tpu_torch map -t {t} failed: {p.stderr[-3000:]}")
        check(_sam_digest(out) == full["digest"] and counters_from_stderr(p.stderr) == counters,
              f"map -t {t}: records or counters differ from the in-process run")
        os.remove(out)
        log(f"[cli] python -m fem_tpu_torch map -t {t}: {wall:.2f} s wall (process start, "
            f"torch import, index load included) = {NUM_READS / wall:,.1f} reads/s; Time "
            f"line {_time_line(p.stderr) if t == 1 else 'not printed by the parent'}; "
            f"records and counters equal to -t 1 in this process")
    return shapes


def phase_bench() -> None:
    """python -m fem_tpu_torch.bench as a process of its own at a reduced
    read count: both JSON lines must be record-equal to fem_baseline for
    every swept worker count, with kernel launches in its workers."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "fem_tpu_torch.bench"],
                       env=_child_env(**BENCH_ENV), capture_output=True, text=True, timeout=900)
    for line in p.stderr.splitlines():
        if line.startswith("[bench]"):
            log(line)
    check(p.returncode == 0, f"the bench failed (rc {p.returncode}): {p.stderr[-3000:]}")
    lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    check(len(lines) == 2, f"the bench printed {len(lines)} JSON lines, not 2")
    for line in lines:
        log(f"[bench] line: {json.dumps(line)}")
        check(line["records_equal"] is True
              and line["records_equal_by_workers"] == {"2": True, "1": True},
              f"bench: a worker count is not equal to fem_baseline: {line}")
        check(all_launched(line["kernel_launches"]),
              f"bench: a kernel was launched no time in its workers: {line}")
    log(f"[bench] {BENCH_ENV}: {time.perf_counter() - t0:.1f} s")


def _grid_run(tag: str, engine, batches, paths: dict, capture: dict | None = None,
              turns: bool = False) -> dict:
    """One grid engine through its GridPrograms (a graph a cell segment):
    the first tier-0 dispatch eagerly with every host sync an error; the
    counted run (== fem_baseline, both kernels launched, one launch of each
    kernel a cell a dispatch, every dispatch after a key's first a replay);
    a run under torch.profiler, which must see each kernel as often as the
    wrappers counted; a run with the eager step, which must give the same
    records; with `turns`, steady runs with the eager step and through the
    graphs in turns (eager, graphs, graphs, eager); with `capture`, one more
    eager run that keeps those kernel inputs (run["captured"]: a replay
    calls no wrapper)."""
    probe = Probe(engine)
    cells = len(engine.grid.local_cells())
    sync_free_dispatch(tag, engine, batches[0])
    run = run_engine(engine, probe, batches, "stream")
    _log_run(tag, "pipelined stream through the grid's graphs, counted run (the captures "
             "in it)", run)
    log(f"[parallel] {tag}: kernel launches {run['launches']}; filter_tail by (cap_occ, "
        f"cap_cand) {run['tail_shapes']}; banded_myers by (slots, lanes) {run['myers_shapes']}; "
        f"occ_slab by (cap_occ, lanes) {run['occ_shapes']}")
    check(all(n > 0 for n in run["launches"].values()), f"{tag}: a kernel was never launched")
    dispatches = len(batches) + run["dispatches"]
    # A cell of an index grid writes its slab in two launches, around the
    # reduction of its bound over the index axis.
    slabs = 2 if engine.config.index_mesh is not None else 1
    check(run["launches"]["filter_tail"] == run["launches"]["banded_myers"]
          == run["launches"]["occ_slab"] // slabs == cells * dispatches,
          f"{tag}: not one launch of each kernel a cell a dispatch ({cells} cells, "
          f"{dispatches} dispatches, {slabs} occ_slab launches a step): {run['launches']}")
    run["graphs"] = check_graphs(tag, engine, dispatches)
    baseline_check(tag, paths, run)
    _profiled_run(tag, engine, probe, batches, run["digest"], split=False)
    engine.eager_step = True
    eager = run_engine(engine, probe, batches, "stream")
    engine.eager_step = False
    check(eager["digest"] == run["digest"] and eager["stats"] == run["stats"],
          f"{tag}: the eager step gave other records or counters")
    _log_run(tag, "pipelined stream with the eager step", eager)
    if turns:
        for mode in ("eager", "graphs", "graphs", "eager"):
            engine.eager_step = mode == "eager"
            again = run_engine(engine, probe, batches, "stream")
            check(again["digest"] == run["digest"], f"{tag}: a steady {mode} run gave other records")
            run.setdefault(f"steady_{mode}", []).append(again["reads_per_s"])
        engine.eager_step = False
        log(f"[parallel] {tag} steady pipelined reads/s in turns (eager, graphs, graphs, "
            f"eager) on {_smi('name,power.limit')}: through the graphs "
            f"{', '.join(f'{x:,.1f}' for x in run['steady_graphs'])}; eager step "
            f"{', '.join(f'{x:,.1f}' for x in run['steady_eager'])}")
    if capture:
        probe.capture = capture
        engine.eager_step = True
        again = run_engine(engine, probe, batches, "stream")
        engine.eager_step = False
        check(again["digest"] == run["digest"] and set(probe.captured) == set(capture),
              f"{tag}: the capture run gave other records or missed {sorted(capture)}")
        run["captured"] = dict(probe.captured)
    probe.close()
    return run


def _engine_programs(tag: str, path: str) -> None:
    """A `map --engine-json` file's step programs: every one captured, and
    every dispatch after a key's first a replay."""
    from fem_tpu_torch.pipeline.cli import eager_dispatches, programs_line

    with open(path) as f:
        progs = json.load(f)["programs"]
    line = programs_line(progs)
    log(f"[parallel] {tag}: through the step graphs, keys (tier, Lmax) {line}")
    check(progs and all(c["segments"] > 0 for p in progs for c in p["cells"])
          and eager_dispatches(progs) == 0,
          f"{tag}: a dispatch after its key's first replayed no graph: {line}")


def _two_processes(tag: str, base: list, out: str, extra: list) -> tuple[tuple, list, float]:
    """`python -m fem_tpu_torch map` as ranks 0 and 1 of one process group
    on cuda:0: the merged shards' digest, rank 0's counters, the wall."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fem_tpu_torch", *base, "-o", out, "--num-hosts", "2",
         "--host-id", str(h), "--coordinator", f"127.0.0.1:{port}", *extra],
        env=_child_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for h in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=600)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for h, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"{tag}: rank {h} failed (rc {p.returncode}): {err[-3000:]}")
        dist_line = [x for x in err.splitlines() if x.startswith("[dist]")]
        check(len(dist_line) == 1 and "backend gloo" in dist_line[0],
              f"{tag}: rank {h} did not choose gloo on a shared card: {dist_line}")
        log(f"[parallel] {tag} rank {h}: {dist_line[0]}")
        for line in err.splitlines():
            if line.startswith("[mesh]"):
                log(f"[parallel] {tag} rank {h}: {line}")
    chunks = []
    for h in range(2):
        with open(f"{out}.host{h:04d}", "rb") as f:
            chunks.append(f.read())
        log(f"[parallel] {tag} rank {h} wrote {digest_lines(chunks[-1:])[1]} records")
    return digest_lines(chunks), counters_from_stderr(errs[0]), wall


def phase_parallel(workdir: str, benign_paths: dict, adv_paths: dict,
                   adv_fallback_one_device: int, dev: str) -> tuple[list, dict]:
    """Phase 9 (see the module docstring): every grid names `dev` only.
    Returns the per-shard kernel rows and the counted grid runs by tag."""
    from fem_tpu_torch import kernels
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.storage import load_index
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.parallel.mesh import make_index_mesh, make_mesh
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
    from fem_tpu_torch.stats import MappingStats

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards > 1:
        log(f"[parallel] {cards} cards on this machine: the grids below still name {dev} "
            f"only, so every cell shares it")
    else:
        log(f"[parallel] one card: every cell of every grid below shares {dev}")
    args = FemArgs(kmer_size=KMER, step_size=STEP, error_threshold=E, num_additional_qgrams=A)
    benign_cfg = dict(batch_size=BATCH, cap_occ=80, cap_cand=16, verify_per_read=2,
                      accept_per_read=0.85)
    ref = fastx.read_fasta(benign_paths["fa"])
    index = load_index(benign_paths["ix"])
    batches = list(fastx.stream_fastq_batches(benign_paths["fq"], batch_size=BATCH))
    runs = {}
    shard_capture = {
        "filter_tail_shard": lambda attr, a: attr == "filter_tail"
        and (a[0].shape[2], a[2]) == (80, 16),
        # A shard whose reference slice starts mid-chromosome: its offsets
        # (pos - lo) are negative.
        "banded_myers_shard": lambda attr, a: attr == "verify_candidates"
        and a[0].own_start is not None and (a[1].shape[0], a[4].shape[0]) == (BATCH, 2 * BATCH)
        and int(a[0].ref_offsets.min()) < 0,
        # A cell's two occurrence-slab launches: its own bound, then the
        # slab at the bound reduced over the index axis.
        "occ_bound_shard": lambda attr, a: attr == "occ_bound"
        and (a[5], a[0].shape[0]) == (80, 2 * BATCH),
        "occ_slab_shard": lambda attr, a: attr == "occ_slab"
        and (a[5], a[0].shape[0]) == (80, 2 * BATCH),
    }
    for tag, key, grid in (("grid_dp2", "mesh", make_mesh([dev] * 2)),
                           ("grid_1x4", "index_mesh", make_index_mesh([dev] * 4, 4)),
                           ("grid_2x2", "index_mesh", make_index_mesh([dev] * 4, 2))):
        t0 = time.perf_counter()
        engine = MappingEngine(args, ref, index, EngineConfig(**benign_cfg, **{key: grid}))
        check([(t.batch_size, t.cap_occ, t.cap_cand) for t in engine.tiers] == [TIER1, TIER2],
              f"{tag}: the default ladder differs from the single device's")
        log(f"[parallel] {tag}: {key} {dict(grid.shape)}, engine set-up (shards built and "
            f"placed) {time.perf_counter() - t0:.2f} s, device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        runs[tag] = _grid_run(tag, engine, batches, benign_paths,
                              shard_capture if tag == "grid_1x4" else None,
                              turns=tag in ("grid_dp2", "grid_1x4"))
        del engine
        torch.cuda.empty_cache()

    # Kernel rows at the per-shard shapes, on synthetic inputs.
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain
    from fem_tpu_torch.ops.types import device_index_from_host
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    rng = np.random.default_rng(2026)
    rows = []
    tail = {"route": "cuda", "source": "fem_tpu_torch/csrc/filter_tail.cu",
            "replaces": "fem_tpu/ops/filter_tail_pallas.py:213", "library_ms": None}
    for name, NB in (("filter_tail_shard", 2 * BATCH), ("filter_tail_shard_dp2", BATCH)):
        sid, diag = _clustered_slabs(rng, NB, STEP, 80, dev)
        row = dict(tail, name=name)
        row.update(compare_and_time(
            "filter_tail", f"synthetic slabs over {NB} lanes",
            lambda: filter_tail(sid, diag, 16, E, A),
            lambda: filter_tail_plain(sid, diag, 16, E, A), 3))
        bnd, note = tail_bound(sid, diag, 16)
        row.update(bnd)
        rows.append(row)
        log(f"[parallel] {name} NB={NB} G={STEP} CAP=80 CC=16 e={E} a={A}: {note}")
        _log_times(f"[parallel] {name}", "synthetic", row, row)
    dindex = device_index_from_host(index, ref, dev)
    args_v = _myers_inputs(ref, E, rng, dev, NB=2 * BATCH, V=BATCH)
    row = {"name": "banded_myers_shard", "route": "cuda",
           "source": "fem_tpu_torch/csrc/banded_myers.cu",
           "replaces": "fem_tpu/ops/verify_pallas.py:122", "library_ms": None}
    row.update(compare_and_time(
        "banded_myers", "synthetic slots at a (1, 4) cell's shape",
        lambda: verify_candidates(dindex, *args_v, E),
        lambda: verify_candidates_plain(dindex, *args_v, E), 5))
    bnd, note = myers_bound(*args_v, E, None)
    row.update(bnd)
    rows.append(row)
    log(f"[parallel] banded_myers_shard V={BATCH} lanes={2 * BATCH}: {note}")
    _log_times("[parallel] banded_myers_shard", f"at e={E}", row, row)
    captured = runs["grid_1x4"].pop("captured")
    offs = captured["banded_myers_shard"][0][0].ref_offsets
    log(f"[parallel] replayed Myers shard: reference slice of {offs.shape[0]} chromosome(s), "
        f"offsets {offs.tolist()}")
    rows += occ_rows("grid_1x4", captured, "[parallel]")
    phase_replay(rows, captured, "shard_inputs")
    del dindex, args_v, captured, ref, index, batches
    torch.cuda.empty_cache()

    # The adversarial point on (1, 2): its retries through the sharded ladder.
    ref = fastx.read_fasta(adv_paths["fa"])
    index = load_index(adv_paths["ix"])
    batches = list(fastx.stream_fastq_batches(adv_paths["fq"], batch_size=BATCH))
    engine = MappingEngine(args, ref, index, EngineConfig(
        batch_size=BATCH, cap_occ=80, cap_cand=64, verify_per_read=8, accept_per_read=8,
        index_mesh=make_index_mesh([dev] * 2, 2)))
    run = _grid_run("adversarial_1x2", engine, batches, adv_paths)
    log(f"[parallel] adversarial_1x2: retried_reads {run['retried']}, tier_dispatches "
        f"{run['dispatches']}, host-mapped {run['fallback']} against {adv_fallback_one_device} "
        f"on one device: {run['fallback'] - adv_fallback_one_device} reads host-mapped for "
        f"halo risk; launches by shape {run['tail_shapes']} {run['myers_shapes']}")
    check(run["retried"] > 0 and run["dispatches"] > 0,
          "adversarial_1x2: no read went through the sharded ladder")
    runs["adversarial_1x2"] = run
    del engine, ref, index, batches
    torch.cuda.empty_cache()

    # The command line: in this process with --index-shards 2, then two
    # processes on cuda:0, independent and as one grid.
    d = os.path.join(workdir, "parallel")
    os.makedirs(d)
    base = ["map", "-e", str(E), "-a", str(A), "--ref", benign_paths["fa"], "--index",
            benign_paths["ix"], "--read1", benign_paths["fq"], *CLI_TUNE]
    sam = os.path.join(d, "shards2.sam")
    ej = os.path.join(d, "shards2.json")
    kernels.reset_launches()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc, err, wall = _run_cli(base + ["--index-shards", "2", "-o", sam, "--engine-json", ej])
        torch.cuda.synchronize()
    launched = dict(kernels.launches)
    check(rc == 0, f"cli --index-shards 2 failed: {err[-2000:]}")
    profiler_counts("cli_index_shards_2", prof, launched)
    _engine_programs("cli map --index-shards 2", ej)
    mesh_line = [x for x in err.splitlines() if x.startswith("[mesh]")]
    log(f"[parallel] cli map --index-shards 2 in this process, under torch.profiler: "
        f"{wall:.2f} s wall = {NUM_READS / wall:,.1f} reads/s (reference and index load, "
        f"shard build included); {mesh_line}; kernel launches {launched}, each seen as often "
        f"by the profiler")
    check(all(n > 0 for n in launched.values()), "cli --index-shards 2: a kernel never launched")
    baseline_check("cli_index_shards_2", benign_paths,
                   {"digest": _sam_digest(sam), "stats": MappingStats(*counters_from_stderr(err))})
    for tag, extra in (("two_processes_independent", []),
                       ("two_processes_global_mesh", ["--index-shards", "2", "--local-devices", "2"])):
        ej = os.path.join(d, f"{tag}.json")
        digest, counters, wall = _two_processes(tag, base, os.path.join(d, f"{tag}.sam"),
                                                extra + ["--engine-json", ej])
        for h in range(2):
            _engine_programs(f"{tag} rank {h}", f"{ej}.host{h:04d}")
        log(f"[parallel] {tag}: {wall:.2f} s wall for both (process start, torch import, index "
            f"load included) = {NUM_READS / wall:,.1f} reads/s")
        baseline_check(tag, benign_paths, {"digest": digest, "stats": MappingStats(*counters)})
    log(f"[parallel] phase 9: {time.perf_counter() - t_phase:.1f} s")
    return rows, runs


# Phase 10: the parameter sweep of tests/test_config_matrix.py:31-40 and the
# soak's e=7 150 bp line (docs/SOAK.md): name, k, step, e, a, read length,
# and the most errors a simulated read carries (the sweep's min(e, 3); e=7
# at 150 bp carries up to 7, as the soak's reads do).
SWEEP = (("e7_a2", 12, 3, 7, 2, 100, 3), ("e0", 12, 3, 0, 1, 100, 0),
         ("e5_a0", 12, 3, 5, 0, 100, 3), ("k10_step5", 10, 5, 3, 1, 100, 3),
         ("len148", 12, 3, 2, 1, 148, 2), ("len76_step2", 12, 2, 4, 1, 76, 3),
         ("e7_len150", 12, 3, 7, 2, 150, 7))
SWEEP_READS = 20_000  # one full tier-0 batch and one padded one of 3,616
# The wrapper calls phase 10 holds against their plain versions, by a test
# of (wrapper, arguments): tier 0 and tier 1 of the default ladder.
SWEEP_CALLS = {
    "filter_tail_tier0": lambda attr, a: attr == "filter_tail" and (a[0].shape[2], a[2]) == (80, 16),
    "banded_myers_tier0": lambda attr, a: (attr == "verify_candidates" and (
        a[1].shape[0], a[4].shape[0]) == (4 * BATCH, 2 * BATCH)),
    "filter_tail_tier1": lambda attr, a: attr == "filter_tail" and (a[0].shape[2], a[2]) == TIER1[1:],
    "banded_myers_tier1": lambda attr, a: (attr == "verify_candidates" and (
        a[1].shape[0], a[4].shape[0]) == (2 * TIER1[0] * 32, 2 * TIER1[0])),
}
# Which of them are rows of the kernel table, timed: (configuration, call).
SWEEP_ROWS = {("e7_len150", "filter_tail_tier0"): "filter_tail_e7_a2",
              ("e7_len150", "banded_myers_tier0"): "banded_myers_lmax160",
              ("len76_step2", "banded_myers_tier0"): "banded_myers_lmax96"}


def _hold_call(name: str, key: str, args: list, kw: dict, row: str | None,
               head: str = "[configs]") -> dict | None:
    """One wrapper call captured from configuration `name`'s run, against its
    plain version on the same inputs (exact). With `row`, also timed and
    bounded as a kernel-table row, which is returned."""
    from fem_tpu_torch.ops.filter_tail import filter_tail, filter_tail_plain, plan
    from fem_tpu_torch.ops.occ_slab import occ_bound, occ_slab, occ_slab_plain
    from fem_tpu_torch.ops.verify import verify_candidates, verify_candidates_plain

    if key.startswith("occ_"):  # occ_slab (own or given bound) or occ_bound
        off_s, lfreq_s, start_s, lane_ok, occ, cap = args
        tkey = kw.get("tkey")
        mode = "bound" if key.startswith("occ_bound") else ("own" if tkey is None else "given")
        if mode == "bound":
            kernel = lambda: occ_parts(occ_bound(*args))
            plain = lambda: occ_parts(occ_slab_plain(*args))[2:]
        else:
            kernel = lambda: occ_parts(occ_slab(*args, tkey=tkey))
            plain = lambda: occ_parts(occ_slab_plain(*args, tkey=tkey))
        bnd, note = occ_bound_of(off_s, lfreq_s, start_s, lane_ok, cap, mode)
        what = (f"NB={off_s.shape[0]} G={off_s.shape[1]} S={off_s.shape[2]} CAP={cap}, "
                + {"own": "own bound", "bound": "the bound alone", "given": "given bound"}[mode])
        base = {"source": "fem_tpu_torch/csrc/occ_slab.cu",
                "replaces": "no Pallas kernel: XLA ops of fem_tpu/ops/candidates.py"}
        timing = dict(kernel="occ_slab", plain_reps=3, plain_samples=5)
    elif key.startswith("filter_tail"):
        sid, diag, cc, e, a = args
        kernel = lambda: filter_tail(sid, diag, cc, e, a)
        plain = lambda: filter_tail_plain(sid, diag, cc, e, a)
        bnd, note = tail_bound(sid, diag, cc)
        what = f"NB={sid.shape[0]} G={sid.shape[1]} CAP={sid.shape[2]} CC={cc} e={e} a={a}"
        base = {"source": "fem_tpu_torch/csrc/filter_tail.cu",
                "replaces": "fem_tpu/ops/filter_tail_pallas.py:213"}
        slow = sid.shape[2] + cc >= 4096  # the plain version's loop is seconds long there
        timing = dict(kernel="filter_tail", plain_reps=1 if slow else 3,
                      plain_samples=2 if slow else 5, cuda_name=plan(sid.shape[2], cc).kernel)
    else:
        dindex, v_sid, v_pos, v_lane, both, lens, e = args
        used = kw["used"]
        kernel = lambda: verify_candidates(dindex, v_sid, v_pos, v_lane, both, lens, e, used=used)
        plain = lambda: verify_candidates_plain(dindex, v_sid, v_pos, v_lane, both, lens, e,
                                                used=used)
        bnd, note = myers_bound(v_sid, v_pos, v_lane, both, lens, e, used)
        what = f"V={v_sid.shape[0]} Lmax={both.shape[1]} e={e}"
        base = {"source": "fem_tpu_torch/csrc/banded_myers.cu",
                "replaces": "fem_tpu/ops/verify_pallas.py:122"}
        timing = dict(kernel="banded_myers", plain_reps=2, plain_samples=3)
    if row is None:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        d = max_abs_err(got, want)
        log(f"{head} {name} {key} ({what}; {note}): max_abs_err {d}")
        check(d == 0, f"{name}: {key} differs from its plain version")
        return None
    res = {"name": row, "route": "cuda", **base, "library_ms": None}
    res.update(compare_and_time(timing.pop("kernel"), f"the {name} inputs of {key}",
                                kernel, plain, **timing))
    res.update(bnd)
    _log_times(f"{head} {row}", f"on the {name} inputs ({what}; {note}), max_abs_err "
               f"{res['max_abs_err']}", res, bnd)
    return res


def occ_rows(tag: str, captured: dict, head: str) -> list[dict]:
    """The occurrence-slab calls in `captured` (keys starting "occ_"; taken
    out of it), each held against its plain version on the inputs the main
    path gave it: those named in ROW_LAUNCHES timed as kernel-table rows,
    which are returned; the others held for equality alone."""
    out = []
    for key in sorted(k for k in captured if k.startswith("occ_")):
        args, kw = captured.pop(key)
        row = _hold_call(tag, key, args, kw, key if key in ROW_LAUNCHES else None, head=head)
        if row is not None:
            out.append(row)
    return out


def phase_configs(workdir: str, seqs, benign_paths: dict) -> tuple[dict, list]:
    """Phase 10: each configuration of SWEEP on the benign point's 46 Mb
    genome, 20,000 reads through the pipelined stream with the default
    ladder and the benign point's caps, through the step graphs; records
    and the five counters == fem_baseline. FEM's step bound, step <=
    L/(e+2) - k + 1, holds for none of the reads of e7_a2 and len76_step2:
    no read maps there, and their pre-filter counter passes 2^32. Then the
    same reads once more with the eager step, whose kernel wrapper calls
    at tiers 0 and 1 are held against their plain versions (SWEEP_CALLS;
    SWEEP_ROWS also timed, as rows of the kernel table). Returns each
    configuration's counted run and the rows."""
    from fem_tpu_torch import sim
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.index.storage import load_index, save_index
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine

    t_phase = time.perf_counter()
    ref = fastx.read_fasta(benign_paths["fa"])
    indexes = {(KMER, STEP): (load_index(benign_paths["ix"]), benign_paths["ix"])}
    out, rows = {}, []
    for name, k, step, e, a, length, max_errors in SWEEP:
        t0 = time.perf_counter()
        d = os.path.join(workdir, "configs", name)
        os.makedirs(d)
        if (k, step) not in indexes:
            ix = os.path.join(d, "ref.index")
            index = build_index(ref, k, step)
            save_index(index, ix)
            indexes[k, step] = (index, ix)
        index, ix = indexes[k, step]
        paths = {"fa": benign_paths["fa"], "ix": ix, "fq": os.path.join(d, "reads.fq")}
        sim.write_fastq(paths["fq"], sim.simulate_reads(
            seqs, SWEEP_READS, read_length=length, max_errors=max_errors, seed=24))
        batches = list(fastx.stream_fastq_batches(paths["fq"], batch_size=BATCH))
        engine = MappingEngine(
            FemArgs(kmer_size=k, step_size=step, error_threshold=e, num_additional_qgrams=a),
            ref, index, EngineConfig(batch_size=BATCH, cap_occ=80, cap_cand=16,
                                     verify_per_read=2, accept_per_read=0.85))
        probe = Probe(engine)
        setup_s = time.perf_counter() - t0
        run = run_engine(engine, probe, batches, "stream")
        tag = f"configs {name}"
        _log_run(tag, f"k={k} step={step} e={e} a={a}, {length} bp reads (Lmax "
                 f"{sorted({b.codes.shape[1] for b in batches})}), batches of "
                 f"{[b.num_reads for b in batches]} padded to {BATCH}", run)
        graphs = check_graphs(tag, engine, len(batches) + run["dispatches"])
        check(run["launches"]["filter_tail"] == run["launches"]["banded_myers"]
              == run["launches"]["occ_slab"] == len(batches) + run["dispatches"],
              f"{tag}: not one launch of each kernel a dispatch: {run['launches']}")
        counters = baseline_check(tag, paths, run, e=e, a=a, num_reads=SWEEP_READS)
        in_bound = step <= length // (e + 2) - k + 1
        tiers = collections.Counter(
            t for t, secs in run["submit_s"].items() for _ in secs if t > 0)
        log(f"[configs] {name}: {'inside' if in_bound else 'outside'} the step bound; "
            f"mapped reads {counters[1]} of {SWEEP_READS}; retried {run['retried']} "
            f"(dispatches by tier {dict(sorted(tiers.items()))}), host-mapped "
            f"{run['fallback']}; pre-filter counter {counters[2]:,} "
            f"({'above' if counters[2] >= 2**32 else 'below'} 2^32); set-up "
            f"{setup_s:.1f} s, first item after {run['first_s']:.3f} s with the captures "
            f"of {sorted(graphs)} in it")
        if not in_bound:
            check(counters[1] == 0, f"{tag}: a read mapped outside the step bound")
        else:
            check(counters[1] > 0, f"{tag}: no read mapped inside the step bound")

        # The kernels on this configuration's inputs: the reads once more,
        # outside the counted run, with the eager step (a replay calls no
        # wrapper, so none could be seen).
        probe.capture = SWEEP_CALLS
        engine.eager_step = True
        again = run_engine(engine, probe, batches, "stream")
        engine.eager_step = False
        probe.close()
        check(again["digest"] == run["digest"] and again["stats"] == run["stats"],
              f"{tag}: the eager step gave other records or counters")
        want = {"filter_tail_tier0", "banded_myers_tier0"} | (
            {"filter_tail_tier1", "banded_myers_tier1"} if tiers else set())
        check(want <= set(probe.captured), f"{tag}: captured {sorted(probe.captured)} only")
        for key, (args_, kw) in sorted(probe.captured.items()):
            row = _hold_call(name, key, args_, kw, SWEEP_ROWS.get((name, key)))
            if row is not None:
                rows.append(row)
        out[name] = {"counters": counters, "retried": run["retried"],
                     "dispatches": run["dispatches"], "fallback": run["fallback"],
                     "graphs": graphs, "reads_per_s": run["reads_per_s"],
                     "tail_shapes": run["tail_shapes"], "myers_shapes": run["myers_shapes"]}
        del engine, probe, batches, again
        torch.cuda.empty_cache()
    check({r["name"] for r in rows} == set(SWEEP_ROWS.values()),
          f"phase 10 timed rows {sorted(r['name'] for r in rows)} only")
    log(f"[configs] phase 10: {time.perf_counter() - t_phase:.1f} s")
    return out, rows


def all_launched(launches: dict) -> bool:
    """Each of the port's kernels launched at least once; a count that is
    missing is none."""
    return all(launches.get(k, 0) > 0 for k in SHAPES_KEY)


def scale_rows(tag: str, engine, batch, rows: dict) -> tuple[list[dict], dict]:
    """`batch` mapped once by `engine` with the eager step (a replay calls
    no wrapper); for each row (name -> (call key, test of the wrapper
    call)), the first call that passes its test is held against its plain
    version (exact) and timed as a kernel-table row. Returns the rows and
    the captured calls by row."""
    engine.eager_step = True
    probe = Probe(engine)
    probe.capture = {row: test for row, (_, test) in rows.items()}
    engine.map_batch(batch)
    probe.close()
    check(set(probe.captured) == set(rows),
          f"{tag}: captured the calls of {sorted(probe.captured)} only")
    return ([_hold_call(tag, key, *probe.captured[row], row, head="[scale]")
             for row, (key, _) in rows.items()], probe.captured)


def occ_wider(args: list) -> None:
    """The occurrence slab at the wider cap_occ of the command line's
    ladder (SCALE_WIDER), on tier-0 seed tables of phase 11's map: as many
    lanes as the tier's batch holds, those whose groups passed the tier-0
    cap_occ first (the reads the ladder retries there). Each mode held
    against the plain version (exact): own bound and slab, the bound
    alone, the slab at a given bound (the own one raised in every other
    group, -1 in the first); the own mode timed warm by CUDA events."""
    from fem_tpu_torch.ops.occ_slab import occ_bound, occ_slab, occ_slab_plain

    off_s, lfreq_s, start_s, lane_ok, occ, cap0 = args
    over = occ_slab_plain(*args).overflow_occ.any(dim=1)
    order = torch.sort((~over).int(), stable=True).indices
    for tier, reads, cap in SCALE_WIDER:
        idx = order[: 2 * reads]
        tables = [x[idx].contiguous() for x in (off_s, lfreq_s, start_s, lane_ok)]
        own = occ_slab_plain(*tables, occ, cap)
        d = max_abs_err(occ_parts(occ_slab(*tables, occ, cap)), occ_parts(own))
        d = max(d, max_abs_err(occ_parts(occ_bound(*tables, occ, cap)), occ_parts(own)[2:]))
        given = own.tkey.clone()
        given.view(-1)[1::2] += 1 << 33
        given.view(-1)[0] = -1
        d = max(d, max_abs_err(occ_parts(occ_slab(*tables, occ, cap, tkey=given)),
                               occ_parts(occ_slab_plain(*tables, occ, cap, tkey=given))))
        torch.cuda.synchronize()
        bnd, note = occ_bound_of(*tables, cap, "own")
        ms = cuda_ms(lambda: occ_slab(*tables, occ, cap), 20)
        log(f"[scale] occ_slab at tier {tier}'s cap_occ on the map's seed tables: NB="
            f"{idx.numel()} ({int(over[idx].sum())} of them over cap_occ {cap0} at tier 0) "
            f"G={off_s.shape[1]} CAP={cap}; {note}; own, bound-only and given-bound modes "
            f"max_abs_err {d}; {ms:.4f} ms warm, bound {bnd['bound_ms'] * 1e3:.2f} us by "
            f"{bnd['bound_by']}")
        check(d == 0, f"occ_slab differs from its plain version at cap_occ {cap}")


def phase_scale(workdir: str) -> tuple[dict, list]:
    """tools/torch_grch38_scale.py at SCALE_ARGS as a process of its own (the
    GRCh38 profile's 24 chromosomes, the index through the command line
    byte-equal to fem_baseline's, the unsharded map and the (1, 4) grid on
    cuda:0 equal to fem_baseline, the golden oracle's prefix, both kernels
    launched in each map), then the kernels at each map's own inputs: its
    first batch mapped again here, unsharded with the eager step (the
    filter tail at 256 + 256 over 20,000 lanes, Myers at 320,000 slots)
    and on a (1, 4) grid on cuda:0 (a cell's filter tail at 256 + 256,
    its Myers at 80,000 slots against its own reference slice), each call
    held against its plain version and timed. A row's launches are the
    tool's map's count at its shape (a process of its own, whose counts
    start at 0): "scale" for the unsharded map, "scale_grid" for the grid."""
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.storage import load_index
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.parallel.mesh import make_index_mesh
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine

    t_phase = time.perf_counter()
    d = os.path.join(workdir, "scale")
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_grch38_scale.py"),
                        *SCALE_ARGS, "--workdir", d, "--keep"],
                       env=_child_env(), capture_output=True, text=True, timeout=900)
    out = p.stdout.strip().splitlines()
    for line in out[:-1]:
        log(line if line.startswith("[scale]") else f"[scale] {line}")
    check(p.returncode == 0 and out, f"torch_grch38_scale failed (rc {p.returncode}): "
          f"{p.stdout[-3000:]}{p.stderr[-3000:]}")
    summary = json.loads(out[-1])
    stages = {st["stage"]: st for st in summary["stages"]}
    check(summary["ok"] and {"map", "map_grid"} <= set(stages),
          f"torch_grch38_scale: {[(st['stage'], st['ok']) for st in summary['stages']]}")
    runs = {}
    for name, path in (("map", "scale"), ("map_grid", "scale_grid")):
        st = stages[name]
        check(st["records_equal"] and st["counters_equal"] and st["golden_equal"]
              and all_launched(st["kernel_launches"]),
              f"scale {name}: not equal to fem_baseline, or a kernel never launched: "
              f"{st['kernel_launches']}")
        shapes = st["launches_by_shape"]
        runs[path] = {
            "tail_shapes": {tuple(int(x) for x in k.split("+")): n
                            for k, n in shapes["filter_tail"].items()},
            "myers_shapes": {tuple(int(x) for x in k.split("x")): n
                             for k, n in shapes["banded_myers"].items()},
            "occ_shapes": {tuple(int(x) for x in k.split("x")): n
                           for k, n in shapes["occ_slab"].items()}}
    check(len(stages["map_grid"]["cells"]) == 4, "scale: the grid is not (1, 4)")
    from fem_tpu_torch.pipeline.cli import eager_dispatches, programs_line

    for name in ("map", "map_grid"):
        progs = stages[name]["programs"]
        check(progs and eager_dispatches(progs) == 0
              and all(c["segments"] > 0 for p in progs for c in p["cells"]),
              f"scale {name}: not through the step graphs: {programs_line(progs)}")
    check(all(len(p["cells"]) == 4 for p in stages["map_grid"]["programs"]),
          "scale: the grid's programs are not of four cells")

    # The kernels on each map's own inputs.
    ref = fastx.read_fasta(os.path.join(d, "ref.fa"))
    index = load_index(os.path.join(d, "ref.index"))
    batch = next(fastx.stream_fastq_batches(os.path.join(d, "reads.fq"),
                                            batch_size=SCALE_BATCH))
    args = FemArgs(error_threshold=E, num_additional_qgrams=A)
    is_tail = lambda attr, a: attr == "filter_tail" and (a[0].shape[2], a[2]) == SCALE_TAIL
    is_occ = lambda attr, a: attr == "occ_slab" and (a[5], a[0].shape[0]) == (
        SCALE_TAIL[0], 2 * SCALE_BATCH)
    rows = []
    for tag, config, slots in (
            ("scale", EngineConfig(), SCALE_VERIFY_SLOTS),
            ("scale_grid", EngineConfig(index_mesh=make_index_mesh(["cuda:0"] * 4, 4)),
             SCALE_VERIFY_SLOTS // 4)):
        c = config
        check((c.batch_size, c.cap_occ, c.cap_cand, 2 * c.batch_size * c.verify_per_read)
              == (SCALE_BATCH, *SCALE_TAIL, SCALE_VERIFY_SLOTS),
              f"{tag}: the command line's defaults are not the rows' shapes")
        engine = MappingEngine(args, ref, index, config)
        suffix = "" if tag == "scale" else "_shard"
        got, captured = scale_rows(tag, engine, batch, {
            f"filter_tail_scale{suffix}": ("filter_tail_tier0", is_tail),
            f"banded_myers_scale{suffix}": (
                "banded_myers_tier0",
                lambda attr, a, slots=slots: attr == "verify_candidates"
                and (a[1].shape[0], a[4].shape[0]) == (slots, 2 * SCALE_BATCH)),
            f"occ_slab_scale{suffix}": ("occ_slab_tier0", is_occ)})
        rows += got
        if tag == "scale":
            occ_wider(captured["occ_slab_scale"][0])
        del engine, captured
        torch.cuda.empty_cache()
    log(f"[scale] phase 11: {time.perf_counter() - t_phase:.1f} s (the tool "
        f"{summary['seconds']:.1f} s)")
    return runs, rows


def main() -> int:
    from fem_tpu_torch.pipeline.engine import EngineConfig

    t_start = time.perf_counter()
    lap = lambda what: log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")
    smi = phase_device()
    dev = "cuda:0"
    phase_build()
    with tempfile.TemporaryDirectory() as workdir:
        benign_seqs = benign_genome()
        ref, index, paths = phase_setup(workdir, "benign", benign_seqs, read_seed=9)
        benign_paths = paths
        rows = phase_kernels(ref, index, dev)
        lap("phases 1-4")
        is_tail = lambda attr, a, shape: attr == "filter_tail" and (a[0].shape[2], a[2]) == shape
        is_verify = lambda attr, a, row: (  # a row's own test of (slots, lanes)
            attr == "verify_candidates"
            and ROW_LAUNCHES[row][1]((a[1].shape[0], a[4].shape[0])))
        is_occ = lambda attr, a, row: (  # a row's own test of (cap_occ, lanes)
            attr == "occ_slab" and ROW_LAUNCHES[row][1]((a[5], a[0].shape[0])))
        benign, captured = phase_main(
            "benign", ref, index, paths,
            EngineConfig(batch_size=BATCH, cap_occ=80, cap_cand=16,
                         verify_per_read=2, accept_per_read=0.85),
            dev, turns=("one_at_a_time", "stream", "stream", "one_at_a_time"),
            capture={"filter_tail": lambda attr, a: is_tail(attr, a, (80, 16)),
                     "filter_tail_tier1": lambda attr, a: is_tail(attr, a, TIER1[1:]),
                     "banded_myers": lambda attr, a: is_verify(attr, a, "banded_myers"),
                     "occ_slab": lambda attr, a: is_occ(attr, a, "occ_slab")},
            no_ladder_pass=True)
        rows += occ_rows("benign", captured, "[replay]")
        phase_replay(rows, captured, "main_inputs")
        lap("benign phases 5-6")
        del ref, index, captured
        torch.cuda.empty_cache()

        ref, index, paths = phase_setup(workdir, "adversarial", satellite_genome(),
                                        read_seed=14)
        adv_paths = paths
        adversarial, captured = phase_main(
            "adversarial", ref, index, paths,
            EngineConfig(batch_size=BATCH, cap_occ=80, cap_cand=64,
                         verify_per_read=8, accept_per_read=8),
            dev, turns=("stream", "one_at_a_time"),
            capture={"filter_tail_adv": lambda attr, a: is_tail(attr, a, ADV_TAIL),
                     "banded_myers_adv": lambda attr, a: is_verify(attr, a, "banded_myers_adv"),
                     "filter_tail_tier1": lambda attr, a: is_tail(attr, a, TIER1[1:]),
                     "filter_tail_tier2": lambda attr, a: is_tail(attr, a, TIER2[1:]),
                     "banded_myers_tier2":
                         lambda attr, a: is_verify(attr, a, "banded_myers_tier2"),
                     "occ_slab_tier1": lambda attr, a: is_occ(attr, a, "occ_slab_tier1"),
                     "occ_slab_tier2": lambda attr, a: is_occ(attr, a, "occ_slab_tier2")})
        rows += occ_rows("adversarial", captured, "[replay]")
        phase_replay(rows, captured, "adversarial_inputs")
        lap("adversarial phases 3, 5-6")
        del ref, index, captured
        torch.cuda.empty_cache()
        cli_shapes = phase_cli(workdir, benign_paths)
        lap("phase 7")
        phase_bench()
        lap("phase 8")
        grid_rows, grid_runs = phase_parallel(workdir, benign_paths, adv_paths,
                                              adversarial["fallback"], dev)
        lap("phase 9")
        sweep_runs, sweep_rows = phase_configs(workdir, benign_seqs, benign_paths)
        lap("phase 10")
        del benign_seqs
        scale_runs, scale_table = phase_scale(workdir)
        lap("phase 11")
    rows += grid_rows + sweep_rows + scale_table
    check(adversarial["retried"] > 0, "adversarial: no read was retried")
    check(any(cap + cc > 512 for cap, cc in adversarial["tail_shapes"]),
          "adversarial: filter_tail never launched above cap_cand + cap_occ = 512")
    check(TIER2[1:] in adversarial["tail_shapes"], "adversarial: tier 2 was never reached")

    # Launches of each row: what the wrapper counted at the row's shape in
    # each counted run; `launches` is the count on the row's own main path.
    # (The adversarial point's tier 0 has 262,144 verify slots too: tier 2's
    # launches are those over at most 2 * 64 lanes.)
    # A row of phase 10 is read on its configuration's counted run only: the
    # shape of a count names no Lmax, e or a.
    runs = {"benign": benign, "adversarial": adversarial, **grid_runs}
    paths = {**runs, **{f"configs_{n}": r for n, r in sweep_runs.items()}, **scale_runs}
    check({r["name"] for r in rows} == set(ROW_LAUNCHES), "a row without a launch count")
    for row in rows:
        kernel, at_shape, path = ROW_LAUNCHES[row["name"]]
        count = lambda by_shape: sum(n for s, n in by_shape.items() if at_shape(s))
        shapes = SHAPES_KEY[kernel]
        row["launches"] = count(paths[path][shapes])
        if path in runs:
            row.update({f"launches_{point}": count(run[shapes]) for point, run in runs.items()})
            row["launches_cli"] = count(cli_shapes[kernel])
        check(row["launches"] > 0, f"{row['name']} was launched no time on the main path")
        row["bound_us"] = row["bound_ms"] * 1e3
    log(f"[done] card: {smi}; the whole script {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
