"""Command-line interface: the port of fem_tpu/pipeline/cli.py.

Mirrors the reference binary's surface (src/FEM.c:23-51):
    fem index <window_size> <step_size> <reference> <output>   (src/FEM_index.c:7-22)
    fem map -e INT -t INT -a INT -f g --ref R --index I --read1 Q -o OUT
                                                               (src/FEM_map.c:10-133)
plus the same exit summary (version/CMD/wall+CPU time) and the five
MappingStats counters (src/FEM_map.c:214-219), word for word as the JAX
package's CLI prints them.

    python -m fem_tpu_torch index 12 3 ref.fa ref.index
    python -m fem_tpu_torch map -e 2 --ref ref.fa --index ref.index \\
        --read1 reads.fq -o out.sam [--device cpu]

The device engine runs on the card (`--device cuda`, the default) and
raises when CUDA is absent; `--device cpu` runs the plain torch versions.
`-t N` fans the device engine out into N worker processes on the same
device. `--local-devices N` gives this process N grid entries (cards dealt
out round-robin, or N CPU entries under `--device cpu`): more than one is a
data-parallel grid. `--index-shards N` splits the index by coordinate over
N shards of a (data, index) grid. `--coordinator host:port` with
`--num-hosts` and `--host-id` joins the processes with torch.distributed:
independent processes over interleaved batches with the counters summed at
the end, or, with `--index-shards`, one grid over every process's entries
(parallel/multihost.py). Behavioral improvement over the reference, preserved
intentionally: the reference *ignores* the k/step stored in the index
header and filters with its hardcoded defaults (SURVEY.md §5.6); we take
k/step from the index file, which is the only correct interpretation.

Not ported: --cap-vote (the XLA slab path) and --no-warm-shadow
(shadow-warm); argparse rejects them.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

_COUNTER_KEYS = (
    "num_reads", "num_mapped_reads",
    "num_candidates_without_additional_qgram_filter",
    "num_candidates", "num_mappings",
)


def _cpu_time() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _read_checkpoint(path: str) -> list[tuple[int, int]]:
    """Parse a checkpoint file into [(reads, bytes)] history (oldest
    first). Legacy format (a single read count, no byte offset) yields
    [(reads, -1)] — resume then appends without truncating."""
    hist: list[tuple[int, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            hist.append(
                (int(parts[0]), int(parts[1]) if len(parts) > 1 else -1)
            )
    return hist


def _write_checkpoint(path: str, hist: list[tuple[int, int]]) -> None:
    """Atomically persist the (reads, bytes) history (last 256 entries, the
    checkpoint file format of the JAX CLI)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for reads, nbytes in hist[-256:]:
            f.write(f"{reads} {nbytes}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _print_counters(values) -> None:
    """The five oracle counters (src/FEM_map.c:214-219)."""
    reads, mapped, before_filter, candidates, mappings = values
    print(f"The number of read: {reads}", file=sys.stderr)
    print(f"The number of mapped read: {mapped}", file=sys.stderr)
    print(
        "The number of candidate before additional q-gram filter: "
        f"{before_filter}",
        file=sys.stderr,
    )
    print(f"The number of candidate: {candidates}", file=sys.stderr)
    print(f"The number of mapping: {mappings}", file=sys.stderr)


def index_main(argv: list[str]) -> int:
    if len(argv) < 4:
        print(
            "Usage: fem index <window_size> <step_size> <reference> <output>",
            file=sys.stderr,
        )
        return 1
    kmer_size, step_size = int(argv[0]), int(argv[1])
    reference_path, output_path = argv[2], argv[3]
    print(
        f"k: {kmer_size}, step size: {step_size}, reference: {reference_path}, "
        f"output: {output_path}",
        file=sys.stderr,
    )
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.index.storage import save_index
    from fem_tpu_torch.io.fastx import read_fasta

    t0 = time.time()
    reference = read_fasta(reference_path)
    index = build_index(reference, kmer_size, step_size)
    print(
        f"Collected {index.num_occurrences} seeds.\n"
        f"Lookup table size: {index.lookup.shape[0]}, occurrence table size: "
        f"{index.num_occurrences}.\nBuilt index in {time.time() - t0:f}s.",
        file=sys.stderr,
    )
    save_index(index, output_path)
    return 0


def _map_parent_workers(args, argv: list[str]) -> int:
    """Fan `fem map -t N` out to N single-threaded worker processes over
    interleaved batch shards, then merge their SAM shards and counters.
    The workers get this process's arguments, `--device` included; a
    worker that fails makes this process print its stderr and exit with
    its code."""
    import subprocess
    import tempfile

    import fem_tpu_torch
    from fem_tpu_torch.parallel.multihost import HostContext, shard_path

    t = args.t
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(fem_tpu_torch.__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for w in range(t):
            wargv = list(argv)
            # Rewrite -t and inject the worker-shard arguments.
            if "-t" in wargv:
                wargv[wargv.index("-t") + 1] = "1"
            else:
                wargv += ["-t", "1"]
            wargv += [
                "--num-hosts", str(t), "--host-id", str(w),
                "--stats-json", os.path.join(tmp, f"stats{w}.json"),
            ]
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-m", "fem_tpu_torch", "map", *wargv],
                    stderr=subprocess.PIPE, text=True, env=env,
                )
            )
        rc = 0
        for p in procs:
            _, err = p.communicate()
            if p.returncode != 0:
                print(err, file=sys.stderr)
                rc = p.returncode
        if rc:
            return rc

        # Merge SAM shards: header from shard 0, records from all shards
        # (inter-read order across workers is unordered, exactly like the
        # reference with t > 1 — record-set equality is the contract).
        with open(args.output, "wb") as out:
            for w in range(t):
                sp = shard_path(args.output, HostContext(t, w))
                with open(sp, "rb") as f:
                    for line in f:
                        if w == 0 or not line.startswith(b"@"):
                            out.write(line)
                os.unlink(sp)

        totals = [0] * 5
        for w in range(t):
            # Workers shard their --stats-json path like any multi-host run.
            sp = shard_path(os.path.join(tmp, f"stats{w}.json"), HostContext(t, w))
            with open(sp) as f:
                st = json.load(f)["mapping_stats"]
            for i, k in enumerate(_COUNTER_KEYS):
                totals[i] += st[k]
        if args.stats_json:
            with open(args.stats_json, "w") as f:
                json.dump({"mapping_stats": dict(zip(_COUNTER_KEYS, totals))}, f, indent=2)
                f.write("\n")
    _print_counters(totals)
    return 0


def map_main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="fem map", add_help=True)
    p.add_argument("-e", type=int, default=2, help="error threshold")
    p.add_argument("-t", type=int, default=1, help="number of worker processes")
    p.add_argument("-a", type=int, default=1, help="# additional q-grams")
    p.add_argument("-f", default="g", help='seeding algorithm ("g" group seeding)')
    p.add_argument("--ref", required=True, help="input reference file")
    p.add_argument("--index", required=True, help="input index file")
    p.add_argument("--read1", required=True, help="input read1 file")
    p.add_argument("-o", dest="output", required=True, help="output SAM file")
    p.add_argument("--batch-size", type=int, default=10000)
    p.add_argument("--cap-occ", type=int, default=None,
                   help="tier-0 occurrence-slab capacity (engine tuning)")
    p.add_argument("--cap-cand", type=int, default=None,
                   help="tier-0 candidate capacity (engine tuning)")
    p.add_argument("--verify-per-read", type=float, default=None,
                   help="tier-0 verify slots per read-strand (engine tuning)")
    p.add_argument("--accept-per-read", type=float, default=None,
                   help="tier-0 accepted-hit slots per read (engine tuning)")
    p.add_argument(
        "--engine",
        choices=["device", "golden"],
        default="device",
        help="device = GPU pipeline, golden = scalar oracle",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the device engine (default cuda; "
                        "cpu runs the kernels' plain versions)")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace (trace.json) and the program's "
                        "spans on its clock (spans.json) to this directory")
    p.add_argument("--stats-json", default=None,
                   help="write pipeline metrics + counters as JSON")
    p.add_argument("--engine-json", default=None,
                   help="write what the device engine did as JSON: load times, "
                        "steady reads/s, retries, kernel launches by shape, peak "
                        "device memory, each grid cell's index")
    p.add_argument("--checkpoint", default=None,
                   help="progress file enabling resume after interruption")
    p.add_argument("--verbose-batches", action="store_true",
                   help="log per-batch mapping time (reference map.c:57)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="worker run: total number of worker processes")
    p.add_argument("--host-id", type=int, default=0,
                   help="worker run: this process's id in [0, num-hosts)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process run: torch.distributed rendezvous host:port")
    p.add_argument("--local-devices", type=int, default=None,
                   help="grid entries this process uses (cards, or CPU entries "
                        "under --device cpu)")
    p.add_argument("--index-shards", type=int, default=1,
                   help="coordinate-shard the index over this many grid shards "
                        "(whole-genome scale; spans processes when run under "
                        "--coordinator)")
    args = p.parse_args(argv)

    # Constraint surface of check_args (src/FEM_map.c:29-55).
    if not (0 <= args.e <= 7):
        print("Wrong error threshold.", file=sys.stderr)
        return 1
    if args.t <= 0:
        print("Wrong number of threads.", file=sys.stderr)
        return 1
    if not (0 <= args.a <= 2):
        print("Wrong number of additional q-grams.", file=sys.stderr)
        return 1
    if args.f not in ("g", "v"):
        # The reference accepts both flags but only ever wires group
        # seeding (src/FEM_map.c:109-117 leaves the 'v' branch empty).
        print("Wrong name of seeding algorithm!", file=sys.stderr)
        return 1

    if args.index_shards > 1 and args.t > 1:
        print("--index-shards is incompatible with -t > 1 worker processes.",
              file=sys.stderr)
        return 1
    if args.t > 1 and args.engine == "device" and args.num_hosts == 1:
        # The reference's -t spawns t pthread mapping workers over disjoint
        # batches (src/FEM_map.c:182-189). Here each worker is a PROCESS
        # with its own engine on the same device: one process's rate is
        # set by its host enqueue under the interpreter lock, which a
        # second process does not share. Workers write SAM shards and stats
        # files; the parent merges both.
        return _map_parent_workers(args, argv)

    import torch

    from fem_tpu_torch.parallel import multihost

    # Each process maps a disjoint interleaved batch subset and writes its
    # own SAM shard; -t workers' parent merges them, a process group sums
    # the counters at the end.
    entries = [torch.device("cpu")]
    if args.engine == "device":
        entries = multihost.local_entries(
            args.device, _local_count(args), args.num_hosts, args.host_id)
    ctx = multihost.initialize(args.coordinator, args.num_hosts, args.host_id, entries)
    try:
        return _map_in_process(args, ctx, entries, multihost)
    finally:
        multihost.finalize(ctx)


def _local_count(args) -> int | None:
    """--local-devices; by default one entry for a -t worker, else every
    card (None), raised to as many entries as the index shards need: a grid
    may name a card more than once."""
    import torch

    if args.local_devices is not None:
        return args.local_devices
    if args.index_shards <= 1:
        return 1 if args.coordinator is None and args.num_hosts > 1 else None
    n_proc = args.num_hosts if args.coordinator else 1
    count = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    count = max(count, 1)
    while (count * n_proc) % args.index_shards:
        count += 1
    return count


def _map_in_process(args, ctx, entries, multihost) -> int:
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.golden.model import GoldenMapper, MappingStats
    from fem_tpu_torch.index.storage import load_index
    from fem_tpu_torch.io.fastx import read_fasta, stream_fastq_batches
    from fem_tpu_torch.io.sam import SamWriter
    from fem_tpu_torch.utils.metrics import PipelineMetrics, Timer, take_spans, tracing

    load_t0 = time.time()
    reference = read_fasta(args.ref)
    load_s = {"reference": time.time() - load_t0}
    load_t0 = time.time()
    index = load_index(args.index)
    load_s["index"] = time.time() - load_t0
    fem_args = FemArgs(
        kmer_size=index.kmer_size,
        step_size=index.step_size,
        error_threshold=args.e,
        num_additional_qgrams=args.a,
        num_threads=args.t,
    )
    total = MappingStats()
    t0 = time.time()

    # Resume: the checkpoint stores (reads, output-bytes) pairs taken when
    # the output prefix was exactly the records of that read prefix
    # (map_stream runs `ordered` under --checkpoint). Resume truncates the
    # SAM shard to the stored byte offset, so a crash between checkpoints
    # neither loses nor duplicates records.
    skip_reads = 0
    resume_bytes = -1
    ckpt_path = multihost.shard_path(args.checkpoint, ctx) if args.checkpoint else None
    ckpt_hist: list[tuple[int, int]] = []
    if ckpt_path and os.path.exists(ckpt_path):
        ckpt_hist = _read_checkpoint(ckpt_path)
        if ckpt_hist:
            skip_reads, resume_bytes = ckpt_hist[-1]
    # Global-mesh mode: the index is coordinate-sharded over a grid spanning
    # all processes, so every process consumes the SAME batch stream (each
    # emits the data rows it owns) instead of an interleaved subset.
    global_mesh_mode = args.index_shards > 1 and ctx.initialized
    if global_mesh_mode and args.checkpoint:
        # Every step is collective: all processes MUST resume from the same
        # stream position. They crash at different positions, so they meet
        # at the minimum; each truncates its own shard to its byte offset
        # AT that position (positions are batch boundaries, the same on
        # every process).
        common = multihost.allreduce_min(skip_reads, ctx)
        if common != skip_reads:
            at = [h for h in ckpt_hist if h[0] == common]
            if not at:
                print(
                    f"Checkpoint history too short to rewind from "
                    f"{skip_reads} to the fleet minimum {common}; delete "
                    f"the checkpoints and restart the run.",
                    file=sys.stderr,
                )
                return 1
            skip_reads, resume_bytes = at[0]
            ckpt_hist = [h for h in ckpt_hist if h[0] <= common]
    out_path = multihost.shard_path(args.output, ctx)
    if skip_reads and not os.path.exists(out_path):
        print(f"Checkpoint present but {out_path} is missing; "
              f"restarting from 0.", file=sys.stderr)
        skip_reads, resume_bytes, ckpt_hist = 0, -1, []
    if skip_reads:
        print(f"Resuming after {skip_reads} reads.", file=sys.stderr)

    def batches():
        skipped = 0
        stream = stream_fastq_batches(args.read1, batch_size=args.batch_size)
        if not global_mesh_mode:
            stream = multihost.shard_batches(stream, ctx)
        for batch in stream:
            if skipped + batch.num_reads <= skip_reads:
                skipped += batch.num_reads
                continue
            yield batch

    if skip_reads:
        writer_file = open(out_path, "r+b")
        if resume_bytes >= 0:
            # Drop any records written after the checkpointed prefix (the
            # crash window) — resume re-maps those reads.
            writer_file.truncate(resume_bytes)
        writer_file.seek(0, os.SEEK_END)
        writer = None
    else:
        writer = SamWriter(out_path, reference.names, reference.lengths.tolist())
        writer_file = None

    def write_chunks(recs):
        if writer is not None:
            for r in recs:
                writer.write_record(r)
        else:
            for r in recs:
                writer_file.write(r)

    def out_flush_tell() -> int:
        if writer is not None:
            return writer.tell()
        writer_file.flush()
        return writer_file.tell()

    metrics = PipelineMetrics()
    prof = None
    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if args.engine == "device" and torch.device(args.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        tracing(True)  # the program's spans, on the trace's clock
    engine = None
    try:
        if args.engine == "golden":
            mapper = GoldenMapper(fem_args, reference, index)
            for batch in batches():
                bt = Timer()
                recs, stats = mapper.map_reads(batch.names, batch.seqs, batch.quals)
                write_chunks(recs)
                total += stats
                metrics.batch(batch.num_reads, len(recs))
                if args.verbose_batches:
                    print(f"Mapped read batch in {bt.elapsed():f}s.", file=sys.stderr)
        else:
            from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
            from fem_tpu_torch.pipeline.prefetch import ThreadedBatchSource

            tune = {
                k: v
                for k, v in (
                    ("cap_occ", args.cap_occ),
                    ("cap_cand", args.cap_cand),
                    ("verify_per_read", args.verify_per_read),
                    ("accept_per_read", args.accept_per_read),
                )
                if v is not None
            }
            if args.index_shards > 1:
                tune["index_mesh"] = grid = multihost.global_index_mesh(
                    args.index_shards, entries, ctx)
                n_dp = grid.grid.shape[0]
                if args.batch_size % n_dp:
                    print(f"--batch-size must be divisible by the data mesh ({n_dp}).",
                          file=sys.stderr)
                    return 1
            elif len(entries) > 1 and args.batch_size % len(entries) == 0:
                # Reads split over this process's entries, the index on each.
                tune["mesh"] = grid = multihost.local_data_mesh(entries)
            else:
                grid = None
            if grid is not None:
                _print_grid(grid)
            load_t0 = time.time()
            engine = MappingEngine(
                fem_args, reference, index,
                EngineConfig(batch_size=args.batch_size, **tune),
                device=entries[0],
            )
            load_s["engine"] = time.time() - load_t0
            source = ThreadedBatchSource(batches())
            bt = Timer()
            t_stream = time.time()
            items = []  # (wall, reads so far) after each item, for --engine-json
            # Checkpointing needs read-order output (see map_stream); the
            # flushed byte offset then pairs with the stream position.
            for recs, stats in engine.map_stream(source, ordered=ckpt_path is not None):
                write_chunks(recs)
                total += stats
                items.append((time.time(), total.num_reads))
                dt = bt.reset()
                metrics.batch(stats.num_reads, len(recs))
                if args.verbose_batches:
                    print(f"Mapped read batch in {dt:f}s.", file=sys.stderr)
                if ckpt_path:
                    # engine.consumed_reads = stream position through the
                    # item just written; in ordered mode the flushed file
                    # prefix is exactly this process's records for reads
                    # [0, position).
                    pos = skip_reads + engine.consumed_reads
                    ckpt_hist.append((pos, out_flush_tell()))
                    del ckpt_hist[:-256]
                    _write_checkpoint(ckpt_path, ckpt_hist)
    finally:
        if prof is not None:
            tracing(False)
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(
                multihost.shard_path(os.path.join(args.profile, "trace.json"), ctx))
            with open(multihost.shard_path(os.path.join(args.profile, "spans.json"), ctx),
                      "w") as f:
                json.dump(take_spans(), f)
        if writer is not None:
            writer.close()
        else:
            writer_file.close()
    metrics.wall_total_s = time.time() - t0
    if engine is not None:
        metrics.fallback_reads = engine.fallback_reads
        metrics.retried_reads = engine.retried_reads
        if args.engine_json:
            _dump_engine_json(multihost.shard_path(args.engine_json, ctx), engine,
                              load_s, items, t_stream)

    # The counters summed over the processes (the reference's per-thread
    # stats rollup at join, src/FEM_map.c:200-212).
    total = multihost.allreduce_stats(total, ctx)
    if args.stats_json:
        metrics.dump_json(multihost.shard_path(args.stats_json, ctx), total)
    if ctx.host_id != 0:
        print(f"[host {ctx.host_id}] wrote {out_path}", file=sys.stderr)
        return 0

    _print_counters([getattr(total, k) for k in _COUNTER_KEYS])
    print(f"Time: {time.time() - t0:f}s", file=sys.stderr)
    return 0


def _dump_engine_json(path: str, engine, load_s: dict, items: list, t_stream: float) -> None:
    """What the device engine did, as JSON: load seconds (reference, index,
    engine with its device index), the stream's seconds and its steady
    reads/s (after the first two items, so the retry tax is in it and the
    warm-up is not), the kernels' launches by shape (filter_tail by
    "cap_occ+cap_cand", banded_myers by "slots x lanes"), and the engine's
    report (MappingEngine.report)."""
    from fem_tpu_torch import kernels

    reads = items[-1][1] if items else 0
    steady = None
    if len(items) > 2 and reads > items[1][1]:
        t1, r1 = items[1]
        steady = (reads - r1) / (items[-1][0] - t1)
    shapes = kernels.launches_by_shape()
    out = {
        "load_s": load_s,
        "stream_s": (items[-1][0] - t_stream) if items else 0.0,
        "reads": reads,
        "steady_reads_per_s": steady,
        "kernel_launches": dict(kernels.launches),
        "launches_by_shape": {
            "filter_tail": {f"{c}+{cc}": n for (c, cc), n in sorted(shapes["filter_tail"].items())},
            "banded_myers": {f"{v}x{nb}": n for (v, nb), n in sorted(shapes["banded_myers"].items())},
            "occ_slab": {f"{c}x{nb}": n for (c, nb), n in sorted(shapes["occ_slab"].items())},
            **{k: {f"{cc}x{nb}": n for (cc, nb), n in sorted(shapes[k].items())}
               for k in ("verify_slab", "accept_slab")},
        },
        **engine.report(),
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")


def programs_line(programs: list) -> str:
    """MappingEngine.report()'s step programs as one line: each key
    (tier, Lmax) with its dispatches and replays, and each cell's segments,
    capture seconds, graph MiB and replays."""
    def mib(x):
        return "not captured" if x is None else f"{x:.1f} MiB"

    return "; ".join(
        f"{tuple(p['key'])}: {p['dispatches']} dispatches, {p['replays']} replays, cells "
        + ", ".join(f"{tuple(c['cell'])} {c['segments']} graph(s) captured in "
                    f"{c['capture_s'] or 0:.3f} s, {mib(c['graph_MiB'])}" for c in p["cells"])
        for p in programs)


def eager_dispatches(programs: list) -> int:
    """Dispatches past each key's first that replayed no graph: 0 when the
    step ran through its graphs throughout."""
    return sum(p["dispatches"] - 1 - p["replays"] for p in programs if p["dispatches"])


def _print_grid(grid) -> None:
    """What the grid is and where its cells run, on stderr: a grid that
    names one card more than once says so."""
    import torch

    shape = "x".join(str(x) for x in grid.devices.shape)
    mine = grid.local_cells()
    devs = sorted({str(dev) for _, _, dev in mine})
    where = (f"every cell of this process shares {devs[0]}" if len(devs) == 1
             else f"{len(devs)} devices: {', '.join(devs)}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"[mesh] {grid.axis_names} grid {shape}, {len(mine)} cells in this process, "
          f"{where} ({cards} card(s) on this machine)", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(
            "Program: fem_tpu_torch (GPU-native Fast and Efficient short read Mapper)\n"
            "Usage:   fem <command> [options]\n\n"
            "Command: index   build index for reference\n"
            "         map     map reads",
            file=sys.stderr,
        )
        return 1
    real0, cpu0 = time.time(), _cpu_time()
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        rc = index_main(rest)
    elif cmd == "map":
        rc = map_main(rest)
    else:
        print(f"[main] unrecognized command '{cmd}'", file=sys.stderr)
        return 1
    if rc == 0:
        from fem_tpu_torch import __version__

        print(f"[main] Version: {__version__}", file=sys.stderr)
        print(f"[main] CMD: fem {' '.join(argv)}", file=sys.stderr)
        print(
            f"[main] Real time: {time.time() - real0:.3f} sec; "
            f"CPU: {_cpu_time() - cpu0:.3f} sec",
            file=sys.stderr,
        )
    return rc


if __name__ == "__main__":
    sys.exit(main())
