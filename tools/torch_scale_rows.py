"""Kernel rows of the GRCh38-scale map, on its own inputs, on one card.

    python tools/torch_scale_rows.py            # 3.0 Gb, on the card

tools/torch_grch38_scale.py's genome at --gb gigabases (its profile, seed
2024 and repeats) and its reads (100 bp, up to 5 errors, seed 77): the
FASTA and the first batch's FASTQ are written to --workdir, the index is
built in this process (index.build.build_index, the bytes `python -m
fem_tpu_torch index 12 3` writes), and the first batch is mapped once with
the command line's defaults (B = 10,000, tier 0's cap_occ derived from the
index + cap_cand 256, the default ladder) through the eager step. The
first occurrence-slab, filter-tail and banded-Myers call of each tier the
batch reaches is held against its plain version (exactly equal) and timed
as chip_smoke.py times a kernel-table row, with its bound: at 3.0 Gb a
12-mer bucket holds ~60 occurrences, so tier 0 derives cap_occ 576 (the
filter tail at 576 + 256 over 20,000 lanes takes the block route) and few
reads retry at tier 1 (2048 + 2048 over 1,024 lanes). One line a row and the card's name and power
limit; the last line is a JSON object of the rows and of the kernels'
launches by shape in the batch's map, with this process's peak host RSS
and the card's peak memory. Disk: the FASTA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _scale_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_grch38_scale", os.path.join(REPO, "tools", "torch_grch38_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gb", type=float, default=3.0, help="genome size in gigabases")
    ap.add_argument("--reads", type=int, default=200_000,
                    help="reads simulated, as the scale tool does (the first batch is mapped)")
    ap.add_argument("--workdir", default=None,
                    help="directory for the FASTA and FASTQ (default: a new temporary one, "
                         "removed after)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_scale_rows: no CUDA device")
    from fem_tpu_torch import kernels, sim
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.index.build import build_index
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine

    tool = _scale_tool()
    card = tool.device_line("cuda")
    workdir = a.workdir or tempfile.mkdtemp(prefix="scale_rows_")
    os.makedirs(workdir, exist_ok=True)
    fa, fq = os.path.join(workdir, "ref.fa"), os.path.join(workdir, "reads.fq")
    t0 = time.perf_counter()
    try:
        seqs = tool.genome(a.gb)
        sim.write_fasta(fa, seqs)
        reads = sim.simulate_reads(seqs, a.reads, read_length=tool.READ_LENGTH,
                                   max_errors=tool.E, seed=tool.READ_SEED)
        del seqs
        config = EngineConfig()
        sim.write_fastq(fq, reads[: config.batch_size])
        del reads
        ref = fastx.read_fasta(fa)
        t1 = time.perf_counter()
        index = build_index(ref, tool.K, tool.STEP)
        print(f"[rows] {card}: {a.gb} Gb, {int(ref.lengths.sum()):,} bases, index of "
              f"{index.occurrences.shape[0]:,} occurrences built in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        batch = next(fastx.stream_fastq_batches(fq, batch_size=config.batch_size))
        engine = MappingEngine(FemArgs(error_threshold=tool.E, num_additional_qgrams=tool.A),
                               ref, index, config)
        tests, shapes = {}, {}
        for tier, tc in enumerate((engine._tier(0), *engine.tiers)):
            tail = (tc.cap_occ, tc.cap_cand)
            myers = (int(2 * tc.batch_size * tc.verify_per_read), 2 * tc.batch_size)
            occ = (tc.cap_occ, 2 * tc.batch_size)
            tests[f"occ_slab_tier{tier}"] = lambda attr, args, occ=occ: (
                attr == "occ_slab" and (args[5], args[0].shape[0]) == occ)
            shapes[f"occ_slab_tier{tier}"] = ("occ_slab", occ)
            tests[f"filter_tail_tier{tier}"] = lambda attr, args, tail=tail: (
                attr == "filter_tail" and (args[0].shape[2], args[2]) == tail)
            tests[f"banded_myers_tier{tier}"] = lambda attr, args, myers=myers: (
                attr == "verify_candidates" and (args[1].shape[0], args[4].shape[0]) == myers)
            shapes[f"filter_tail_tier{tier}"] = ("filter_tail", tail)
            shapes[f"banded_myers_tier{tier}"] = ("banded_myers", myers)
        engine.eager_step = True
        probe = cs.Probe(engine)
        probe.capture = tests
        kernels.reset_launches()
        _, stats = engine.map_batch(batch)
        torch.cuda.synchronize()
        by_shape = kernels.launches_by_shape()
        probe.close()
        print(f"[rows] the first batch: {stats.num_reads:,} reads, {stats.num_mappings:,} "
              f"mappings, {engine.retried_reads:,} retried over {engine.tier_dispatches} "
              f"tier dispatches, {engine.fallback_reads} host-mapped; launches by shape "
              f"{ {k: dict(v) for k, v in by_shape.items()} }; the tiers' calls held: "
              f"{sorted(probe.captured)}", flush=True)
        cs.check(set(probe.captured) >= {"filter_tail_tier0", "banded_myers_tier0",
                                         "occ_slab_tier0"},
                 "the batch's tier-0 calls were not seen")
        table = []
        for row in tests:
            if row not in probe.captured:
                continue
            args, kw = probe.captured.pop(row)
            res = cs._hold_call("scale_rows", row, args, kw, row, head="[rows]")
            kernel, shape = shapes[row]
            res["launches_in_batch"] = by_shape[kernel].get(shape, 0)
            table.append(res)
        out = {"device": card, "gb": a.gb, "reads_in_batch": stats.num_reads,
               "tier0_cap_occ": engine.tier0_cap_occ,
               "retried": engine.retried_reads, "tier_dispatches": engine.tier_dispatches,
               "launches_by_shape": {k: {"x".join(map(str, sh)): n for sh, n in v.items()}
                                     for k, v in by_shape.items()},
               "rows": table, "seconds": time.perf_counter() - t0,
               "peak_host_rss_bytes": tool.rss_peak_self(),
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
    finally:
        if a.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
