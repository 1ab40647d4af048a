"""Kernel rows of the slab compactions on the benchmark cells' own inputs,
on one card.

    python tools/torch_compact_rows.py [--cells chr21_e5.wgs,...] [--seed N]

For each cell of BENCHMARK.json (all by default): its configuration's
genome and index and the first batch of its traffic at `--seed`, made as
fembench makes them (fembench/harness.py: make_inputs, make_engine: the
program at EngineConfig() on one card), and that batch mapped once with
the eager step. The step's first verify-slab and accept calls are held
against the plain version (exactly equal) and timed as chip_smoke.py times
a kernel-table row, with their bounds. One line a row and the card's name
and power limit; the last line is a JSON object of the rows, each cell's
launches by shape in the batch's map and the card's peak memory.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def cell_rows(cell: dict, seed: int, dev) -> tuple[list, dict]:
    """The cell's two rows and its batch's launches by shape."""
    from fembench import harness
    from fembench import reads as reads_mod
    from fem_tpu_torch import kernels
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.pipeline.engine import EngineConfig

    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    B = EngineConfig().batch_size
    t0 = time.perf_counter()
    inputs = harness.make_inputs(config, dict(traffic, pool_reads=B), seed, dev, B)
    fd, path = tempfile.mkstemp(prefix="compact-rows-", suffix=".fq")
    os.close(fd)
    try:
        reads_mod.write_fastq(inputs.pool, path)
        batch = next(fastx.stream_fastq_batches(path, batch_size=B))
    finally:
        os.unlink(path)
    engine = harness.make_engine(inputs, dev)
    lanes = 2 * B
    cc = engine._tier(0).cap_cand
    tests = {"verify_slab": lambda attr, a: attr == "verify_slab" and a[0].shape == (lanes, cc),
             "accept_slab": lambda attr, a: (attr == "accept_slab"
                                             and a[0].num_candidates.shape[0] == lanes)}
    engine.eager_step = True
    probe = cs.Probe(engine)
    probe.capture = tests
    kernels.reset_launches()
    _, stats = engine.map_batch(batch)
    torch.cuda.synchronize()
    by_shape = kernels.launches_by_shape()
    probe.close()
    cs.check(set(probe.captured) == set(tests), f"{cell['name']}: the tier-0 calls were not seen")
    name = cell["config"]
    print(f"[compact] {cell['name']}: {stats.num_reads:,} reads, {stats.num_mappings:,} "
          f"mappings, {engine.retried_reads:,} retried, inputs and engine in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for key in tests:
        args, kw = probe.captured.pop(key)
        res = cs._hold_call(name, key, args, kw, f"{key}_{name}", head="[compact]")
        res["launches_in_batch"] = by_shape[key].get((cc, lanes), 0)
        rows.append(res)
    del engine, probe, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return rows, by_shape


def main(argv: list | None = None) -> int:
    from fembench import harness

    cells = {c["name"]: c for c in harness.load_benchmark()["workloads"]}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(cells),
                    help="comma-separated cells of BENCHMARK.json (default: all)")
    ap.add_argument("--seed", type=int, default=2_718_281_828,
                    help="the reads' seed, as the benchmark's --seed")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_compact_rows: no CUDA device")
    dev = torch.device("cuda")
    card = f"{torch.cuda.get_device_name(0)}, {cs._smi('power.limit')}"
    t0 = time.perf_counter()
    table, launches = [], {}
    for name in a.cells.split(","):
        rows, by_shape = cell_rows(cells[name], a.seed, dev)
        table += rows
        launches[cells[name]["config"]] = {
            k: {"x".join(map(str, sh)): n for sh, n in v.items()} for k, v in by_shape.items()}
    print(f"[compact] {card}: {len(table)} rows in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"device": card, "seed": a.seed, "rows": table,
                      "launches_by_shape": launches,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
