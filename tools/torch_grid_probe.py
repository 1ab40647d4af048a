"""The port's grids over several cards, against the same grids on one card
(fem_tpu_torch/parallel/), and processes that each own a card (NCCL).

    python3 tools/torch_grid_probe.py

Needs two or more cards (n of them). On `chip_smoke.py`'s benign point (a
46 Mb genome, 65,536 reads of 100 bp, B=16,384, cap_occ 80, cap_cand 16,
vpr 2, apr 0.85, the default ladder), each of: a data grid of n, a (1, n)
and, for even n, a (2, n/2) (data, index) grid, is built twice, once with
cell k on card k and once with every cell on cuda:0, and mapped through the
pipelined stream in turns (cards, one card, one card, cards) for steady
reads/s; every run must give fem_baseline's records and counters, and go
through the grid's step graphs (pipeline/engine.py:GridProgram): a line an
engine gives its keys and each cell's capture time, graph memory and
replays, and every dispatch after a key's first must be a replay. Then n
`python -m fem_tpu_torch map` processes, each on its own card, joined by
torch.distributed (the [dist] lines must name NCCL): independent, and as
one grid with --index-shards n and with --index-shards 2; the merged
shards must equal fem_baseline's. Prints the cards' name and power limit,
then one JSON object with the rates. Runs on the card only.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _processes(tag: str, base: list, out: str, n: int, extra: list):
    """n CLI processes, rank h on its own card: merged digest, rank 0's
    counters, wall."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fem_tpu_torch", *base, "-o", out, "--num-hosts", str(n),
         "--host-id", str(h), "--coordinator", f"127.0.0.1:{port}", "--local-devices", "1",
         *extra], env=cs._child_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for h in range(n)]
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
    chunks = []
    for h, (p, err) in enumerate(zip(procs, errs)):
        cs.check(p.returncode == 0, f"{tag}: rank {h} failed (rc {p.returncode}): {err[-3000:]}")
        dist_line = [x for x in err.splitlines() if x.startswith("[dist]")]
        cs.check(len(dist_line) == 1 and "backend nccl" in dist_line[0],
                 f"{tag}: rank {h} did not choose NCCL on a card of its own: {dist_line}")
        cs.log(f"[probe] {tag} rank {h}: {dist_line[0]}")
        with open(f"{out}.host{h:04d}", "rb") as f:
            chunks.append(f.read())
    return cs.digest_lines(chunks), cs.counters_from_stderr(errs[0]), wall


def main() -> int:
    from fem_tpu_torch.config import FemArgs
    from fem_tpu_torch.io import fastx
    from fem_tpu_torch.parallel.mesh import make_index_mesh, make_mesh
    from fem_tpu_torch.pipeline.cli import eager_dispatches, programs_line
    from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
    from fem_tpu_torch.stats import MappingStats

    smi = cs.phase_device()
    n = torch.cuda.device_count()
    cs.check(n >= 2, f"this probe needs two or more cards, found {n}")
    cs.phase_build()
    args = FemArgs(kmer_size=cs.KMER, step_size=cs.STEP, error_threshold=cs.E,
                   num_additional_qgrams=cs.A)
    cfg = dict(batch_size=cs.BATCH, cap_occ=80, cap_cand=16, verify_per_read=2,
               accept_per_read=0.85)
    out = {"device": smi, "cards": n, "grids": {}, "processes": {}}
    with tempfile.TemporaryDirectory() as wd:
        ref, index, paths = cs.phase_setup(wd, "benign", cs.benign_genome(), read_seed=9)
        batches = list(fastx.stream_fastq_batches(paths["fq"], batch_size=cs.BATCH))
        cards = [f"cuda:{k}" for k in range(n)]
        layouts = [("data", lambda devs: {"mesh": make_mesh(devs)}),
                   (f"index_1x{n}", lambda devs: {"index_mesh": make_index_mesh(devs, n)})]
        if n % 2 == 0:
            layouts.append((f"index_2x{n // 2}",
                            lambda devs: {"index_mesh": make_index_mesh(devs, n // 2)}))
        for tag, grid in layouts:
            engines = {where: MappingEngine(args, ref, index, EngineConfig(**cfg, **grid(devs)))
                       for where, devs in (("cards", cards), ("one_card", ["cuda:0"] * n))}
            rates = {"cards": [], "one_card": []}
            for where in ("cards", "one_card", "one_card", "cards"):
                probe = cs.Probe(engines[where])
                run = cs.run_engine(engines[where], probe, batches, "stream")
                probe.close()
                cs.baseline_check(f"{tag} on {where}", paths, run)
                cs._log_run(f"{tag} on {where}", "pipelined stream", run)
                rates[where].append(run["reads_per_s"])
            out["grids"][tag] = rates
            for where, engine in engines.items():
                progs = [p.describe() for _, p in sorted(engine.programs.items())]
                cs.log(f"[probe] {tag} on {where}: step programs {programs_line(progs)}")
                cs.check(eager_dispatches(progs) == 0,
                         f"{tag} on {where}: a dispatch after its key's first replayed no graph")
            del engines
            torch.cuda.empty_cache()
        base = ["map", "-e", str(cs.E), "-a", str(cs.A), "--ref", paths["fa"], "--index",
                paths["ix"], "--read1", paths["fq"], *cs.CLI_TUNE]
        runs = [("independent", []), (f"index_shards_{n}", ["--index-shards", str(n)])]
        if n > 2 and n % 2 == 0:
            runs.append(("index_shards_2", ["--index-shards", "2"]))
        for tag, extra in runs:
            digest, counters, wall = _processes(tag, base, os.path.join(wd, f"{tag}.sam"), n,
                                                extra)
            cs.baseline_check(f"{n} processes {tag}", paths,
                              {"digest": digest, "stats": MappingStats(*counters)})
            cs.log(f"[probe] {n} processes {tag}: {wall:.2f} s wall (process start included)")
            out["processes"][tag] = wall
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
