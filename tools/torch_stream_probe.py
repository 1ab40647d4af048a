"""Where a fresh process's time goes, and how a stream's length sets its
rate, for the port's engine (fem_tpu_torch) on one GPU.

    python tools/torch_stream_probe.py [--reads 327680]

Builds the bench's benign point (a 46 Mb `sim.random_genome`, seed 7, 30%
repeats; 100 bp reads with up to 5 errors, seed 9; k=12 step=3, e=5, a=1)
and then times, in this one process: `import torch` (at the top), the
reference and index load, the CUDA context, `MappingEngine()` at the
bench's caps (B=16,384, cap_occ 80, cap_cand 16, vpr 2, apr 0.85, the
default ladder), `map_stream` over the first 4 and over all 20 batches in
turns (4, 20, 20, 4), and a second `MappingEngine()` in the same process.
Prints the card's name and power limit, then one JSON object. Runs on the
card only: without CUDA it raises.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
import torch  # noqa: E402

IMPORT_TORCH_S = time.perf_counter() - T0
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fem_tpu_torch import sim  # noqa: E402
from fem_tpu_torch.config import FemArgs  # noqa: E402
from fem_tpu_torch.index.build import build_index  # noqa: E402
from fem_tpu_torch.index.storage import load_index, save_index  # noqa: E402
from fem_tpu_torch.io.fastx import read_fasta, stream_fastq_batches  # noqa: E402
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine  # noqa: E402

BATCH = 16_384


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reads", type=int, default=20 * BATCH)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_stream_probe runs on a CUDA device only")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    out = {"import torch s": round(IMPORT_TORCH_S, 3)}

    def lap(name, t1):
        out[name] = round(time.perf_counter() - t1, 3)

    with tempfile.TemporaryDirectory() as d:
        seqs = sim.random_genome(46_000_000, num_seqs=1, seed=7, repeat_fraction=0.3)
        fa, ix, fq = (os.path.join(d, f) for f in ("ref.fa", "ref.index", "reads.fq"))
        sim.write_fasta(fa, seqs)
        save_index(build_index(read_fasta(fa), 12, 3), ix)
        sim.write_fastq(fq, sim.simulate_reads(seqs, args.reads, read_length=100,
                                               max_errors=5, seed=9))
        del seqs
        t1 = time.perf_counter()
        ref, index = read_fasta(fa), load_index(ix)
        lap("reference + index load s", t1)
        batches = list(stream_fastq_batches(fq, BATCH))
    t1 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    lap("CUDA context s", t1)
    fem_args = FemArgs(kmer_size=12, step_size=3, error_threshold=5, num_additional_qgrams=1)
    config = EngineConfig(batch_size=BATCH, cap_occ=80, cap_cand=16, verify_per_read=2,
                          accept_per_read=0.85)
    t1 = time.perf_counter()
    engine = MappingEngine(fem_args, ref, index, config)
    torch.cuda.synchronize()
    lap("MappingEngine() s", t1)
    for n in (4, len(batches), len(batches), 4):
        t1 = time.perf_counter()
        got = sum(st.num_reads for _, st in engine.map_stream(batches[:n]))
        rate = round(got / (time.perf_counter() - t1))
        out.setdefault(f"map_stream of {n} batches, reads/s in turns", []).append(rate)
    t1 = time.perf_counter()
    MappingEngine(fem_args, ref, index, config)
    torch.cuda.synchronize()
    lap("second MappingEngine() s", t1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
