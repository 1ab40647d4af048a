"""Run one cell of the benchmark of fem_tpu_torch once, on one card.

    python3 fembench/run.py --workload chr21_e5.wgs --seed 7 --seconds 10 --trace 0

The cell (BENCHMARK.json `workloads`) names a configuration
(fembench/configs/<config>.json) and a traffic mix
(fembench/traffic/<mix>.json). It makes the configuration's genome (from
the configuration's own seed: one reference, as a deployment has) and its
FEM index (built on the card), and from `--seed` a pool of reads, written
as a FASTQ file under the temporary directory; builds the program's
MappingEngine at its default EngineConfig; streams batches until no step
program is left to capture (the warm-up); then drives
`MappingEngine.map_stream` for `--seconds` on the file, read as the
command line reads it, from its start again at its end, and lets the
stream drain (a window also ends after harness.TRACE_STEPS device steps).
Then it frees the engine and checks the window's output against the plain
reference (fembench/reference/). The window runs under torch.profiler:
without `--trace 1` it traces the device alone and the end-to-end metrics
are printed; with it, the host's calls too, and the per-layer metrics.

Before the result it prints the machine (card, power limit, SM clock,
device count, torch and CUDA versions); every number the check compared,
beside its limit, is in the last lines of standard error and under
`checks`, the last key of the result. The last line of standard output is
the result, one JSON object. A run without a card, or with fewer cards
than the cell asks for, or with JAX loaded, exits non-zero with no result.

`--control best_only` stands the control in the program's place for the
check (fembench/harness.py: CONTROLS); a run with it must come out not
correct.
"""

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fem_tpu")


def process_start() -> float:
    """This process's start on the wall clock, from /proc (10 ms ticks);
    the time this module was first run where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def machine_line(torch) -> str:
    """The card, its power limit and SM clock (nvidia-smi), the device
    count, the CPUs this process may use, and the torch and CUDA versions."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi failed: {exc}"
    return (f"[machine] {smi}; {torch.cuda.device_count()} devices; "
            f"{len(os.sched_getaffinity(0))} of {os.cpu_count()} CPUs; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")


def main(argv=None) -> int:
    start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("best_only",), default=None)
    a = p.parse_args(argv)
    # The program builds its kernels and native code into build/fem_tpu_torch
    # of the checkout; it uses no Triton and no torch extension.
    sys.path.insert(0, ROOT)
    import torch

    from fembench import harness

    bench = harness.load_benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        log(f"no workload {a.workload!r} in BENCHMARK.json ({', '.join(cells)})")
        return 2
    cell = cells[a.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{a.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    import fem_tpu_torch.pipeline.engine  # noqa: F401  (the program: fails here without it)

    print(machine_line(torch), flush=True)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    out = harness.run_cell(bench, cell, config, traffic, a.seed, a.seconds, bool(a.trace),
                           "cuda:0", start, log, control=a.control)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"modules that must not be loaded are: {', '.join(loaded)}")
        return 4
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": cell["chips"], **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks  # the last key
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
