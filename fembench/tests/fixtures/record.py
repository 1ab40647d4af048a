"""Record a traced run's metric inputs as a fixture of
test_fembench_metrics.py, on a card:

    python3 fembench/tests/fixtures/record.py chr21_e5.wgs 11000000002 30 [DIR]

writes DIR/<cell>.json (DIR: this folder by default): what the per-layer metric
readers read (the window's counters and retries, the trace's summary) and
the values the run gave."""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from fembench import harness  # noqa: E402


def main() -> None:
    cell_name, seed, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
    out_dir = sys.argv[4] if len(sys.argv) > 4 else HERE
    bench = harness.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    keep: dict = {}
    out = harness.run_cell(bench, cell, harness.load_json("configs", cell["config"]),
                           harness.load_json("traffic", cell["traffic"]), seed, seconds, True,
                           "cuda:0", time.time(), lambda m: print(m, file=sys.stderr, flush=True),
                           keep=keep)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_name + ".json"), "w") as f:
        json.dump({"run": keep, "metrics": out["metrics"]}, f)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
