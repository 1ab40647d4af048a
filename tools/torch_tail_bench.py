"""Times the filter-tail kernel of one tree at the ladder's shapes, on the card.

    python3 tools/torch_tail_bench.py [--root DIR]

imports fem_tpu_torch from DIR (default: this repository), so that two
trees are timed by the same code in one machine, in turns (parent, change,
change, parent). Inputs are chip_smoke.py's synthetic slabs, made from a
seed, at the default ladder's shapes: tier 0 of the benign and the
adversarial points (32,768 lanes at 80 + 16 and 80 + 64), tier 1 (1,024
lanes at 640 + 512) and tier 2 (128 lanes at 5120 + 4096), each at its
chip_smoke density and tiers 1 and 2 also at the adversarial stream's own
density (186.7 and 247.3 valid keys a group). Every call is held against
the plain version once, exactly. Times: the kernel alone by torch.profiler
(`ms`) and the CUDA-event median of the wrapper's call (`ms_events`), with
the bound from the same inputs. With --sweep, the tree's block-lane rows
are timed again at every block size the kernel has (128 to 1024 threads a
lane; `ms_by_threads`). Prints one JSON object, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the tree whose fem_tpu_torch is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="time the block-lane rows at each block size too")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_tail_bench: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from fem_tpu_torch.ops import filter_tail as ft
    from fem_tpu_torch.ops.types import BIG, SENTINEL_SID

    assert os.path.abspath(ft.__file__) == os.path.join(root, "fem_tpu_torch", "ops", "filter_tail.py")
    dev = "cuda:0"
    rng = np.random.default_rng(2024)

    def sparse(NB, CAP, keys):  # `keys` valid a group on average, diagonals as _wide_slabs
        sid = rng.integers(0, 3, (NB, 3, CAP))
        diag = rng.integers(0, 3 * CAP, (NB, 3, CAP))
        valid = rng.random((NB, 3, CAP)) < keys / CAP
        return (torch.from_numpy(np.where(valid, sid, SENTINEL_SID).astype(np.int32)).to(dev),
                torch.from_numpy(np.where(valid, diag, BIG).astype(np.int32)).to(dev))

    cases = [
        ("tier0_benign", 16, lambda: cs._clustered_slabs(rng, 32768, 3, 80, dev)),
        ("tier0_adversarial", 64, lambda: cs._clustered_slabs(rng, 32768, 3, 80, dev)),
        ("tier1", 512, lambda: cs._wide_slabs(rng, 1024, 3, 640, dev)),
        ("tier1_sparse", 512, lambda: sparse(1024, 640, 186.7)),
        ("tier2", 4096, lambda: cs._wide_slabs(rng, 128, 3, 5120, dev)),
        ("tier2_sparse", 4096, lambda: sparse(128, 5120, 247.3)),
    ]
    out = {"root": root, "card": cs._smi("name,power.limit"), "rows": []}
    for name, cc, make in cases:
        sid, diag = make()
        run = lambda: ft.filter_tail(sid, diag, cc, cs.E, cs.A)
        got, want = run(), ft.filter_tail_plain(sid, diag, cc, cs.E, cs.A)
        torch.cuda.synchronize()
        err = cs.max_abs_err(got, want)
        if err:
            raise SystemExit(f"{name}: the kernel differs from its plain version")
        bnd, note = cs.tail_bound(sid, diag, cc)
        row = {"name": name, "shape": list(sid.shape) + [cc], "max_abs_err": err,
               "ms": cs.profiler_ms(run, "filter_tail"), "ms_events": cs.cuda_ms(run, 20),
               "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"], "inputs": note}
        if a.sweep and ft.plan(sid.shape[2], cc).route == 1:
            row["ms_by_threads"] = {}
            for T in (128, 256, 512, 1024):
                run_t = lambda: ft._filter_tail_cuda(sid, diag, cc, cs.E, cs.A, threads=T)
                if cs.max_abs_err(run_t(), want):
                    raise SystemExit(f"{name} at {T} threads: differs from the plain version")
                row["ms_by_threads"][T] = cs.profiler_ms(run_t, "filter_tail")
            print(f"[tail] {name} by threads a lane: {row['ms_by_threads']}", flush=True)
        out["rows"].append(row)
        print(f"[tail] {name} {row['shape']}: {row['ms']:.4f} ms by the profiler, "
              f"{row['ms_events']:.4f} ms by events, bound {row['bound_ms'] * 1e3:.2f} us; "
              f"{note}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
