"""What the benchmark loads, in fresh processes, by whole top-level module
names: the harness (run.py, its modules and the program it drives) loads
no `jax`, `jaxlib`, `flax` or `fem_tpu`; the reference loads none of those
and no `fem_tpu_torch` either."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROBE = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
for i, path in enumerate({files!r}):
    spec = importlib.util.spec_from_file_location("probe_%d" % i, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in {modules!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(files, modules):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, files=files, modules=modules)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = loaded([os.path.join(ROOT, "fembench", "run.py")],
                 ["fembench.harness", "fembench.trace", "fem_tpu_torch.pipeline.engine",
                  "fem_tpu_torch.kernels", "torch.profiler"])
    assert "fem_tpu_torch" in top and "fembench" in top
    assert not top & {"jax", "jaxlib", "flax", "fem_tpu"}, top


def test_reference_loads_no_program():
    top = loaded([], ["fembench.reference.fem", "fembench.reference.golden"])
    assert "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "fem_tpu", "fem_tpu_torch"}, top


def test_metric_readers_load_no_program():
    files = [os.path.join(ROOT, "fembench", "metrics", f)
             for f in sorted(os.listdir(os.path.join(ROOT, "fembench", "metrics")))
             if f.endswith(".py")]
    top = loaded(files, [])
    assert not top & {"jax", "jaxlib", "flax", "fem_tpu", "fem_tpu_torch"}, top
