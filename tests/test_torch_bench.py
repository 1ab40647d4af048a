"""The port's bench (fem_tpu_torch/bench.py) against the repo's bench.py:
its helpers on the same inputs, one tiny run on the CPU whose every swept
worker count is record- and counter-equal to fem_baseline, and a run in
which one worker count's digest differs, which must exit non-zero.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fem_tpu_torch import bench

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A genome of 0.2 Mb, 384 reads in batches of 64, no adversarial line.
_TINY = {"FEM_BENCH_GENOME_MB": "0.2", "FEM_BENCH_READS": "384", "FEM_BENCH_BATCH": "64",
         "FEM_BENCH_ADV_READS": "0", "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def jbench():
    """The repo's bench.py, loaded from its file (it is not a package)."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(_REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_digest_lines_equal(jbench):
    rng = np.random.default_rng(8)
    lines = [b"r%d\t0\tchr1\t%d\t255\t100M\t*\t0\t0\tACGT\tIIII\tNM:i:0\tMD:Z:100"
             % (i, int(p)) for i, p in enumerate(rng.integers(1, 10**6, 300))]
    chunks = [b"@SQ\tSN:chr1\tLN:5\n" + b"\n".join(lines[:100]) + b"\n",
              b"\n".join(lines[100:]) + b"\n", b""]
    got = bench._digest_lines(chunks)
    assert got == jbench._digest_lines(chunks) and got[1] == 300
    # Order-independent: the records in another order give the same digest.
    shuffled = [b"\n".join(lines[i] for i in rng.permutation(300))]
    assert bench._digest_lines(shuffled) == got


def test_counters_from_stderr_equal(jbench):
    err = ("k: 12\nThe number of read: 90\nThe number of mapped read: 88\n"
           "The number of candidate before additional q-gram filter: 1234\n"
           "The number of candidate: 99\nThe number of mapping: 97\nTime: 1s\n")
    assert bench._counters_from_stderr(err) == jbench._counters_from_stderr(err) == [
        90, 88, 1234, 99, 97]
    assert bench._counters_from_stderr("nothing") == jbench._counters_from_stderr("nothing") == []


@pytest.mark.parametrize("num_reads,batch,nworkers,n_warm", [
    (327680, 16384, 1, 1), (327680, 8192, 2, 1), (163840, 8192, 2, 1),
    (1000, 64, 3, 1), (384, 64, 2, 2), (100, 64, 2, 1),
])
def test_timed_read_ranges_equal(jbench, num_reads, batch, nworkers, n_warm):
    assert bench._timed_read_ranges(num_reads, batch, nworkers, n_warm) == \
        jbench._timed_read_ranges(num_reads, batch, nworkers, n_warm)


def test_batch_for_equal(jbench, monkeypatch):
    monkeypatch.delenv("FEM_BENCH_BATCH", raising=False)
    assert [bench._batch_for(n) for n in (1, 2, 4)] == [jbench._batch_for(n) for n in (1, 2, 4)]
    monkeypatch.setenv("FEM_BENCH_BATCH", "4096")
    assert bench._batch_for(2) == jbench._batch_for(2) == 4096


def test_tiny_cpu_run_every_worker_count_equal(tmp_path):
    env = dict(os.environ, PYTHONPATH=_REPO, **_TINY)
    proc = subprocess.run([sys.executable, "-m", "fem_tpu_torch.bench", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["records_equal"] is True
    assert line["records_equal_by_workers"] == {"2": True, "1": True}
    assert line["device"] == "cpu" and "not a GPU measurement" in line["metric"]
    assert line["value"] > 0 and line["whole_run_rps"] > 0 and line["vs_baseline"] > 0
    # Two workers time batches 2-5 of 6, one worker batches 1-5.
    assert line["reads_checked"] == 4 * 64 + 5 * 64
    assert "adversarial_rps" not in line
    # On the CPU the wrappers run the plain versions: no kernel launched.
    assert line["kernel_launches"] == {"banded_myers": 0, "filter_tail": 0, "occ_slab": 0}
    assert set(line["rps_by_workers"]) == {"2", "1"}
    assert proc.stderr.count("full-run equality") == 2


def test_unequal_worker_count_fails_the_run(monkeypatch, capsys):
    """One worker count's digest made to differ: both counts are reported,
    and the run exits non-zero though the other count (the faster one,
    perhaps) is equal."""
    for k, v in _TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("FEM_BENCH_SKIP_BASELINE", "1")
    monkeypatch.setenv("PYTHONPATH", _REPO)
    real = bench.run_workers

    def one_worker_differs(fixture_dir, n, device, **kw):
        res = real(fixture_dir, n, device, **kw)
        if n == 1:
            res["stats"]["rec_digest"] = (res["stats"]["rec_digest"] + 1) % bench._DIG_MOD
        return res

    monkeypatch.setattr(bench, "run_workers", one_worker_differs)
    assert bench.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["records_equal"] is False
    assert line["records_equal_by_workers"] == {"2": True, "1": False}
    assert "differ from fem_baseline" in out.err


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
