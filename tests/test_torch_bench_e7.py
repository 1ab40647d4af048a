"""The benchmark's cell chr21_e7.len150 (FEM's widest point: e=7, a=2,
150 bp reads) on the CPU at a small size, through fembench's harness and
the port's plain torch versions: the run is correct at the program's
default caps and through the retry ladder; an engine at a smaller e or a
than the configuration's comes out not correct against the reference, so
the check holds the run to the configuration's own e and a; and the mix's
reads are 150 bp, inside FEM's step bound at k=12, step=3, e=7.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fem_tpu_torch.config import FemArgs
from fem_tpu_torch.io.fastx import stream_fastq_batches
from fem_tpu_torch.pipeline.engine import EngineConfig
from fembench import harness
from fembench import reads as reads_mod

torch.set_num_threads(1)

SEED = 2**31 + 7654321
CELL = "chr21_e7.len150"


def tiny():
    """chr21_e7 on two 150 kb sequences (the configuration's repeat model
    and seed), and len150 cut to a pool of 384 reads."""
    config = harness.load_json("configs", "chr21_e7")
    config["genome"] = dict(config["genome"], lengths_bp=[150_000, 150_000], names=["c1", "c2"])
    traffic = dict(harness.load_json("traffic", "len150"), pool_reads=384)
    return config, traffic


def run(monkeypatch, engine_config, **fem_over):
    """One run of the cell; `fem_over` gives the engine other FEM
    parameters than the configuration's, which the reference keeps."""
    bench = harness.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    real = harness.make_engine
    monkeypatch.setattr(harness, "make_engine", lambda inputs, device, ec=None: real(
        dataclasses.replace(inputs, fem=dict(inputs.fem, **fem_over)), device, ec))
    keep: dict = {}
    out = harness.run_cell(bench, cell, *tiny(), SEED, 0.5, False, "cpu", 0.0, lambda m: None,
                           engine_config=engine_config, keep=keep)
    return out, keep["window"]


def programs(window):
    return sorted(tuple(k) for k, _ in window["programs"])


@pytest.mark.parametrize("case", ["default", "ladder", "engine_e6", "engine_a1", "pool"])
def test_chr21_e7_len150(case, tmp_path, monkeypatch):
    if case == "pool":
        config, traffic = tiny()
        inputs = harness.make_inputs(config, traffic, SEED, "cpu", 64)
        path = str(tmp_path / "reads.fq")
        reads_mod.write_fastq(inputs.pool, path)
        lengths = np.concatenate([b.lengths for b in stream_fastq_batches(path, 64)])
        assert lengths.size == inputs.pool.size == 384
        assert (lengths == 150).all() and inputs.pool.codes.shape == (384, 150)
        fem = FemArgs(**config["fem"])
        assert (fem.error_threshold, fem.num_additional_qgrams, fem.num_qgrams) == (7, 2, 10)
        assert fem.step_size <= fem.max_step_size(150) == 5
        assert fem.max_step_size(100) < fem.step_size  # why the cell's reads are 150 bp
        return
    caps = {"ladder": {"cap_occ": 16, "cap_cand": 16}}.get(case, {})
    fem_over = {"engine_e6": {"error_threshold": 6},
                "engine_a1": {"num_additional_qgrams": 1}}.get(case, {})
    out, window = run(monkeypatch, EngineConfig(batch_size=64, **caps), **fem_over)
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert len(checks) == 8 and all(c["limit"] == 0 for c in out["checks"].values())
    if case == "default":
        assert out["correct"] and not any(checks.values()), checks
        assert programs(window) == [(0, 160)]
        assert window["retried_reads"] == 0
    elif case == "ladder":
        assert out["correct"] and not any(checks.values()), checks
        assert window["retried_reads"] > 0
        assert (1, 160) in programs(window)
    elif case == "engine_e6":
        assert not out["correct"]
        assert checks["mappings_gap"] > 0, checks
    else:
        assert not out["correct"]
        assert checks["prefilter_gap"] > 0, checks
