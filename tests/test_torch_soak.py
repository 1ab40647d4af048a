"""tools/torch_soak.py at a small size on the CPU.

The tool's entry on a 250 kb satellite genome (15% tandem arrays) and 600
reads a line, e=5 at 100 bp and e=7 at 150 bp, batches of 128: the sorted
record set and the five counters equal fem_baseline's, and the ladder
retried reads at both of its tiers. On the CPU the filter tail is its plain
torch loop, which is slow at the default ladder's 5120 + 4096, so the test
names a narrower two-rung ladder through FEM_TPU_TIERS (the engine's own
knob); the card runs the default one.
"""

import importlib.util
import json
import os

import pytest
import torch

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools", "torch_soak.py")


def _tool():
    spec = importlib.util.spec_from_file_location("torch_soak", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_small_equals_fem_baseline(monkeypatch, capsys):
    torch.set_num_threads(1)
    monkeypatch.setenv("FEM_TPU_TIERS", "128:240:160:16:8;32:640:512:64:32")
    rc = _tool().main(["--device", "cpu", "--genome-mb", "0.25",
                       "--satellite-fraction", "0.15", "--reads", "600",
                       "--batch-size", "128", "--e", "5,7"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, "\n".join(out)
    assert [ln.split()[0] for ln in out[:-1]] == ["PASS", "PASS"]
    summary = json.loads(out[-1])
    assert summary["device"] == "cpu"
    assert [(r["e"], r["read_length"]) for r in summary["lines"]] == [(5, 100), (7, 150)]
    for r in summary["lines"]:
        assert r["records_equal"] and r["counters_equal"] and r["ok"]
        assert r["counters"][0] == 600 and r["records"] == r["mappings"] > 0
        assert r["retried"] > 0 and set(r["dispatches_by_tier"]) == {"1", "2"}
        assert sum(r["dispatches_by_tier"].values()) == r["tier_dispatches"]
        assert r["filter_tail_launches_by_shape"] == {}  # no kernel on the CPU


def test_soak_defaults_to_the_card(monkeypatch):
    """Without --device the tool asks for CUDA and stops where there is none."""
    mod = _tool()
    monkeypatch.setattr(mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([])
    assert mod.read_length(5) == 100 and mod.read_length(7) == 150
    assert mod.DEFAULT_READS == {5: 500_000, 7: 300_000}
