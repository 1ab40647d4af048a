"""tools/torch_grch38_scale.py at a tiny size on the CPU, held against the
JAX package.

The tool's stages run once (3 Mb over the 24-chromosome GRCh38 profile, 300
reads, batches of 64, a (1, 2) grid): its index file, sharded index and
both maps' records are held against fem_tpu's build_index,
build_sharded_index and golden oracle on the same seeded reference, and
against fem_baseline. The genome's profile and seed are pinned to
tools/grch38_scale.py by reading that file's text (importing it sets JAX
up). A fem_baseline that writes another index, and a map that launched
no kernel on the card, make the tool exit 1. The
port's FASTA reader and index build, both rewritten for this scale, are
held against fem_tpu's on edge cases.
"""

import dataclasses
import gzip
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from fem_tpu.config import FemArgs
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.index import build as jbuild
from fem_tpu.io import fastx as jfastx
from fem_tpu.parallel import sharded_index as jsharded
from fem_tpu_torch.index import build as tbuild
from fem_tpu_torch.index.storage import load_index
from fem_tpu_torch.io import fastx as tfastx
from fem_tpu_torch.parallel import sharded_index as tsharded

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOL = os.path.join(_REPO, "tools", "torch_grch38_scale.py")
_ARGS = ["--device", "cpu", "--gb", "0.003", "--reads", "300", "--batch-size", "64",
         "--index-shards", "2", "--golden-reads", "16", "--baseline-threads", "2"]


def _tool():
    spec = importlib.util.spec_from_file_location("torch_grch38_scale", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(path) -> list:
    with open(path, "rb") as f:
        return sorted(ln for ln in f.read().split(b"\n") if ln and not ln.startswith(b"@"))


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    """One run of the tool's stages; its summary and its kept files."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mod = _tool()
    d = str(tmp_path_factory.mktemp("scale"))
    summary = mod.run(mod.parse_args(_ARGS + ["--workdir", d, "--keep"]))
    return mod, summary, d


def test_stages_pass_and_report(scale):
    _, summary, _ = scale
    assert summary["ok"], summary
    stages = {s["stage"]: s for s in summary["stages"]}
    assert list(stages) == ["synthesize", "reads", "index", "golden", "map", "map_grid"]
    assert stages["synthesize"]["chromosomes"] == 24
    assert stages["index"]["sha256"] == stages["index"]["baseline_sha256"]
    for name in ("map", "map_grid"):
        st = stages[name]
        assert st["records_equal"] and st["counters_equal"] and st["golden_equal"]
        assert st["counters"][0] == 300 and st["records"] == st["counters"][4] > 0
        assert st["launches_by_shape"] == {"filter_tail": {}, "banded_myers": {},
                                           "occ_slab": {}, "verify_slab": {},
                                           "accept_slab": {}}  # CPU
        assert st["rss_bytes"] > 0 and st["seconds"] > 0
    cells = stages["map_grid"]["cells"]
    assert [c["cell"] for c in cells] == [[0, 0], [0, 1]]
    whole = stages["map"]["cells"][0]["occurrences"]
    assert whole == stages["index"]["occurrences"] < sum(c["occurrences"] for c in cells)


def test_profile_and_seed_are_the_jax_tools(scale):
    """tools/grch38_scale.py's chromosome profile, seed and repeat content,
    read from its text."""
    mod = scale[0]
    text = open(os.path.join(_REPO, "tools", "grch38_scale.py")).read()
    profile = re.search(r"profile = np\.array\(\[([\d,\s]+)\]", text).group(1)
    assert tuple(int(x) for x in profile.replace("\n", " ").split(",")) == mod.PROFILE_MB
    assert len(mod.PROFILE_MB) == 24
    assert f"default_rng({mod.GENOME_SEED})" in text
    assert "rng.integers(%d, %d)" % mod.SEGMENT_BP in text
    assert f"rng.random(seg_len) < {mod.DIVERGENCE}" in text
    assert f"int(ln * {mod.REPEAT_SHARE})" in text
    assert "(profile / profile.sum() * args.gb * 1e9).astype(np.int64)" in text
    # The index of 3.0 Gb: 999,999,915 occurrences, two under the u32 guard.
    assert (mod.index_bytes(3.0) - 8 - 4 * (4**12 + 1) - 8) // 8 == 999_999_915


def test_index_equals_fem_tpu(scale):
    _, _, d = scale
    ref = jfastx.read_fasta(os.path.join(d, "ref.fa"))
    want = jbuild.build_index(ref, 12, 3)
    got = load_index(os.path.join(d, "ref.index"))
    assert got.lookup.dtype == want.lookup.dtype and got.occurrences.dtype == want.occurrences.dtype
    np.testing.assert_array_equal(got.lookup, want.lookup)
    np.testing.assert_array_equal(got.occurrences, want.occurrences)


@pytest.mark.parametrize("chunk", [None, 300_007])
def test_sharded_index_equals_fem_tpu(scale, monkeypatch, chunk):
    """The port's sharded build of the tool's index against fem_tpu's, as
    tests/test_torch_sharded_index.py converts it; with a chunk of 300,007
    occurrences the build's passes cut buckets and shards mid-run."""
    _, _, d = scale
    if chunk:
        monkeypatch.setattr(tsharded, "_CHUNK", chunk)
    ref = tfastx.read_fasta(os.path.join(d, "ref.fa"))
    index = load_index(os.path.join(d, "ref.index"))
    got = tsharded.build_sharded_index(index, ref, 2)
    want = jsharded.build_sharded_index(index, jfastx.read_fasta(os.path.join(d, "ref.fa")), 2)
    assert got.ranges == want.ranges and got.lookup.dtype == np.int64
    np.testing.assert_array_equal(got.lookup, want.lookup)
    for f in ("own_start", "own_end", "halo_lo", "ref_lengths", "freq_table"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got.ref_offsets, want.ref_offsets.astype(np.int64))
    for s in range(2):
        n = int(want.lookup[s, -1])
        pairs = want.occ_rows[s].reshape(-1, 2)[:n].astype(np.uint64)
        np.testing.assert_array_equal(got.occ[s], (pairs[:, 0] << np.uint64(32)) | pairs[:, 1])
        flat = got.ref_flat[s]
        np.testing.assert_array_equal(flat, want.ref_flat[s, : flat.shape[0]])


def test_maps_equal_fem_tpu_golden_and_fem_baseline(scale):
    """Both maps' SAM records and counters against fem_tpu's golden oracle on
    every read, and against fem_baseline's SAM."""
    _, summary, d = scale
    ref = jfastx.read_fasta(os.path.join(d, "ref.fa"))
    index = jbuild.build_index(ref, 12, 3)
    reads = list(jfastx.iter_fastx(os.path.join(d, "reads.fq")))
    recs, stats = GoldenMapper(FemArgs(error_threshold=5, num_additional_qgrams=1),
                               ref, index).map_reads([r.name for r in reads],
                                                     [r.seq for r in reads],
                                                     [r.qual for r in reads])
    want = sorted(ln for ln in b"".join(recs).split(b"\n") if ln)
    counters = [stats.num_reads, stats.num_mapped_reads,
                stats.num_candidates_without_additional_qgram_filter,
                stats.num_candidates, stats.num_mappings]
    assert _records(os.path.join(d, "baseline_t2.sam")) == want
    for st in summary["stages"][-2:]:
        assert _records(os.path.join(d, f"{st['stage']}.sam")) == want, st["stage"]
        assert st["counters"] == st["baseline_counters"] == counters, st["stage"]
    golden = _records(os.path.join(d, "golden.sam"))
    assert golden and set(golden) <= set(want)


def test_an_index_that_differs_exits_1(scale, tmp_path, capsys):
    """A fem_baseline whose index file differs by one byte: the index stage
    fails, the run stops there and the tool exits 1."""
    from fem_tpu_torch.native.build import build_baseline

    mod = scale[0]
    fake = tmp_path / "fem_baseline"
    fake.write_text(
        "#!/bin/sh\n"
        f'"{build_baseline()}" "$@" || exit $?\n'
        'if [ "$1" = index ]; then printf x | dd of="$5" bs=1 seek=1000 conv=notrunc '
        "2>/dev/null; fi\n")
    fake.chmod(0o755)
    rc = mod.main(_ARGS + ["--reads", "50", "--workdir", str(tmp_path / "w"),
                           "--baseline", str(fake)])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1, "\n".join(out)
    summary = json.loads(out[-1])
    assert not summary["ok"]
    assert [s["stage"] for s in summary["stages"]] == ["synthesize", "reads", "index"]
    assert not summary["stages"][-1]["ok"]
    assert any(ln.startswith("FAIL index") for ln in out)


def test_a_map_without_kernel_launches_exits_1(scale, tmp_path, monkeypatch, capsys):
    """On the card a map must launch each of the port's kernels: an engine
    report whose launch counts are empty (or leave one out) fails the map
    stage and the tool exits 1. The card is simulated: the maps run on the CPU and
    their report's counts are replaced."""
    mod = scale[0]
    assert not mod.kernels_launched({})
    assert not mod.kernels_launched({"filter_tail": 3})
    assert not mod.kernels_launched({"filter_tail": 3, "banded_myers": 0})
    assert not mod.kernels_launched({"filter_tail": 3, "banded_myers": 1})
    assert not mod.kernels_launched({"filter_tail": 3, "banded_myers": 1, "occ_slab": 3})
    assert mod.kernels_launched({"filter_tail": 3, "banded_myers": 1, "occ_slab": 3,
                                 "verify_slab": 3, "accept_slab": 3})
    real_port = mod.Runner.port

    def port(self, tag, *args, env=None):
        args = ["cpu" if a == "cuda" else a for a in args]
        r = real_port(self, tag, *args, env=env)
        if "--engine-json" in args:
            ej = args[args.index("--engine-json") + 1]
            with open(ej) as f:
                eng = json.load(f)
            with open(ej, "w") as f:
                json.dump(dict(eng, kernel_launches={}), f)
        return r

    monkeypatch.setattr(mod.Runner, "port", port)
    monkeypatch.setattr(mod, "device_line", lambda device: "a simulated card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    argv = [x if x != "cpu" else "cuda" for x in _ARGS]
    rc = mod.main(argv + ["--reads", "50", "--golden-reads", "4", "--index-shards", "1",
                          "--workdir", str(tmp_path / "w")])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1, "\n".join(out)
    summary = json.loads(out[-1])
    last = summary["stages"][-1]
    assert last["stage"] == "map" and not last["ok"] and not last["kernels_launched"]
    assert last["records_equal"] and last["counters_equal"]
    assert "a kernel never launched" in last["why"]


def test_defaults_are_the_card_and_full_size(scale, monkeypatch):
    mod = scale[0]
    a = mod.parse_args([])
    assert (a.device, a.gb, a.reads, a.index_shards, a.golden_reads, a.batch_size) == (
        "cuda", 3.0, 200_000, 4, 64, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([])


def test_rows_tool_needs_the_card(monkeypatch):
    """tools/torch_scale_rows.py times kernels on the card: without CUDA it
    stops before it writes or builds anything."""
    spec = importlib.util.spec_from_file_location(
        "torch_scale_rows", os.path.join(_REPO, "tools", "torch_scale_rows.py"))
    rows = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        rows.main(["--gb", "0.003"])


def test_too_little_disk_stops_before_writing(scale, tmp_path, monkeypatch):
    mod = scale[0]
    usage = mod.shutil.disk_usage(tmp_path)
    monkeypatch.setattr(mod.shutil, "disk_usage",
                        lambda p: usage._replace(free=10**6))
    with pytest.raises(SystemExit, match="GB free"):
        mod.main(_ARGS + ["--workdir", str(tmp_path / "w")])
    assert os.listdir(tmp_path / "w") == []


_FASTA_CASES = [
    b">a x\nACGT\nAC\n\nGG\n>b\n>c d e\r\nAC\r\nGT\r\n\r\n>d\nAC\rGT\n>e\nAAA",
    b">only",
    b">x\n",
    b">x\r\nAC\r\r\nG\n",
    b">x\nA>C\n> y\nAA\n",
    b"",
    b"@r1\nACGT\n+\nIIII\n",
]


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("case", range(len(_FASTA_CASES)))
def test_read_fasta_equals_fem_tpu(tmp_path, case, gz):
    """The port reads a FASTA file whole (a join a record, not a loop a
    line): headers, empty records, blank and CR/LF lines, '>' inside a
    line, FASTQ and empty files as fem_tpu's line parser reads them."""
    data = _FASTA_CASES[case]
    path = tmp_path / "x.fa"
    path.write_bytes(gzip.compress(data) if gz else data)
    got, want = tfastx.read_fasta(str(path)), jfastx.read_fasta(str(path))
    assert got.names == want.names and got.seqs == want.seqs
    for f in ("lengths", "offsets", "flat_codes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("k,step", [(12, 3), (10, 5), (8, 1), (12, 2)])
def test_build_index_equals_fem_tpu(tmp_path, k, step):
    """The sort of (hash, window) keys gives fem_tpu's stable-argsort layout,
    with chromosomes shorter than k and ambiguous bases among the others."""
    from fem_tpu_torch import sim

    seqs = sim.random_genome(240_000, num_seqs=3, seed=3, repeat_fraction=0.2,
                             n_fraction=0.001)
    seqs.insert(1, (b"short", b"ACGTACG"))
    seqs.append((b"k_long", b"ACGTACGTACGT"))
    sim.write_fasta(str(tmp_path / "r.fa"), seqs)
    ref = tfastx.read_fasta(str(tmp_path / "r.fa"))
    got, want = tbuild.build_index(ref, k, step), jbuild.build_index(ref, k, step)
    assert dataclasses.astuple(got)[:2] == dataclasses.astuple(want)[:2]
    assert got.lookup.dtype == want.lookup.dtype == np.uint32
    np.testing.assert_array_equal(got.lookup, want.lookup)
    np.testing.assert_array_equal(got.occurrences, want.occurrences)
