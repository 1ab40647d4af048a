"""The coordinate-sharded index across processes on the CPU (mirrors
tests/test_multihost_sharded.py): the command line's --index-shards in one
process, and two gloo processes over one ("data", "index") grid whose
index axis crosses the process boundary, so the truncation bound's max,
the per-read sums and maxes and the row gathers go over torch.distributed.
The merged record set and the summed counters must equal a plain
single-process run; with tight capacities the overflow reads climb the
retry ladder collectively, not the host mapper.
"""

import contextlib
import io
import json

import pytest
import torch

from fem_tpu.pipeline import cli as jcli
from fem_tpu_torch import sim
from fem_tpu_torch.pipeline import cli
from tests.test_torch_multihost import counters, map_argv, records, run_group

torch.set_num_threads(1)


def _run(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert cli.main(argv) == 0, buf.getvalue()
    return buf.getvalue()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mhs")
    # 4 chromosomes so the coordinate partition has shards to balance.
    seqs = sim.random_genome(240_000, num_seqs=4, seed=21, repeat_fraction=0.1)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    sim.write_fastq(str(d / "reads.fq"),
                    sim.simulate_reads(seqs, 256, read_length=100, max_errors=2, seed=22))
    assert cli.main(["index", "12", "3", str(d / "ref.fa"), str(d / "ref.index")]) == 0
    err = _run(map_argv(d) + ["-o", str(d / "plain.sam")])
    return d, counters(err)


def test_single_process_cli_index_shards(workdir):
    d, plain = workdir
    err = _run(map_argv(d) + ["-o", str(d / "shards2.sam"), "--index-shards", "2"])
    assert "[mesh] ('data', 'index') grid 1x2, 2 cells in this process" in err
    assert records(str(d / "shards2.sam")) == records(str(d / "plain.sam"))
    assert counters(err) == plain


def test_cross_process_index_shards(workdir):
    """Two entries a process: a 2 x 2 grid, each data row over both
    processes; each row's owner writes its reads, nothing twice."""
    d, plain = workdir
    out = str(d / "xhost.sam")
    errs = run_group(map_argv(d) + ["--index-shards", "2", "--local-devices", "2"], out)
    r0, r1 = records(out + ".host0000"), records(out + ".host0001")
    assert r0 and r1, "both processes own data rows"
    assert r0 | r1 == records(str(d / "plain.sam")) and not (r0 & r1)
    assert counters(errs[0]) == plain
    for h, err in enumerate(errs):
        assert f"[dist] rank {h} of 2: backend gloo (grid entries on the CPU)" in err
        assert "[mesh] ('data', 'index') grid 2x2, 2 cells in this process" in err


def test_four_processes_two_row_groups(workdir):
    """Four processes of one entry each over two index shards: data rows
    (0, 1) and (2, 3), each reduced and gathered over a process group of
    its own (dist.new_group); the rows' owners, 0 and 3, write them."""
    d, plain = workdir
    out = str(d / "four.sam")
    errs = run_group(map_argv(d) + ["--index-shards", "2"], out, n=4)
    parts = [records(f"{out}.host{h:04d}") for h in range(4)]
    assert parts[0] and parts[3] and not parts[1] and not parts[2]
    assert parts[0] | parts[3] == records(str(d / "plain.sam")) and not parts[0] & parts[3]
    assert counters(errs[0]) == plain


def test_index_shard_argument_errors_as_jax_cli(workdir, tmp_path, monkeypatch):
    """The JAX CLI's error text for -t with --index-shards, and for a batch
    size the data axis does not divide (8 entries, 2 index shards: 4 rows)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    d, _ = workdir
    out = ["-o", str(tmp_path / "x.sam")]
    cases = ((map_argv(d)[:-2] + ["--index-shards", "2", "-t", "2"], []),
             (map_argv(d, batch=30)[:-2] + ["--index-shards", "2"], ["--local-devices", "8"]))
    for argv, entries in cases:  # the JAX CLI's grid: its 8 virtual devices
        errs = []
        for main, extra in ((cli.main, ["--device", "cpu", *entries]), (jcli.main, [])):
            buf = io.StringIO()
            with contextlib.redirect_stderr(buf):
                assert main(argv + extra + out) == 1
            errs.append([line for line in buf.getvalue().splitlines() if "--" in line])
        assert errs[0] == errs[1] and errs[0], errs


def test_cross_process_retry_ladder(tmp_path):
    """Satellite arrays and deliberately tight tier-0 caps on a 2 x 2 grid
    over two processes: overflow reads retry on the device ladder, every
    process dispatching the same tiers (the all-gathered overflow bitmap),
    and the merged output equals a plain single-process run."""
    d = tmp_path
    seqs = sim.satellite_genome(120_000, num_seqs=2, seed=31, satellite_fraction=0.05)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    sim.write_fastq(str(d / "reads.fq"),
                    sim.simulate_reads(seqs, 192, read_length=100, max_errors=2, seed=32))
    assert cli.main(["index", "12", "3", str(d / "ref.fa"), str(d / "ref.index")]) == 0
    plain = counters(_run(map_argv(d) + ["-o", str(d / "single.sam")]))
    tight = ["--cap-occ", "16", "--cap-cand", "8", "--verify-per-read", "2",
             "--accept-per-read", "2", "--index-shards", "2", "--local-devices", "2"]
    out = str(d / "xhost.sam")
    errs = run_group(map_argv(d) + tight, out,
                    extra=lambda h: ["--stats-json", str(d / "stats.json")])
    r0, r1 = records(out + ".host0000"), records(out + ".host0001")
    assert r0 | r1 == records(str(d / "single.sam")) and not (r0 & r1)
    assert counters(errs[0]) == plain
    retried = fallbacks = 0
    for h in range(2):
        with open(str(d / f"stats.json.host{h:04d}")) as f:
            st = json.load(f)
        retried += st["retried_reads"]
        fallbacks += st["fallback_reads"]
    assert retried > 0, "tight caps must exercise the device retry ladder"
    assert fallbacks <= 192 // 20  # the ladder, not the host mapper, takes the overflow
