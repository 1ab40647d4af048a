"""The port's command line (fem_tpu_torch/pipeline/cli.py) against the JAX
package's (fem_tpu/pipeline/cli.py) on the same files, and the port's
golden oracle against fem_tpu's: `index` bytes, `map` SAM bytes and the
five counter lines, the argument checks and their exit codes. The device
engine runs with `--device cpu` (the kernels' plain versions); every
comparison is exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fem_tpu.golden.model import GoldenMapper as JGolden
from fem_tpu.pipeline import cli as jcli
from fem_tpu_torch import sim
from fem_tpu_torch.config import FemArgs
from fem_tpu_torch.golden import GoldenMapper
from fem_tpu_torch.pipeline import cli

torch.set_num_threads(1)


def _counter_lines(err: str) -> list[str]:
    return [line for line in err.splitlines() if line.startswith("The number of")]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    seqs = sim.random_genome(120_000, num_seqs=2, seed=5)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    reads = sim.simulate_reads(seqs, 120, read_length=100, max_errors=2, seed=6)
    sim.write_fastq(str(d / "reads.fq"), reads)
    assert cli.main(["index", "12", "3", str(d / "ref.fa"), str(d / "ref.index")]) == 0
    return d


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    """The JAX CLI sets up a compilation cache directory: keep it here."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))


def _map_args(d, e="2"):
    return ["map", "-e", e, "-a", "1", "--ref", str(d / "ref.fa"),
            "--index", str(d / "ref.index"), "--read1", str(d / "reads.fq")]


def test_index_file_equals_jax_cli(workdir, tmp_path, capsys):
    d = workdir
    assert jcli.main(["index", "12", "3", str(d / "ref.fa"), str(tmp_path / "j.index")]) == 0
    assert (tmp_path / "j.index").read_bytes() == (d / "ref.index").read_bytes()
    err = capsys.readouterr().err
    assert "Collected" in err and "Lookup table size: 16777217" in err


def test_map_device_equals_golden_and_jax_golden(workdir, tmp_path, capsys, jax_cache):
    d = workdir
    base = _map_args(d)
    assert cli.main(base + ["-o", str(tmp_path / "dev.sam"), "--batch-size", "64",
                            "--device", "cpu"]) == 0
    dev_err = capsys.readouterr().err
    assert cli.main(base + ["-o", str(tmp_path / "gold.sam"), "--engine", "golden"]) == 0
    gold_err = capsys.readouterr().err
    assert jcli.main(base + ["-o", str(tmp_path / "jgold.sam"), "--engine", "golden"]) == 0
    jgold_err = capsys.readouterr().err
    dev = (tmp_path / "dev.sam").read_bytes()
    assert dev.startswith(b"@SQ\t") and dev.count(b"\n") > 100
    assert dev == (tmp_path / "gold.sam").read_bytes() == (tmp_path / "jgold.sam").read_bytes()
    lines = _counter_lines(dev_err)
    assert lines[0] == "The number of read: 120" and len(lines) == 5
    assert lines == _counter_lines(gold_err) == _counter_lines(jgold_err)
    # The [main] summary lines, word for word but for the times.
    for err in (dev_err, jgold_err):
        assert "[main] Version: 0.1.0" in err and "[main] CMD: fem map -e 2" in err
        assert "[main] Real time: " in err and " sec; CPU: " in err


@pytest.mark.parametrize("argv", [
    ["-e", "9"], ["-e", "-1"], ["-e", "2", "-a", "5"], ["-e", "2", "-f", "x"],
    ["-e", "2", "-t", "0"],
])
def test_bad_args_return_1_as_jax_cli(argv, capsys):
    rest = ["--ref", "x", "--index", "y", "--read1", "z", "-o", "w"]
    assert cli.main(["map", *argv, *rest]) == 1
    port_err = capsys.readouterr().err
    assert jcli.main(["map", *argv, *rest]) == 1
    assert port_err == capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["bogus"], ["index", "12", "3"]])
def test_bad_commands_return_1(argv):
    assert cli.main(argv) == 1
    assert jcli.main(argv) == 1


@pytest.mark.parametrize("flag", [["--cap-vote", "32"], ["--no-warm-shadow"]])
def test_left_out_flags_are_rejected(flag):
    with pytest.raises(SystemExit) as exc:
        cli.main(["map", "--ref", "x", "--index", "y", "--read1", "z", "-o", "w", *flag])
    assert exc.value.code == 2


def test_v_seeding_flag_equals_g(workdir, tmp_path):
    # The reference accepts -f v but still runs group seeding (its 'v'
    # branch is empty); output must equal the -f g run, on both engines.
    base = _map_args(workdir, "1") + ["--batch-size", "60"]
    outs = {}
    for f in ("v", "g"):
        for engine in (["--engine", "golden"], ["--device", "cpu"]):
            out = tmp_path / f"{f}{engine[-1]}.sam"
            assert cli.main(base + ["-f", f, "-o", str(out), *engine]) == 0
            outs[f, engine[-1]] = out.read_bytes()
    assert len(set(outs.values())) == 1


def test_device_defaults_to_cuda_and_raises_without_it(workdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_map_args(workdir) + ["-o", str(tmp_path / "x.sam")])


def test_profile_writes_a_torch_profiler_trace(workdir, tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(_map_args(workdir) + ["-o", str(tmp_path / "p.sam"), "--device", "cpu",
                                          "--batch-size", "64", "--profile", str(prof)]) == 0
    trace = (prof / "trace.json").read_text()
    assert '"traceEvents"' in trace and "aten::" in trace


@pytest.mark.parametrize("e", [0, 2, 5])
def test_golden_mapper_equals_jax_golden(small_reference, small_index, e):
    """The port's GoldenMapper against fem_tpu's on the 200 kb fixture."""
    from fem_tpu.config import FemArgs as JArgs

    seqs, ref = small_reference
    reads = sim.simulate_reads(seqs, 150, read_length=100, max_errors=e, seed=40 + e)
    names = [r.name for r in reads]
    rs, qs = [r.seq for r in reads], [r.qual for r in reads]
    kw = dict(kmer_size=12, step_size=3, error_threshold=e, num_additional_qgrams=1)
    recs_t, st_t = GoldenMapper(FemArgs(**kw), ref, small_index).map_reads(names, rs, qs)
    recs_j, st_j = JGolden(JArgs(**kw), ref, small_index).map_reads(names, rs, qs)
    assert recs_t == recs_j and len(recs_t) >= 100
    assert dataclasses.asdict(st_t) == dataclasses.asdict(st_j)
    assert st_t.num_mapped_reads > 100


def test_golden_helpers_equal_jax():
    """The oracle's q-gram DP, seed hashes and read strands on random inputs."""
    from fem_tpu.config import FemArgs as JArgs
    from fem_tpu.golden import model as jm
    from fem_tpu_torch.golden import model as tm

    rng = np.random.default_rng(3)
    for e in (1, 3, 5):
        kw = dict(error_threshold=e, num_additional_qgrams=1)
        for _ in range(20):
            n = int(rng.integers(10, 30))
            freqs = rng.integers(0, 2**31, n).tolist()
            assert tm.select_optimal_prefix_qgrams(FemArgs(**kw), 2**32 - 5, 4, n, freqs) == \
                jm.select_optimal_prefix_qgrams(JArgs(**kw), 2**32 - 5, 4, n, freqs)
        codes = rng.integers(0, 4, 100).astype(np.uint8)
        hj, aj = jm.hash_all_seeds(codes, 12)
        ht, at = tm.hash_all_seeds(codes, 12)
        np.testing.assert_array_equal(hj, ht)
        assert aj == at
    for seq in (b"ACGTNacgtRYK", b"AAAA"):
        for a, b in zip(jm.read_strands(seq), tm.read_strands(seq)):
            np.testing.assert_array_equal(a, b)


def test_port_cli_imports_no_jax(workdir, tmp_path):
    """The port's CLI with the golden engine, then the device one, in a
    process of its own: neither jax nor fem_tpu is loaded."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from fem_tpu_torch.pipeline import cli\n"
        "import fem_tpu_torch.bench\n"
        f"base = {_map_args(workdir)!r}\n"
        f"assert cli.main(base + ['-o', {str(tmp_path / 'g.sam')!r}, '--engine', 'golden']) == 0\n"
        f"assert cli.main(base + ['-o', {str(tmp_path / 'd.sam')!r}, '--device', 'cpu',"
        f" '--batch-size', '64']) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'fem_tpu')"
        " or m.startswith(('jax.', 'fem_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "g.sam").read_bytes() == (tmp_path / "d.sam").read_bytes()
