"""Several processes of the port's command line on the CPU, joined by
torch.distributed with the gloo backend (mirrors tests/test_multihost.py).

Independent mode: each of two processes maps an interleaved half of the
read stream, writes its own SAM shard, and the five counters are summed
over the process group; the merged record set and the counters must
equal a single-process run (the reference's t > 1 contract is record-set
equality, SURVEY.md §2.4). Global-mesh mode with a checkpoint: two
processes killed at different stream positions rewind to the smaller
(allreduce_min) and resume byte-equal to the uninterrupted run.
"""

import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from fem_tpu_torch import sim
from fem_tpu_torch.pipeline import cli

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def records(*paths) -> set:
    out = set()
    for path in paths:
        with open(path, "rb") as f:
            out |= {line for line in f if not line.startswith(b"@")}
    return out


def counters(stderr: str) -> list:
    found = re.findall(r"^The number of [^:]*: (\d+)$", stderr, re.M)
    assert len(found) == 5, stderr
    return [int(x) for x in found]


def run_group(argv: list, out: str, n: int = 2, extra=lambda host: []) -> list:
    """`python -m fem_tpu_torch map` as processes 0 .. n-1 of one process
    group on a free local port; returns their stderr, after asserting each
    exited 0."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fem_tpu_torch", *argv, "-o", out, "--num-hosts", str(n),
         "--host-id", str(h), "--coordinator", f"127.0.0.1:{port}", *extra(h)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for h in range(n)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    return errs


def map_argv(d, batch=64) -> list:
    return ["map", "-e", "2", "-a", "1", "--ref", str(d / "ref.fa"), "--index",
            str(d / "ref.index"), "--read1", str(d / "reads.fq"), "--batch-size", str(batch),
            "--device", "cpu"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mh")
    seqs = sim.random_genome(150_000, num_seqs=2, seed=11)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    sim.write_fastq(str(d / "reads.fq"),
                    sim.simulate_reads(seqs, 300, read_length=100, max_errors=2, seed=12))
    assert cli.main(["index", "12", "3", str(d / "ref.fa"), str(d / "ref.index")]) == 0
    return d


@pytest.fixture(scope="module")
def single(workdir):
    """The single-process run: its SAM path and its counters."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert cli.main(map_argv(workdir) + ["-o", str(workdir / "single.sam")]) == 0
    return str(workdir / "single.sam"), counters(buf.getvalue())


def test_two_processes_independent_equal_single(workdir, single):
    out = str(workdir / "multi.sam")
    errs = run_group(map_argv(workdir), out)
    r0, r1 = records(out + ".host0000"), records(out + ".host0001")
    assert r0 and r1, "both processes map reads"
    assert r0 | r1 == records(single[0]) and not (r0 & r1)
    assert counters(errs[0]) == single[1]  # summed over the group by host 0
    assert "[dist] rank 0 of 2: backend gloo (grid entries on the CPU)" in errs[0]
    assert "[dist] rank 1 of 2: backend gloo" in errs[1]


def test_local_data_grid_in_one_process(workdir, single, capsys):
    """--local-devices 2: one process, reads split over two CPU entries."""
    out = str(workdir / "grid.sam")
    assert cli.main(map_argv(workdir) + ["--local-devices", "2", "-o", out]) == 0
    err = capsys.readouterr().err
    assert "[mesh] ('data',) grid 2, 2 cells in this process" in err
    with open(out, "rb") as a, open(single[0], "rb") as b:
        assert a.read() == b.read()
    assert counters(err) == single[1]


def test_global_mesh_checkpoint_rewinds_to_common_position(workdir, single):
    """--index-shards 2 over two processes with --checkpoint; then each
    process 'crashes' at another position (host 0 after its first
    checkpoint, host 1 after its second, both with a garbage tail): the
    resumed run meets at the smaller position and ends byte-equal."""
    d = workdir
    out, ck = str(d / "gm.sam"), str(d / "gm.ckpt")
    argv = map_argv(d) + ["--index-shards", "2", "--local-devices", "2", "--checkpoint", ck]
    errs = run_group(argv, out)
    shards = [f"{out}.host{h:04d}" for h in range(2)]
    full = []
    for path in shards:
        with open(path, "rb") as f:
            full.append(f.read())
    assert records(*shards) == records(single[0])
    assert counters(errs[0]) == single[1]
    hist = []
    for h in range(2):
        with open(f"{ck}.host{h:04d}") as f:
            hist.append([tuple(map(int, line.split())) for line in f if line.strip()])
    assert [r for r, _ in hist[0]] == [64, 128, 192, 256, 300] == [r for r, _ in hist[1]]
    for h, keep in ((0, 1), (1, 2)):
        with open(f"{ck}.host{h:04d}", "w") as f:
            f.writelines(f"{r} {b}\n" for r, b in hist[h][:keep])
        with open(shards[h], "wb") as f:
            f.write(full[h][: hist[h][keep - 1][1]] + b"r999\tGARBAGE-PARTIAL")
    errs = run_group(argv, out)
    assert all("Resuming after 64 reads." in e for e in errs), errs
    for h in range(2):
        with open(shards[h], "rb") as f:
            assert f.read() == full[h]
