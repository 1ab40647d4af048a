"""Aux subsystems of the port's CLI (mirrors tests/test_cli_aux.py): stats
JSON, checkpoint/resume, the crash-tail truncation, the checkpoint's byte
offset on disk, and `-t N` worker processes. The device engine runs with
`--device cpu`; every comparison is exact.
"""

import json
import os

import pytest
import torch

from fem_tpu.io import sam as jsam
from fem_tpu.pipeline import cli as jcli
from fem_tpu_torch import sim
from fem_tpu_torch.io import sam as tsam
from fem_tpu_torch.pipeline import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_aux")
    seqs = sim.random_genome(120_000, num_seqs=1, seed=15)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    reads = sim.simulate_reads(seqs, 90, read_length=100, max_errors=1, seed=16)
    sim.write_fastq(str(d / "reads.fq"), reads)
    assert cli.main(["index", "12", "3", str(d / "ref.fa"), str(d / "ref.index")]) == 0
    base = ["map", "-e", "1", "-a", "1", "--ref", str(d / "ref.fa"),
            "--index", str(d / "ref.index"), "--read1", str(d / "reads.fq"),
            "--batch-size", "30", "--device", "cpu"]
    assert cli.main(base + ["-o", str(d / "full.sam")]) == 0
    return d, reads, base


@pytest.fixture
def child_env(monkeypatch):
    """Worker processes: one thread each (tier-1 runs several test workers)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _records(sam: bytes) -> list[bytes]:
    return sorted(line for line in sam.split(b"\n") if line and not line.startswith(b"@"))


def test_stats_json_and_checkpoint_resume(files, tmp_path, monkeypatch):
    d, reads, base = files
    full = (d / "full.sam").read_bytes()
    assert cli.main(base + ["-o", str(tmp_path / "s.sam"),
                            "--stats-json", str(tmp_path / "stats.json")]) == 0
    assert (tmp_path / "s.sam").read_bytes() == full
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["mapping_stats"]["num_reads"] == 90
    assert stats["reads"] == 90 and stats["num_batches"] == 3
    assert stats["reads_per_s"] > 0

    # The JAX CLI's stats file carries the same keys (but shadow-warm's
    # and its two per-stage wall clocks) and the same counters.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    jbase = [a for a in base if a not in ("--device", "cpu")]
    assert jcli.main(jbase + ["-o", str(tmp_path / "j.sam"), "--engine", "golden",
                              "--stats-json", str(tmp_path / "j.json")]) == 0
    jstats = json.loads((tmp_path / "j.json").read_text())
    assert set(jstats) - {"shadow_reads", "wall_submit_s", "wall_drain_s"} == set(stats)
    assert jstats["mapping_stats"] == stats["mapping_stats"]
    assert jstats["reads"] == stats["reads"]
    assert (tmp_path / "j.sam").read_bytes() == full

    # An interrupted run: checkpoint after 60 reads (legacy format, no byte
    # offset), the partial SAM holding the first 60 reads' output.
    ckpt = tmp_path / "progress"
    ckpt.write_text("60")
    sim.write_fastq(str(tmp_path / "first60.fq"), reads[:60])
    first = [a if a != str(d / "reads.fq") else str(tmp_path / "first60.fq") for a in base]
    assert cli.main(first + ["-o", str(tmp_path / "resume.sam")]) == 0
    assert cli.main(base + ["-o", str(tmp_path / "resume.sam"),
                            "--checkpoint", str(ckpt)]) == 0
    assert (tmp_path / "resume.sam").read_bytes() == full
    hist = [line.split() for line in ckpt.read_text().splitlines()]
    assert hist[-1][0] == "90"
    assert int(hist[-1][1]) == len(full)


def test_checkpoint_truncates_crash_tail(files, tmp_path):
    """Records written after the last checkpoint (the crash window) must
    not duplicate on resume: resume truncates to the checkpointed byte
    offset before re-mapping."""
    d, _, base = files
    full = (d / "full.sam").read_bytes()
    ckpt = tmp_path / "progress"
    assert cli.main(base + ["-o", str(tmp_path / "c.sam"), "--checkpoint", str(ckpt)]) == 0
    assert (tmp_path / "c.sam").read_bytes() == full
    hist = [line.split() for line in ckpt.read_text().splitlines()]
    assert [int(h[0]) for h in hist] == [30, 60, 90]
    reads30, bytes30 = int(hist[0][0]), int(hist[0][1])
    ckpt.write_text(f"{reads30} {bytes30}\n")
    with open(tmp_path / "crash.sam", "wb") as f:
        f.write(full[:bytes30])
        f.write(b"read999\tGARBAGE-PARTIAL-RECORD")
    assert cli.main(base + ["-o", str(tmp_path / "crash.sam"),
                            "--checkpoint", str(ckpt)]) == 0
    assert (tmp_path / "crash.sam").read_bytes() == full


def test_every_checkpoint_offset_is_on_disk(files, tmp_path, monkeypatch):
    """At each checkpoint write the SAM file's size on disk is the offset
    the checkpoint records, so a process killed right after it resumes
    from bytes that are in the file (a fresh run and a resumed one)."""
    d, _, base = files
    full = (d / "full.sam").read_bytes()
    # Batches of 10 reads: each batch's records are fewer bytes than the
    # file object's buffer holds.
    base = [a if a != "30" else "10" for a in base]
    out = tmp_path / "k.sam"
    seen = []
    write = cli._write_checkpoint

    def checked(path, hist):
        seen.append((hist[-1], os.path.getsize(out)))
        write(path, hist)

    monkeypatch.setattr(cli, "_write_checkpoint", checked)
    ckpt = tmp_path / "progress"
    assert cli.main(base + ["-o", str(out), "--checkpoint", str(ckpt)]) == 0
    ckpt.write_text(f"{seen[0][0][0]} {seen[0][0][1]}\n")
    assert cli.main(base + ["-o", str(out), "--checkpoint", str(ckpt)]) == 0
    assert out.read_bytes() == full
    assert [reads for (reads, _), _ in seen] == [*range(10, 91, 10), *range(20, 91, 10)]
    for (_, offset), size in seen:
        assert offset == size
        assert full[:offset].endswith(b"\n")


def test_sam_writer_tell_is_on_disk_and_records_equal_jax(tmp_path):
    """The port's SamWriter flushes its file at tell(); its header and the
    record formatter are fem_tpu's byte for byte."""
    names, lengths = [b"chr1", b"chr2"], [1000, 2000]
    rec_args = dict(qname=b"r1", flag=16, rname=b"chr1", pos0=41,
                    cigar=tsam.cigar_to_bytes([(0, 10), (1, 2), (2, 1), (0, 88)]),
                    seq=b"ACGTNRYacgtu", qual=b"IIIIIIIIIIII", edit_distance=3,
                    md=b"10^A88")
    for secondary in (False, True):
        assert tsam.format_record(**rec_args, secondary=secondary) == jsam.format_record(
            **rec_args, secondary=secondary)
    assert tsam.canonicalize_seq(b"ACGTNRYKMacgtuU.-*") == jsam.canonicalize_seq(
        b"ACGTNRYKMacgtuU.-*")
    record = tsam.format_record(**rec_args, secondary=False)
    with tsam.SamWriter(str(tmp_path / "t.sam"), names, lengths) as w, \
            jsam.SamWriter(str(tmp_path / "j.sam"), names, lengths) as jw:
        w.write_record(record)
        jw.write_record(record)
        offset = w.tell()
        assert offset == os.path.getsize(tmp_path / "t.sam") > len(record)
    assert (tmp_path / "t.sam").read_bytes() == (tmp_path / "j.sam").read_bytes()


def test_t2_workers_equal_t1(files, tmp_path, child_env, capsys):
    """`-t 2` fans out to two `python -m fem_tpu_torch map` processes (the
    device flag passed on): the -t 1 record multiset, summed counters and a
    merged --stats-json."""
    d, _, base = files
    full = (d / "full.sam").read_bytes()
    assert cli.main(base + ["-t", "2", "-o", str(tmp_path / "t2.sam"),
                            "--stats-json", str(tmp_path / "t2.json")]) == 0
    err = capsys.readouterr().err
    t2 = (tmp_path / "t2.sam").read_bytes()
    assert _records(t2) == _records(full) and len(_records(full)) > 80
    assert t2.startswith(b"@SQ\t") and t2.count(b"@SQ") == 1
    assert not list(tmp_path.glob("t2.sam.host*"))
    merged = json.loads((tmp_path / "t2.json").read_text())["mapping_stats"]
    assert merged["num_reads"] == 90
    assert cli.main(base + ["-o", str(tmp_path / "t1.sam"),
                            "--stats-json", str(tmp_path / "t1.json")]) == 0
    err1 = capsys.readouterr().err
    assert merged == json.loads((tmp_path / "t1.json").read_text())["mapping_stats"]
    counters = lambda e: [l for l in e.splitlines() if l.startswith("The number of")]
    assert counters(err) == counters(err1) and len(counters(err)) == 5


def test_worker_failure_is_not_swallowed(files, tmp_path, child_env, capsys):
    """Workers inherit --device: asked for the card where there is none,
    each raises, and the parent prints a worker's error and exits with its
    code."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, _, base = files
    argv = [a for a in base if a not in ("--device", "cpu")]
    rc = cli.main(argv + ["-t", "2", "--device", "cuda", "-o", str(tmp_path / "f.sam")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "CUDA is not available" in err
    assert "The number of read" not in err
