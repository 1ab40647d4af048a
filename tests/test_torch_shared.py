"""The port's own copies of the framework-free modules against their
fem_tpu originals, on the same seeded inputs: sim, core.encoding, io.fastx,
io.sam, index, MappingStats, and the native emitter, CPU mapper and reader.
Everything is integers or bytes, so every comparison is exact equality.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import fem_tpu.config as jconfig
import fem_tpu.sim as jsim
from fem_tpu.core import encoding as jenc
from fem_tpu.golden.model import MappingStats as JStats
from fem_tpu.index import build as jbuild
from fem_tpu.index import storage as jstorage
from fem_tpu.io import fastx as jfastx
from fem_tpu.io import sam as jsam
from fem_tpu.native import NativeEmitter as JEmitter
from fem_tpu.native.mapper import NativeCpuMapper as JMapper
from fem_tpu.pipeline import prefetch as jprefetch
import fem_tpu_torch.config as tconfig
import fem_tpu_torch.sim as tsim
from fem_tpu_torch import _build
from fem_tpu_torch.core import encoding as tenc
from fem_tpu_torch.index import build as tbuild
from fem_tpu_torch.index import storage as tstorage
from fem_tpu_torch.io import fastx as tfastx
from fem_tpu_torch.io import sam as tsam
from fem_tpu_torch.native import NativeCpuMapper, NativeEmitter
from fem_tpu_torch.native import build as tnative
from fem_tpu_torch.pipeline import prefetch as tprefetch
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
from fem_tpu_torch.stats import MappingStats

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_arrays(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One genome and one read set, written by each package's sim."""
    out = {}
    for tag, sim in (("j", jsim), ("t", tsim)):
        d = tmp_path_factory.mktemp(f"shared_{tag}")
        seqs = sim.random_genome(60_000, num_seqs=2, seed=11, repeat_fraction=0.2,
                                 n_fraction=0.001)
        reads = sim.simulate_reads(seqs, 300, read_length=100, max_errors=3, seed=12)
        fa, fq = str(d / "ref.fa"), str(d / "reads.fq")
        sim.write_fasta(fa, seqs)
        sim.write_fastq(fq, reads)
        out[tag] = dict(seqs=seqs, reads=reads, fa=fa, fq=fq, dir=d)
    return out


def test_sim_same_genome_reads_and_files(files):
    j, t = files["j"], files["t"]
    assert j["seqs"] == t["seqs"]
    assert [dataclasses.astuple(r) for r in j["reads"]] == [
        dataclasses.astuple(r) for r in t["reads"]]
    for k in ("fa", "fq"):
        with open(j[k], "rb") as a, open(t[k], "rb") as b:
            assert a.read() == b.read()
    sat_j = jsim.satellite_genome(30_000, num_seqs=2, seed=5, satellite_fraction=0.05)
    sat_t = tsim.satellite_genome(30_000, num_seqs=2, seed=5, satellite_fraction=0.05)
    assert sat_j == sat_t


def test_config_same_fields_and_defaults():
    assert dataclasses.asdict(jconfig.FemArgs()) == dataclasses.asdict(tconfig.FemArgs())
    assert [f.name for f in dataclasses.fields(jconfig.FemArgs)] == [
        f.name for f in dataclasses.fields(tconfig.FemArgs)]


def test_core_encoding_equal():
    rng = np.random.default_rng(21)
    raw = bytes(rng.choice(list(b"ACGTNacgtnRYKM-"), 500).astype(np.uint8))
    np.testing.assert_array_equal(jenc.encode(raw), tenc.encode(raw))
    codes = rng.integers(0, 5, 500).astype(np.uint8)
    assert jenc.decode(codes) == tenc.decode(codes)
    np.testing.assert_array_equal(
        jenc.reverse_complement_codes(codes), tenc.reverse_complement_codes(codes))
    np.testing.assert_array_equal(jenc.CHAR_TO_CODE, tenc.CHAR_TO_CODE)
    np.testing.assert_array_equal(jenc.CODE_TO_CHAR, tenc.CODE_TO_CHAR)


def test_fastx_parse_equal(files):
    fa, fq = files["t"]["fa"], files["t"]["fq"]
    rj, rt = jfastx.read_fasta(fa), tfastx.read_fasta(fa)
    assert rj.names == rt.names and rj.seqs == rt.seqs
    _same_arrays(rj, rt, ("lengths", "offsets", "flat_codes"))
    assert list(jfastx.iter_fastx(fq)) == [
        jfastx.FastxRecord(**dataclasses.asdict(r)) for r in tfastx.iter_fastx(fq)]
    for native in (True, False):  # the native reader and the Python parser
        bj = list(jfastx.stream_fastq_batches(fq, batch_size=128, use_native=native))
        bt = list(tfastx.stream_fastq_batches(fq, batch_size=128, use_native=native))
        assert len(bj) == len(bt) == 3
        for a, b in zip(bj, bt):
            assert a.num_reads == b.num_reads
            assert list(a.names) == list(b.names)
            assert list(a.seqs) == list(b.seqs) and list(a.quals) == list(b.quals)
            _same_arrays(a, b, ("codes", "lengths"))


def test_fastx_long_read_takes_python_parser(tmp_path):
    """A read over 508 bp leaves the native reader per record; the stream
    resumes in the Python parser, in both packages alike."""
    rng = np.random.default_rng(31)
    path = str(tmp_path / "long.fq")
    with open(path, "w") as f:
        for i, n in enumerate((100, 100, 600, 90)):
            seq = "".join(rng.choice(list("ACGT"), n))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")
    bj = list(jfastx.stream_fastq_batches(path, batch_size=2))
    bt = list(tfastx.stream_fastq_batches(path, batch_size=2))
    assert [b.num_reads for b in bt] == [b.num_reads for b in bj] == [2, 2]
    for a, b in zip(bj, bt):
        assert list(a.seqs) == list(b.seqs)
        _same_arrays(a, b, ("codes", "lengths"))


def test_sam_header_and_record_equal(files):
    """Header text and strand flag; the records are the native emitter's."""
    ref = tfastx.read_fasta(files["t"]["fa"])
    lens = ref.lengths.tolist()
    assert jsam.sam_header_text(ref.names, lens) == tsam.sam_header_text(ref.names, lens)
    assert jsam.FLAG_REVERSE == tsam.FLAG_REVERSE


def test_index_arrays_equal_and_files_cross_load(files, tmp_path):
    rj = jfastx.read_fasta(files["j"]["fa"])
    rt = tfastx.read_fasta(files["t"]["fa"])
    ij, it = jbuild.build_index(rj, 12, 3), tbuild.build_index(rt, 12, 3)
    fields = ("lookup", "occurrences")
    _same_arrays(ij, it, fields)
    assert (ij.kmer_size, ij.step_size, ij.num_occurrences) == (
        it.kmer_size, it.step_size, it.num_occurrences)
    pj, pt = str(tmp_path / "j.index"), str(tmp_path / "t.index")
    jstorage.save_index(ij, pj)
    tstorage.save_index(it, pt)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    _same_arrays(tstorage.load_index(pj), ij, fields)  # saved by one,
    _same_arrays(jstorage.load_index(pt), it, fields)  # loaded by the other


def test_mapping_stats_fields_and_iadd():
    assert [f.name for f in dataclasses.fields(JStats)] == [
        f.name for f in dataclasses.fields(MappingStats)]
    a, b = MappingStats(1, 2, 3, 4, 5), JStats(1, 2, 3, 4, 5)
    a += MappingStats(10, 20, 30, 40, 50)
    b += JStats(10, 20, 30, 40, 50)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(MappingStats()) == dataclasses.asdict(JStats())


@pytest.mark.parametrize("capacity", [1, 4])
def test_prefetch_same_items_and_errors(capacity):
    """pipeline/prefetch.py: the background source hands over the same
    items in order, and raises the producer's error at the same place."""
    def failing():
        yield from range(5)
        raise ValueError("parse error")

    for mod in (jprefetch, tprefetch):
        assert list(mod.ThreadedBatchSource(range(20), capacity=capacity)) == list(range(20))
        got = []
        with pytest.raises(ValueError, match="parse error"):
            for item in mod.ThreadedBatchSource(failing(), capacity=capacity):
                got.append(item)
        assert got == list(range(5))
    with open(jprefetch.__file__, "rb") as a, open(tprefetch.__file__, "rb") as b:
        assert a.read() == b.read()


def test_native_library_is_the_ports_own():
    """Built from fem_tpu_torch/native/src into build/fem_tpu_torch/, under
    its own name, and that file is the one the wrappers have loaded."""
    lib = tnative.native_library()
    build_dir = os.path.join(_REPO, "build", "fem_tpu_torch")
    assert _build.BUILD_DIR == build_dir
    assert os.path.dirname(lib._name) == build_dir
    assert os.path.basename(lib._name) == "libfem_tpu_torch_native.so"
    assert tnative.SRC_DIR == os.path.join(_REPO, "fem_tpu_torch", "native", "src")
    with open("/proc/self/maps") as f:
        mapped = {line.split()[-1] for line in f if "libfem_tpu_torch_native" in line}
    assert mapped == {lib._name}
    base = tnative.build_baseline()
    assert base == os.path.join(build_dir, "fem_baseline") and os.access(base, os.X_OK)


def test_native_build_error_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _build.compile_to(["g++", str(bad)], str(tmp_path / "out" / "bad"))
    assert not os.path.exists(tmp_path / "out" / "bad")


@pytest.mark.parametrize("name", ["baseline.cpp", "align_core.h", "mapper_core.h",
                                  "emit.cpp", "capi_mapper.cpp", "fastq.cpp",
                                  "tsan_stress.cpp"])
def test_native_sources_are_byte_copies(name):
    """The oracle (baseline.cpp) and the native sources start as exact
    copies, so a later edit of the port's copy is a visible decision."""
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    assert digest(os.path.join(_REPO, "fem_tpu_torch", "native", "src", name)) == digest(
        os.path.join(_REPO, "fem_tpu", "native", "src", name))


def test_native_cpu_mapper_same_records(small_reference, small_index, default_args):
    """Both packages' CPU mappers on the 200 kb fixture."""
    seqs, ref = small_reference
    reads = tsim.simulate_reads(seqs, 120, read_length=100, max_errors=2, seed=77)
    names = [r.name for r in reads]
    rs, qs = [r.seq for r in reads], [r.qual for r in reads]
    blob_j, st_j = JMapper(default_args, ref, small_index).map_reads(names, rs, qs)
    blob_t, st_t = NativeCpuMapper(default_args, ref, small_index).map_reads(names, rs, qs)
    assert blob_j == blob_t and blob_t.count(b"\n") > 100
    np.testing.assert_array_equal(st_j, st_t)


def test_native_emitter_same_records(small_reference, small_index, default_args, tmp_path):
    """The mappings the port's engine hands its emitter, given to fem_tpu's
    emitter too: the same SAM bytes and the same per-read ends."""
    seqs, ref = small_reference
    fq = str(tmp_path / "reads.fq")
    tsim.write_fastq(fq, tsim.simulate_reads(seqs, 96, read_length=100, max_errors=2, seed=78))
    batch = next(tfastx.stream_fastq_batches(fq, batch_size=96))
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=96, cap_occ=80, cap_cand=16,
                                        verify_per_read=8), device="cpu")
    assert isinstance(engine._native, NativeEmitter)
    calls = []
    emit = engine._native.emit
    engine._native.emit = lambda *a, **k: calls.append((a, k)) or emit(*a, **k)
    recs, stats = engine.map_batch(batch)
    assert len(calls) == 1 and stats.num_mappings > 50
    (a, k), theirs = calls[0], JEmitter(ref, default_args.error_threshold)
    assert theirs.emit(*a, **k) == emit(*a, **k)
    blob_j, ends_j = theirs.emit(*a, want_read_ends=True)
    blob_t, ends_t = emit(*a, want_read_ends=True)
    assert blob_j == blob_t and blob_t
    np.testing.assert_array_equal(ends_j, ends_t)
