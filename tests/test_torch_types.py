"""The port's index, parameters and import boundary against fem_tpu."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fem_tpu.config import FemArgs
from fem_tpu.ops import types as jtypes
from fem_tpu_torch.ops import types as ttypes
from tests.torch_bridges import device_index_from_jax

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "e,a,lmax,caps",
    [(2, 1, 128, {}), (5, 1, 128, {"cap_occ": 80, "cap_cand": 16}),
     (0, 0, 96, {"cap_vote": 32}), (7, 2, 256, {"cap_occ": 512})],
)
def test_filter_params_match_jax(e, a, lmax, caps):
    args = FemArgs(error_threshold=e, num_additional_qgrams=a)
    jp = jtypes.FilterParams.from_args(args, lmax, **caps)
    tp = ttypes.FilterParams.from_args(args, lmax, **caps)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    for prop in ("num_qgrams", "seed_span", "max_num_seeds", "max_group_size",
                 "max_dp_cols"):
        assert getattr(jp, prop) == getattr(tp, prop), prop
    assert int(jtypes.SENTINEL_SID) == ttypes.SENTINEL_SID


def test_device_index_from_jax_equals_from_host(small_reference, small_index):
    _, ref = small_reference
    jidx = jtypes.device_index_from_host(small_index, ref)
    arrays = {
        k: np.asarray(getattr(jidx, k))
        for k in ("occ_rows", "ref_rows", "csr_rows", "freq_table",
                  "ref_offsets", "ref_lengths", "num_occurrences")
    }
    got = device_index_from_jax(arrays, "cpu")
    want = ttypes.device_index_from_host(small_index, ref, "cpu")
    assert got.num_occurrences == want.num_occurrences == small_index.num_occurrences
    for f in ("occ", "lookup", "freq_table", "ref_flat", "ref_offsets", "ref_lengths"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    np.testing.assert_array_equal(got.freq_table.numpy(), arrays["freq_table"])
    np.testing.assert_array_equal(
        want.occ.numpy().view(np.uint64), small_index.occurrences
    )
    np.testing.assert_array_equal(want.ref_flat.numpy(), ref.flat_codes)


def test_port_imports_without_jax(tmp_path):
    """The port stands on its own files: import its engine, kernel loader
    and chip_smoke, map a few reads on the CPU through the port's modules
    only, and find neither jax nor fem_tpu among the loaded modules."""
    code = (
        "import sys\n"
        "import fem_tpu_torch.pipeline.engine, fem_tpu_torch.kernels\n"
        "import fem_tpu_torch.parallel.mesh, fem_tpu_torch.parallel.sharded_index\n"
        "import fem_tpu_torch.parallel.multihost, fem_tpu_torch.pipeline.cli\n"
        "import chip_smoke\n"
        "from fem_tpu_torch import sim\n"
        "from fem_tpu_torch.config import FemArgs\n"
        "from fem_tpu_torch.index.build import build_index\n"
        "from fem_tpu_torch.io import fastx\n"
        "from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine\n"
        "seqs = sim.random_genome(20_000, num_seqs=1, seed=3)\n"
        "sim.write_fasta('ref.fa', seqs)\n"
        "sim.write_fastq('reads.fq', sim.simulate_reads(seqs, 16, max_errors=2, seed=4))\n"
        "ref = fastx.read_fasta('ref.fa')\n"
        "engine = MappingEngine(FemArgs(), ref, build_index(ref, 12, 3),\n"
        "                       EngineConfig(batch_size=16), device='cpu')\n"
        "recs, stats = engine.map_batch(next(fastx.stream_fastq_batches('reads.fq', 16)))\n"
        "assert stats.num_reads == 16 and stats.num_mapped_reads > 0, stats\n"
        "from fem_tpu_torch.parallel.mesh import make_index_mesh\n"
        "grid = make_index_mesh(['cpu'] * 2, 2)\n"
        "engine = MappingEngine(FemArgs(), ref, build_index(ref, 12, 3),\n"
        "                       EngineConfig(batch_size=16, index_mesh=grid), device='cpu')\n"
        "recs2, stats2 = engine.map_batch(next(fastx.stream_fastq_batches('reads.fq', 16)))\n"
        "assert b''.join(recs2) == b''.join(recs) and stats2 == stats, stats2\n"
        "bad = [m for m in sys.modules if m in ('jax', 'fem_tpu')"
        " or m.startswith(('jax.', 'fem_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_name_no_fem_tpu_import():
    """No file of the port, not chip_smoke.py and no tools/torch_*.py
    imports fem_tpu or jax (comments that cite fem_tpu/...:line as the
    counterpart are fine)."""
    import glob
    import re

    pat = re.compile(r"^\s*(from|import)\s+(fem_tpu|jax)(\.|\s|$)", re.M)
    files = [os.path.join(_REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(_REPO, "tools", "torch_*.py"))
    for root, _, names in os.walk(os.path.join(_REPO, "fem_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    parallel = os.path.join(_REPO, "fem_tpu_torch", "parallel")
    for name in ("mesh.py", "sharded_index.py", "multihost.py"):
        assert os.path.join(parallel, name) in files, name
    for name in ("torch_soak.py", "torch_tail_bench.py", "torch_grch38_scale.py"):
        assert os.path.join(_REPO, "tools", name) in files, name
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


def test_engine_device_defaults_to_cuda():
    import inspect

    from fem_tpu_torch.pipeline.engine import MappingEngine

    assert inspect.signature(MappingEngine).parameters["device"].default == "cuda"


def test_cuda_request_raises_without_cuda(small_reference, small_index, default_args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from fem_tpu_torch.pipeline.engine import MappingEngine

    _, ref = small_reference
    with pytest.raises(RuntimeError, match="CUDA"):
        MappingEngine(default_args, ref, small_index, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        MappingEngine(default_args, ref, small_index)  # the default is the card
    with pytest.raises((RuntimeError, AssertionError)):
        ttypes.device_index_from_host(small_index, ref, "cuda")


# A k=1 CSR whose last offsets lie in [2^31, 2^32): an index of up to
# 2^32 - 1 occurrences (the u32 offsets of the index file, which
# index.build.check_u32_csr admits). Every bucket stays under 2^31, as a
# bucket of a real index does (at most genome length / step occurrences).
_HIGH_LOOKUP = np.array([0, 2**30, 2**31 - 1, 2**31 + 2**30, 2**32 - 1], np.uint32)


@pytest.mark.parametrize("as_shard", [False, True], ids=["whole", "shard"])
def test_lookup_offsets_above_2_31_read_back_exactly(small_reference, as_shard):
    """The device lookup holds CSR offsets past 2^31 exactly, whole and as
    one shard; an int32 lookup would wrap them negative and the
    candidates' occurrence gather would read the wrong rows."""
    from fem_tpu_torch.index.storage import FemIndex

    _, ref = small_reference
    occ = np.arange(8, dtype=np.uint64)  # placement never reads past its own table
    if as_shard:
        got = ttypes.device_index_shard(
            occ, _HIGH_LOOKUP, ref.flat_codes, ref.offsets,
            np.zeros(ref.num_seqs, np.int32), ref.lengths.astype(np.int32),
            np.full(ref.num_seqs, 2**30, np.int32),
            np.diff(_HIGH_LOOKUP.astype(np.int64)).astype(np.int32), 2**32 - 1,
            ref.lengths, "cpu")
    else:
        got = ttypes.device_index_from_host(FemIndex(1, 1, _HIGH_LOOKUP, occ), ref, "cpu")
    assert got.lookup.dtype == torch.int64
    np.testing.assert_array_equal(got.lookup.numpy(), _HIGH_LOOKUP.astype(np.int64))
    assert int(got.lookup[-1]) == 2**32 - 1 and int(got.lookup.min()) == 0
    assert got.freq_table.dtype == torch.int32
    np.testing.assert_array_equal(got.freq_table.numpy(), np.diff(_HIGH_LOOKUP.astype(np.int64)))
    # What candidates_front reads: the run start and length of a bucket.
    h = torch.tensor([2, 3])
    assert got.lookup[h].long().tolist() == [2**31 - 1, 2**31 + 2**30]
    assert (got.lookup[h + 1].long() - got.lookup[h].long()).tolist() == [2**30 + 1, 2**30 - 1]
