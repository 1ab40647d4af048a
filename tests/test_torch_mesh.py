"""The port's data-parallel grid (fem_tpu_torch/parallel/mesh.py) against
fem_tpu's mesh (tests/test_mesh.py): grids of CPU entries, records and
counters equal to the golden oracle whatever the grid, and the lanes each
cell's accepted hits carry, globalized over the batch by the JAX package's
rule, equal to fem_tpu/parallel/mesh.py's on the same reads."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.ops.types import FilterParams as JFilterParams, device_index_from_host as jindex
from fem_tpu.parallel import mesh as jmesh
from fem_tpu.pipeline.engine import unpack_outputs
from fem_tpu_torch.ops.step import pack_input, pack_result, unpack_result
from fem_tpu_torch.ops.types import FilterParams, device_index_from_host
from fem_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, make_sharded_map_fn
from fem_tpu_torch.pipeline.engine import EngineConfig, MappingEngine
from tests.test_engine import _batch_from_reads

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_data_grid_matches_golden(small_reference, small_index, default_args, n_devices):
    seqs, ref = small_reference
    engine = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=64, cap_occ=256, cap_cand=128, verify_per_read=32,
                     mesh=make_mesh(["cpu"] * n_devices)),
        device="cpu",
    )
    assert engine._mesh_shape() == (n_devices, 1)
    assert len({id(x) for x in engine._cell_index.values()}) == 1  # one index a device
    reads = sim.simulate_reads(seqs, 64, read_length=100, max_errors=2, seed=41)
    batch = _batch_from_reads(reads)
    recs, stats = engine.map_batch(batch)
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)
    # A batch that does not fill the grid's rows evenly: padded with empty reads.
    part = _batch_from_reads(reads[:61])
    recs, stats = engine.map_batch(part)
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        part.names, part.seqs, part.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)


def test_grid_checks():
    with pytest.raises(ValueError, match="divisible"):
        from fem_tpu_torch.parallel.mesh import make_index_mesh

        make_index_mesh(["cpu"] * 3, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(["cuda:0", "cuda:0"])
    grid = make_mesh(["cpu", "cpu"])
    assert grid.shape == {"data": 2} and grid.grid.shape == (2, 1)
    assert [c[:2] for c in grid.local_cells()] == [(0, 0), (1, 0)]
    assert not grid.crosses_processes
    other = DeviceMesh(grid.devices.copy(), ("data",), owners=np.array([0, 1]), rank=0)
    assert other.crosses_processes
    with pytest.raises(ValueError, match="cross-host pure data parallelism"):
        make_sharded_map_fn(other, None, 8, 8)


def test_lane_globalization_equals_jax_mesh(small_reference, small_index, default_args):
    """Two cells, 16 reads each: the port's segments and fem_tpu's
    shard_map segments hold the same accepted hits under the same global
    lanes, strand * (n * Bloc) + shard * Bloc + (l - strand * Bloc)."""
    seqs, ref = small_reference
    n, B, Lmax = 2, 32, 128
    reads = sim.simulate_reads(seqs, B, read_length=100, max_errors=2, seed=43)
    batch = _batch_from_reads(reads)
    verify_cap, accept_cap = 512, 64  # per cell
    jparams = JFilterParams.from_args(default_args, Lmax, cap_occ=256, cap_cand=128,
                                      cap_vote=256)
    fn = jmesh.make_sharded_map_fn(jmesh.make_mesh(jax.devices()[:n]), jparams, verify_cap,
                                   False, accept_cap=accept_cap)
    packed = np.empty((B, Lmax + 4), np.uint8)
    packed[:, :Lmax] = batch.codes
    packed[:, Lmax:] = batch.lengths.astype("<i4").view(np.uint8).reshape(B, 4)
    want = unpack_outputs(np.asarray(fn(jindex(small_index, ref), jnp.asarray(packed))),
                          accept_cap, 2 * B // n, n)

    tparams = FilterParams.from_args(default_args, Lmax, cap_occ=256, cap_cand=128)
    grid = make_mesh(["cpu"] * n)
    index = device_index_from_host(small_index, ref, "cpu")
    Bloc = B // n
    rows = {(d, torch.device("cpu")): pack_input(batch.codes[d * Bloc : (d + 1) * Bloc],
                                                 batch.lengths[d * Bloc : (d + 1) * Bloc], Bloc)
            for d in range(n)}
    outs = make_sharded_map_fn(grid, tparams, verify_cap, accept_cap).run(
        {(d, 0): index for d in range(n)}, rows, streams={})
    got = unpack_result(torch.cat([pack_result(o) for o in outs]).numpy(), accept_cap, B // n, n)
    np.testing.assert_array_equal(got["n_accepted"], want["n_accepted"])
    assert (got["n_accepted"] > 0).all()
    for s in range(n):
        k = int(got["n_accepted"][s])
        cut = slice(s * accept_cap, s * accept_cap + k)
        for f in ("a_lane", "a_sid", "a_pos", "a_ed", "a_end"):
            np.testing.assert_array_equal(got[f][cut], want[f][cut], err_msg=f)
        lanes = got["a_lane"][cut]
        # Shard s holds reads [s * 16, s * 16 + 16) of each strand half.
        assert (lanes % B // (B // n) == s).all() and (lanes >= B).any()
    np.testing.assert_array_equal(got["fb"], want["fb"].reshape(-1))


def test_engine_config_from_jax_carries_grid_shapes(small_reference, small_index, default_args):
    """fem_tpu's EngineConfig with a mesh or an index_mesh (its fields as
    they are: a JAX Mesh does not deep-copy) comes across as a grid of the
    same shape whose every entry is the given device."""
    from jax.sharding import Mesh

    from fem_tpu.pipeline import engine as jengine
    from fem_tpu_torch.pipeline.engine import TierConfig
    from tests.torch_bridges import engine_config_from_jax

    jcfg = jengine.EngineConfig(batch_size=32, mesh=jmesh.make_mesh(jax.devices()[:4]))
    got = engine_config_from_jax(vars(jcfg), device="cpu")
    assert got.mesh.shape == {"data": 4} and got.index_mesh is None
    assert list(got.mesh.devices) == [torch.device("cpu")] * 4
    rung = dict(batch_size=16, cap_occ=64, cap_cand=64, verify_per_read=16, accept_per_read=8)
    jcfg = jengine.EngineConfig(
        batch_size=32, tiers=(jengine.TierConfig(**rung),),
        index_mesh=Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "index")))
    got = engine_config_from_jax(vars(jcfg), device="cpu")
    assert got.index_mesh.shape == {"data": 2, "index": 2} and got.mesh is None
    assert got.tiers == (TierConfig(**rung),)
    seqs, ref = small_reference
    batch = _batch_from_reads(sim.simulate_reads(seqs, 32, read_length=100, seed=44))
    recs, stats = MappingEngine(default_args, ref, small_index, got, device="cpu").map_batch(batch)
    grecs, gstats = GoldenMapper(default_args, ref, small_index).map_reads(
        batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(gstats)


def test_parallel_does_not_import_pipeline():
    """The layers import one way, pipeline/ -> parallel/ -> ops/: every
    module under fem_tpu_torch/parallel/ and fem_tpu_torch/ops/ imports,
    in a fresh interpreter, without loading fem_tpu_torch.pipeline."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fem_tpu_torch.ops, fem_tpu_torch.parallel\n"
        "import fem_tpu_torch.parallel.mesh, fem_tpu_torch.parallel.sharded_index\n"
        "for pkg in (fem_tpu_torch.ops, fem_tpu_torch.parallel):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "assert 'fem_tpu_torch.parallel.multihost' in sys.modules\n"
        "print(sorted(m for m in sys.modules if m.startswith('fem_tpu_torch.pipeline')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=_REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]", proc.stdout
