"""Test-only bridges from the JAX package's state to the port's: a fem_tpu
EngineConfig's fields as the port's EngineConfig, and a fem_tpu
DeviceIndex's or ShardedIndex's arrays as the port's DeviceIndex. The
tests hold the port against fem_tpu on the CPU through them; the port
itself never reads JAX state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fem_tpu_torch.ops.types import DeviceIndex, _device_index, device_index_shard
from fem_tpu_torch.parallel.mesh import make_index_mesh, make_mesh
from fem_tpu_torch.pipeline.engine import EngineConfig, TierConfig


def engine_config_from_jax(fields: dict, device: torch.device | str = "cuda") -> EngineConfig:
    """The port's EngineConfig from a fem_tpu EngineConfig given as plain
    values (`dataclasses.asdict`, or the fields as they are), its
    TierConfigs included. A JAX mesh (`mesh`, `index_mesh`, or its shape)
    comes across as a grid of the same shape, (n_dp,) or (n_dp, n_ip),
    whose every entry is `device`. The fields the port does not have
    (cap_vote, aggregate_fetch, use_pallas, serialize_dispatch) are dropped."""

    def keep(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in names}

    def shape(m):  # a jax Mesh (its .shape maps axis -> size) or a shape
        return tuple(m.shape.values()) if hasattr(m, "shape") else tuple(m)

    kept = keep(EngineConfig, fields)
    if kept.get("tiers") is not None:
        kept["tiers"] = tuple(
            TierConfig(**keep(TierConfig, t if isinstance(t, dict) else dataclasses.asdict(t)))
            for t in kept["tiers"])
    if kept.get("mesh") is not None:
        (n,) = shape(kept["mesh"])
        kept["mesh"] = make_mesh([device] * n)
    if kept.get("index_mesh") is not None:
        n_dp, n_ip = shape(kept["index_mesh"])
        kept["index_mesh"] = make_index_mesh([device] * (n_dp * n_ip), n_ip)
    return EngineConfig(**kept)


def _pairs_to_occ(pairs: np.ndarray) -> np.ndarray:
    pairs = pairs.astype(np.uint64)
    return (pairs[:, 0] << np.uint64(32)) | pairs[:, 1]


def device_index_from_jax(arrays: dict, device: torch.device | str) -> DeviceIndex:
    """The port's index from the fields of a fem_tpu DeviceIndex, given as
    numpy arrays (``occ_rows``, ``ref_rows``, ``csr_rows``, ``ref_offsets``,
    ``ref_lengths``, ``num_occurrences``): the state carried across.

    ``occ_rows`` holds (sid, pos) u32 pairs in CSR order; ``ref_rows`` holds
    the flat codes padded to 64-byte rows, cut here back to the flat layout
    (the trailing gap equals the leading one, ``ref_offsets[0]``)."""
    n = int(arrays["num_occurrences"])
    occ = _pairs_to_occ(np.asarray(arrays["occ_rows"]).reshape(-1, 2)[:n])
    csr = np.asarray(arrays["csr_rows"])
    lookup = np.concatenate([csr[:, 0], csr[-1:, 1]])
    offsets = np.asarray(arrays["ref_offsets"]).astype(np.int64)
    lengths = np.asarray(arrays["ref_lengths"]).astype(np.int64)
    total = int(offsets[-1] + lengths[-1] + offsets[0])
    flat = np.asarray(arrays["ref_rows"]).view(np.uint8).reshape(-1)[:total]
    return _device_index(occ, lookup, flat, offsets, lengths, device)


def device_index_from_jax_shard(arrays: dict, shard: int, device: torch.device | str) -> DeviceIndex:
    """Shard `shard` of a fem_tpu ShardedIndex, given as numpy arrays of its
    fields (``lookup``, ``occ_rows``, ``ref_flat``, ``ref_offsets``,
    ``own_start``, ``own_end``, ``halo_lo``, ``freq_table``,
    ``num_occurrences``, ``ref_lengths``): the same shard in the port's
    layout. ``occ_rows`` holds the shard's (sid, pos) u32 pairs in CSR
    order, as many as its local lookup counts; ``ref_flat`` is kept whole
    (its tail past the slice is sentinel code 4)."""
    lookup = np.asarray(arrays["lookup"])[shard]
    n = int(lookup[-1])
    pairs = np.asarray(arrays["occ_rows"])[shard].reshape(-1, 2)[:n]
    return device_index_shard(
        _pairs_to_occ(pairs), lookup, np.asarray(arrays["ref_flat"])[shard],
        np.asarray(arrays["ref_offsets"])[shard], np.asarray(arrays["own_start"])[shard],
        np.asarray(arrays["own_end"])[shard], np.asarray(arrays["halo_lo"])[shard],
        arrays["freq_table"], int(arrays["num_occurrences"]), arrays["ref_lengths"],
        device,
    )
