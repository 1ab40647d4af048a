"""Batched seed hashing and reverse complement (fem_tpu/ops/hashing.py).

hash(i) is the windowed base-4 polynomial of the codes with ambiguous bases
as 0 (src/utils.h:83-99), so a batch hashes with k shifted adds.
"""

from __future__ import annotations

import torch


def reverse_complement(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, Lmax) uint8 codes, (B,) int32 lengths -> per-read reverse
    complement, padding 4 (src/sequence_batch.h:90-98): complement is
    3 ^ code for real bases, ambiguous stays ambiguous."""
    B, Lmax = codes.shape
    pos = torch.arange(Lmax, device=codes.device)
    # Flip the padded row (its pad lands in front), then read each row from
    # its pad width on: one per-row gather.
    src = (pos[None, :] + (Lmax - lengths.long())[:, None]) % Lmax
    x = torch.gather(codes.flip(1), 1, src)
    comp = torch.where(x > 3, 4, 3 ^ x).to(torch.uint8)
    return torch.where(pos[None, :] < lengths[:, None], comp, 4).to(torch.uint8)


def seed_hashes(codes: torch.Tensor, kmer_size: int) -> torch.Tensor:
    """All window hashes: (B, Lmax) uint8 -> (B, Lmax-k+1) int32. Windows
    over padding hash the pad as A; callers mask seeds past each read."""
    B, Lmax = codes.shape
    num = Lmax - kmer_size + 1
    c4 = torch.where(codes > 3, 0, codes).to(torch.int32)
    acc = torch.zeros((B, num), dtype=torch.int32, device=codes.device)
    for j in range(kmer_size):
        acc = (acc << 2) + c4[:, j : j + num]
    return acc


def ambiguous_base_counts(
    codes: torch.Tensor, lengths: torch.Tensor, kmer_size: int
) -> torch.Tensor:
    """Ambiguous bases at positions [k, L-1] per read — the bail-out
    counter of hash_all_seeds_in_sequence (src/utils.h:101-117)."""
    pos = torch.arange(codes.shape[1], device=codes.device)[None, :]
    in_range = (pos >= kmer_size) & (pos < lengths[:, None])
    return (in_range & (codes > 3)).sum(dim=1, dtype=torch.int32)
