"""The benchmark's genome, made from a seed (the configuration's) and its genome
section: the model of tools/torch_grch38_scale.py's `genome` (GRCh38's
chromosome profile, re-inserted segments at a small divergence), driven by
the configuration's lengths and repeat model instead of constants.

Each chromosome is uniform random bases; then segments of a length drawn
from `segment_bp` are copied from a random place to another, one after the
other (a later copy may copy or overwrite an earlier one, as in the tool),
until the copies cover `repeat_share` of the chromosome; each copy has
Binomial(length, `divergence`) of its bases set to a random base. Three
changes from the tool, all for the set-up every run pays: the random bases
come from a torch generator on the run's device, the copies' sizes, places
and changes are drawn in bulk, and the bases become chars on the device.
A 3.0 Gb genome then takes about 8 s with an H100 (its host: 8 cores)
against the tool's 25 s.
"""

from __future__ import annotations

import numpy as np
import torch

CHARS = np.frombuffer(b"ACGT", np.uint8)


def chromosome_lengths(spec: dict) -> np.ndarray:
    """The lengths a genome section states: `lengths_bp` as given, or
    `profile_mb` scaled to `total_bp` (the tool's `chromosome_lengths`)."""
    if "lengths_bp" in spec:
        return np.array(spec["lengths_bp"], np.int64)
    profile = np.array(spec["profile_mb"], np.float64)
    return (profile / profile.sum() * spec["total_bp"]).astype(np.int64)


def make_genome(spec: dict, seed: int, gap: int = 256, device="cpu"):
    """The genome of a configuration's `genome` section for `seed`:
    (names, seqs, flat, offsets). Chromosome i is named `chr<i + 1>` (or
    `names[i]`); `seqs` are its chars; `flat` holds every chromosome's codes
    0..3 at `offsets[i]`, with `gap` code-4 bases before, between and after
    them (the layout of the port's Reference, as its read_fasta makes it).
    The same seed on the same kind of device gives the same genome."""
    lengths = chromosome_lengths(spec)
    names = [n.encode() for n in spec["names"]] if "names" in spec else [
        b"chr%d" % (i + 1) for i in range(len(lengths))]
    share = float(spec["repeat_share"])
    seg_lo, seg_hi = spec["segment_bp"]
    divergence = float(spec["divergence"])
    offsets = gap + np.concatenate([[0], np.cumsum(lengths[:-1] + gap)]).astype(np.int64)
    flat = np.full(int(offsets[-1] + lengths[-1] + gap), 4, np.uint8)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    rng = np.random.default_rng([seed, 1])
    lut = torch.from_numpy(CHARS.copy()).to(device)
    seqs = []
    for off, ln in zip(offsets.tolist(), lengths.tolist()):
        codes = flat[off: off + ln]
        on_dev = torch.randint(0, 4, (ln,), dtype=torch.uint8, generator=gen, device=device)
        codes[:] = on_dev.cpu().numpy()
        target, placed = int(ln * share), 0
        while placed < target:
            n = max(16, 2 * (target - placed) // (seg_lo + seg_hi) + 16)
            seg_len = rng.integers(seg_lo, seg_hi, size=n)
            src = rng.integers(0, np.maximum(ln - seg_len, 1))
            dst = rng.integers(0, np.maximum(ln - seg_len, 1))
            muts = rng.binomial(seg_len, divergence)
            where = np.floor(rng.random(int(muts.sum())) * np.repeat(seg_len, muts)).astype(np.int64)
            bases = rng.integers(0, 4, size=where.size, dtype=np.uint8)
            cut = np.concatenate([[0], np.cumsum(muts)]).tolist()
            for i, (sl, a, b) in enumerate(zip(seg_len.tolist(), src.tolist(), dst.tolist())):
                seg = codes[a: a + sl].copy()
                seg[where[cut[i]: cut[i + 1]]] = bases[cut[i]: cut[i + 1]]
                codes[b: b + seg.shape[0]] = seg
                placed += sl
                if placed >= target:
                    break
        on_dev = torch.from_numpy(codes).to(device)
        seqs.append(lut[on_dev.long()].cpu().numpy().tobytes())
        del on_dev
    return names, seqs, flat, offsets
