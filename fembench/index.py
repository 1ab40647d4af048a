"""The FEM index of the benchmark's genome, built with torch on the card.

In a deployment the index is an input: `FEM index` builds it once and
every `map` loads it. The program's own builder
(fem_tpu_torch/index/build.py) is one numpy thread, about 107 s at 3.0 Gb,
which every run would pay; this builder gives the same fields in seconds:

  lookup       u32[4^k + 1] CSR offsets: bucket h holds
               occurrences[lookup[h] : lookup[h + 1]];
  occurrences  u64 seqid << 32 | position of every `step`-th k-mer window
               (while the window fits), ambiguous bases hashed as A,
               ascending within a bucket (FEM's src/index.c:57-98).

Windows are numbered in (seqid, position) order; a stable sort of their
hashes orders them by bucket and, within one, by window number, which is
FEM's file order. fembench/tests/test_fembench_inputs.py holds it field-
equal to the program's builder.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

_CHUNK = 1 << 26


def _codes(seq: bytes, device) -> torch.Tensor:
    """A sequence's hashing codes on `device`: A/C/G/T (either case) 0..3,
    anything else 0, as FEM hashes it (src/utils.h:83-99)."""
    table = np.zeros(256, np.uint8)
    for c, v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
        table[c] = v
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a read-only view of the bytes
        chars = torch.from_numpy(np.frombuffer(seq, np.uint8)).to(device)
    return torch.from_numpy(table).to(device)[chars.long()]


def build_index(seqs: list, kmer_size: int, step_size: int,
                device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """(lookup u32, occurrences u64) of the genome `seqs` on the host."""
    device = torch.device(device)
    lengths = [len(s) for s in seqs]
    counts = [len(range(0, n - kmer_size + 1, step_size)) if n >= kmer_size else 0
              for n in lengths]
    wstart = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(counts, out=wstart[1:])
    total = int(wstart[-1])
    if total >= 1 << 32:
        raise ValueError(f"{total} windows do not fit FEM's u32 CSR offsets")
    hashes = torch.empty(total, dtype=torch.int32, device=device)
    for sid, (seq, m) in enumerate(zip(seqs, counts)):
        if not m:
            continue
        codes = _codes(seq, device).int()
        span = (m - 1) * step_size + 1
        acc = torch.zeros(m, dtype=torch.int32, device=device)
        for j in range(kmer_size):
            acc = (acc << 2) | codes[j: j + span: step_size]
        hashes[wstart[sid]: wstart[sid] + m] = acc
        del codes, acc
    keys, window = torch.sort(hashes, stable=True)
    del hashes
    buckets = torch.arange((1 << 2 * kmer_size) + 1, dtype=torch.int32, device=device)
    lookup = torch.searchsorted(keys, buckets).cpu().numpy().astype(np.uint32)
    del keys, buckets
    # Window w of seqid s lies at (w - wstart[s]) * step: its occurrence is
    # (s << 32) - wstart[s] * step + w * step.
    ws = torch.from_numpy(wstart).to(device)
    base = (torch.arange(len(seqs), dtype=torch.int64, device=device) << 32) - ws[:-1] * step_size
    occurrences = np.empty(total, np.uint64)
    for lo in range(0, total, _CHUNK):
        w = window[lo: lo + _CHUNK]
        sid = torch.searchsorted(ws[1:], w, right=True)
        occurrences[lo: lo + w.shape[0]] = (base[sid] + w * step_size).cpu().numpy().view(np.uint64)
    return lookup, occurrences
