"""ctypes wrapper for the native FASTQ batch reader
(fem_tpu/native/reader.py). The library builds on first use; a failed
build raises with the compiler's error."""

from __future__ import annotations

import ctypes
from typing import Iterator

import numpy as np
import torch

from fem_tpu_torch.native.build import native_library


def _native():
    """The native library with this module's entry points typed."""
    lib = native_library()
    lib.fem_fastq_open.restype = ctypes.c_void_p
    lib.fem_fastq_open.argtypes = [ctypes.c_char_p]
    lib.fem_fastq_close.argtypes = [ctypes.c_void_p]
    lib.fem_fastq_next_batch.restype = ctypes.c_int64
    lib.fem_fastq_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p,  # codes
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # names blob/cap/off
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # seqs blob/cap/off
        ctypes.c_void_p,  # quals blob
    ]
    return lib


class NativeReadError(Exception):
    """Native parse gave up (over-long read / capacity / malformed input);
    callers restart the stream with the Python parser."""


def stream_fastq_batches_native(
    path: str,
    batch_size: int,
    max_read_length: int = 508,
    pad_to_multiple: int = 32,
) -> Iterator:
    """Yield ReadBatch objects with blobs + a trimmed packed upload buffer
    (a uint8 tensor).
    Raises NativeReadError (possibly mid-stream) when the file needs the
    Python parser instead."""
    from fem_tpu_torch.io.fastx import ReadBatch

    lib = _native()
    h = lib.fem_fastq_open(path.encode())
    if not h:
        raise NativeReadError(f"cannot open {path}")
    row = max_read_length + 4
    names_cap = batch_size * 256
    seqs_cap = batch_size * (max_read_length + 1)
    try:
        while True:
            codes = np.full((batch_size, row), 4, np.uint8)
            names_blob = np.empty(names_cap, np.uint8)
            name_offsets = np.zeros(batch_size + 1, np.int64)
            seqs_blob = np.empty(seqs_cap, np.uint8)
            seq_offsets = np.zeros(batch_size + 1, np.int64)
            quals_blob = np.empty(seqs_cap, np.uint8)
            vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
            n = lib.fem_fastq_next_batch(
                h, batch_size, max_read_length,
                vp(codes),
                vp(names_blob), names_cap, vp(name_offsets),
                vp(seqs_blob), seqs_cap, vp(seq_offsets),
                vp(quals_blob),
            )
            if n < 0:
                raise NativeReadError(f"native FASTQ parse error {n} in {path}")
            if n == 0:
                return
            lengths = np.diff(seq_offsets[: n + 1]).astype(np.int32)
            lmax = int(lengths.max())
            lmax = max(-(-lmax // pad_to_multiple) * pad_to_multiple, pad_to_multiple)
            # Trim the packed buffer to this batch's padded length; unused
            # rows keep zero length bytes. Where a card is present it lies in
            # pinned memory, from which the engine uploads it as it is.
            upload = torch.empty((batch_size, lmax + 4), dtype=torch.uint8,
                                 pin_memory=torch.cuda.is_available())
            packed = upload.numpy()
            packed[:, :lmax] = codes[:, :lmax]
            packed[:n, lmax:] = codes[:n, max_read_length:]
            packed[n:, lmax:] = 0
            yield ReadBatch(
                codes=packed[:n, :lmax],
                lengths=lengths,
                packed=upload,
                names_blob=names_blob[: name_offsets[n]].tobytes(),
                name_offsets=name_offsets,
                seqs_blob=seqs_blob[: seq_offsets[n]].tobytes(),
                seq_offsets=seq_offsets,
                quals_blob=quals_blob[: seq_offsets[n]].tobytes(),
                num_reads=int(n),
            )
            if n < batch_size:
                return
    finally:
        lib.fem_fastq_close(h)
