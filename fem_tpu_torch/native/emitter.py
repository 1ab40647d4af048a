"""ctypes wrapper for the native traceback + SAM emitter
(fem_tpu/native/emitter.py). The library builds on first use; a failed
build raises with the compiler's error."""

from __future__ import annotations

import ctypes

import numpy as np

from fem_tpu_torch.io import fastx
from fem_tpu_torch.io.fastx import Reference
from fem_tpu_torch.native.build import native_library


def _native():
    """The native library with this module's entry points typed."""
    lib = native_library()
    lib.fem_emit_batch.restype = ctypes.c_int
    lib.fem_emit_batch.argtypes = [
        ctypes.c_void_p,  # ref_blob
        ctypes.c_void_p,  # ref_offsets
        ctypes.c_void_p,  # ref_lens
        ctypes.c_void_p,  # ref_names_blob
        ctypes.c_void_p,  # ref_name_offsets
        ctypes.c_int32,  # num_refs
        ctypes.c_void_p,  # names_blob
        ctypes.c_void_p,  # name_offsets
        ctypes.c_void_p,  # seqs_blob
        ctypes.c_void_p,  # seq_offsets
        ctypes.c_void_p,  # quals_blob
        ctypes.c_int32,  # num_reads
        ctypes.c_void_p,  # map_counts
        ctypes.c_void_p,  # m_dir
        ctypes.c_void_p,  # m_ed
        ctypes.c_void_p,  # m_sid
        ctypes.c_void_p,  # m_pos
        ctypes.c_void_p,  # m_end
        ctypes.c_int32,  # error_threshold
        ctypes.POINTER(ctypes.c_void_p),  # out_buf
        ctypes.POINTER(ctypes.c_int64),  # out_len
        ctypes.c_void_p,  # per_read_ends (int64[num_reads], optional)
    ]
    return lib


class NativeEmitter:
    """Per-reference emitter; reusable across batches."""

    def __init__(self, reference: Reference, error_threshold: int):
        self._lib = _native()
        self._e = error_threshold
        self._ref_blob, self._ref_offsets = fastx.seqs_blob(reference)
        self._ref_lens = reference.lengths.astype(np.int64)
        self._ref_names_blob, self._ref_name_offsets = fastx.blob(reference.names)
        self._num_refs = reference.num_seqs

    def emit(
        self,
        batch,  # ReadBatch (uses blobs directly when present)
        map_counts: np.ndarray,  # (num_reads,) int32 — mappings per read
        m_dir: np.ndarray,  # (M,) uint8, generation order per read
        m_ed: np.ndarray,  # (M,) uint8
        m_sid: np.ndarray,  # (M,) int32
        m_pos: np.ndarray,  # (M,) int64 band starts
        m_end: np.ndarray,  # (M,) int32 end offsets
        want_read_ends: bool = False,
    ) -> bytes | tuple[bytes, np.ndarray]:
        """Emit SAM text; with `want_read_ends` also return per-read
        exclusive end offsets into the blob (for record splicing)."""
        if getattr(batch, "has_blobs", False):
            names_blob = batch.names_blob
            name_offsets = np.ascontiguousarray(batch.name_offsets, np.int64)
            seqs_blob = batch.seqs_blob
            seq_offsets = np.ascontiguousarray(batch.seq_offsets, np.int64)
            quals_blob = batch.quals_blob
        else:
            names_blob, name_offsets = fastx.blob(batch.names)
            seqs_blob, seq_offsets = fastx.blob(batch.seqs)
            quals_blob = b"".join(batch.quals)
        assert len(quals_blob) == len(seqs_blob)
        map_counts = np.ascontiguousarray(map_counts, np.int32)
        m_dir = np.ascontiguousarray(m_dir, np.uint8)
        m_ed = np.ascontiguousarray(m_ed, np.uint8)
        m_sid = np.ascontiguousarray(m_sid, np.int32)
        m_pos = np.ascontiguousarray(m_pos, np.int64)
        m_end = np.ascontiguousarray(m_end, np.int32)
        out_buf = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        read_ends = (
            np.zeros(batch.num_reads, np.int64) if want_read_ends else None
        )

        def vp(arr: np.ndarray):
            return arr.ctypes.data_as(ctypes.c_void_p)

        rc = self._lib.fem_emit_batch(
            ctypes.c_char_p(self._ref_blob),
            vp(self._ref_offsets),
            vp(self._ref_lens),
            ctypes.c_char_p(self._ref_names_blob),
            vp(self._ref_name_offsets),
            self._num_refs,
            ctypes.c_char_p(names_blob),
            vp(name_offsets),
            ctypes.c_char_p(seqs_blob),
            vp(seq_offsets),
            ctypes.c_char_p(quals_blob),
            batch.num_reads,
            vp(map_counts),
            vp(m_dir),
            vp(m_ed),
            vp(m_sid),
            vp(m_pos),
            vp(m_end),
            self._e,
            ctypes.byref(out_buf),
            ctypes.byref(out_len),
            vp(read_ends) if read_ends is not None else None,
        )
        if rc != 0:
            raise RuntimeError(f"fem_emit_batch failed with {rc}")
        try:
            blob = ctypes.string_at(out_buf, out_len.value)
        finally:
            self._lib.fem_free(out_buf)
        return (blob, read_ends) if want_read_ends else blob
