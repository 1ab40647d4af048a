"""ctypes wrapper for the in-process CPU mapper, the exact fallback path
(fem_tpu/native/mapper.py). The library builds on first use; a failed
build raises with the compiler's error."""

from __future__ import annotations

import ctypes
import threading
from typing import List, Tuple

import numpy as np

from fem_tpu_torch.index.storage import FemIndex
from fem_tpu_torch.io import fastx
from fem_tpu_torch.io.fastx import Reference
from fem_tpu_torch.native.build import native_library


def _native():
    """The native library with this module's entry points typed."""
    lib = native_library()
    lib.fem_mapper_create.restype = ctypes.c_void_p
    lib.fem_mapper_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # ref blob/offsets
        ctypes.c_void_p, ctypes.c_void_p,  # names blob/offsets
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,  # lookup/occ/size
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.fem_mapper_destroy.argtypes = [ctypes.c_void_p]
    lib.fem_mapper_map.restype = ctypes.c_int
    lib.fem_mapper_map.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p,
    ]
    return lib


class NativeCpuMapper:
    """Complete in-process CPU mapper over the host-resident index.
    Byte-identical semantics to the golden oracle at C++ speed; used by
    the engine for capacity-overflow fallback reads."""

    def __init__(self, args, reference: Reference, index: FemIndex):
        self._lib = _native()
        # The handle's per-call scratch (mapper_core.h: hashes_, cands_,
        # mappings_, ...) lives in the handle, not on the stack —
        # concurrent map_reads calls on one handle race on it. The engine
        # calls this from several drain threads (capacity-overflow
        # fallback), so every call serializes on this lock. Fallback
        # volume is ~0.2% of reads; serialization costs nothing.
        self._lock = threading.Lock()
        # Keep every buffer alive for the handle's lifetime.
        self._ref_blob, self._ref_offsets = fastx.seqs_blob(reference)
        self._names_blob, self._name_offsets = fastx.blob(reference.names)
        self._lookup = np.ascontiguousarray(index.lookup, np.uint32)
        self._occ = np.ascontiguousarray(index.occurrences, np.uint64)
        vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        self._h = self._lib.fem_mapper_create(
            ctypes.cast(ctypes.c_char_p(self._ref_blob), ctypes.c_void_p),
            vp(self._ref_offsets),
            ctypes.cast(ctypes.c_char_p(self._names_blob), ctypes.c_void_p),
            vp(self._name_offsets),
            reference.num_seqs,
            vp(self._lookup),
            vp(self._occ),
            self._occ.shape[0],
            index.kmer_size,
            index.step_size,
            args.error_threshold,
            args.num_additional_qgrams,
        )
        if not self._h:
            raise RuntimeError("fem_mapper_create failed")

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.fem_mapper_destroy(self._h)
        except Exception:
            pass

    def map_reads(
        self, names: List[bytes], seqs: List[bytes], quals: List[bytes]
    ) -> Tuple[bytes, np.ndarray]:
        """Returns (sam_blob, stats[5] = reads/mapped/cand_pre/cand/mappings)."""
        names_blob, name_offsets = fastx.blob(names)
        seqs_blob, seq_offsets = fastx.blob(seqs)
        quals_blob = b"".join(quals)
        assert len(quals_blob) == len(seqs_blob)
        out_buf = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        stats = np.zeros(5, np.uint64)
        vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        with self._lock:  # handle scratch is not reentrant (see __init__)
            rc = self._lib.fem_mapper_map(
                self._h,
                ctypes.c_char_p(names_blob), vp(name_offsets),
                ctypes.c_char_p(seqs_blob), vp(seq_offsets),
                ctypes.c_char_p(quals_blob),
                len(names),
                ctypes.byref(out_buf), ctypes.byref(out_len),
                vp(stats),
            )
            if rc != 0:
                raise RuntimeError(f"fem_mapper_map failed with {rc}")
            try:
                return ctypes.string_at(out_buf, out_len.value), stats
            finally:
                self._lib.fem_free(out_buf)
