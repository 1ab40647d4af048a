"""Build and load the port's CUDA kernels.

csrc/*.cu compile with nvcc into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. Each source compiles to its own object, all at once, and one link
joins them, under the build lock across processes. Each C entry point
takes its CUDA stream and returns cudaGetLastError() right after the
launch. The library lives in build/fem_tpu_torch/ at the repository root
and is rebuilt when any source is newer. A compile error raises with nvcc's stderr; nothing is
taken from outside the checkout. `build_log` keeps what ptxas said of
each kernel's registers, shared memory and spills (-Xptxas -v).

`launches` counts kernel launches per kernel and `launch_shapes` the same
launches by the shape they were made at; each wrapper calls `count_launch`
where it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels and at which widths. The counts are
taken under a lock: the engine's drain threads launch retry batches beside
the submitting thread. A CUDA graph launches its kernels at every replay
but runs their wrappers once, at capture: `recording_launches` takes the
capturing thread's counts aside (the capture launches nothing), and
`add_launches` adds them once a replay. A grid records a capture a cell
segment, and adds each cell's at each replay.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

from fem_tpu_torch._build import BUILD_DIR, build_if_stale, compile_to

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
LIB_PATH = os.path.join(BUILD_DIR, "libfem_tpu_torch_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
build_log = ""  # ptxas -v output of the last build in this process

launches = {"banded_myers": 0, "filter_tail": 0, "occ_slab": 0, "verify_slab": 0,
            "accept_slab": 0}
# The same launches by shape: filter_tail's key is (cap_occ, cap_cand),
# banded_myers' is (verify slots, read-strand lanes), occ_slab's is
# (cap_occ, read-strand lanes), verify_slab's and accept_slab's are
# (cap_cand, read-strand lanes).
launch_shapes = {k: collections.Counter() for k in launches}

_lock = threading.Lock()
_count_lock = threading.Lock()
_recording = threading.local()  # .launches: a capture's Counter, on its thread
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_PI = ctypes.POINTER(ctypes.c_int)
_PI64 = ctypes.POINTER(ctypes.c_int64)


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0
            launch_shapes[k].clear()


def count_launch(name: str, shape: tuple) -> None:
    rec = getattr(_recording, "launches", None)
    if rec is not None:  # inside a capture on this thread: nothing ran
        rec[name, shape] += 1
        return
    with _count_lock:
        launches[name] += 1
        launch_shapes[name][shape] += 1


@contextlib.contextmanager
def recording_launches():
    """Within: this thread's `count_launch` calls go to the yielded
    Counter of (kernel, shape) -> launches instead of the counts. Other
    threads count as before."""
    rec = collections.Counter()
    _recording.launches = rec
    try:
        yield rec
    finally:
        _recording.launches = None


def add_launches(recorded: collections.Counter) -> None:
    """Count one replay of a captured program: the launches its capture
    recorded."""
    with _count_lock:
        for (name, shape), n in recorded.items():
            launches[name] += n
            launch_shapes[name][shape] += n


def launches_by_shape() -> dict:
    """A copy of `launch_shapes`, taken under the counters' lock."""
    with _count_lock:
        return {k: dict(v) for k, v in launch_shapes.items()}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False) -> str:
    """Compile csrc/*.cu for sm_90a if the library is missing or stale,
    under the build lock across processes (`_build.build_if_stale`)."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC, "*.h")))

    def compile_all():
        global build_log
        nvcc = nvcc_path()
        objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + ".o") for s in srcs]
        with ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(
                lambda so: compile_to([nvcc, *NVCC_FLAGS, "-c", so[0]], so[1]),
                zip(srcs, objs),
            ))
        compile_to([nvcc, "-shared", *objs], LIB_PATH)
        build_log = "".join(logs)

    build_if_stale(LIB_PATH, srcs + hdrs, compile_all, force)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.fem_banded_myers.restype = _I
            lib.fem_banded_myers.argtypes = [
                _P, _I64, _P, _I,  # ref, ref_len, ref_offsets, num_seqs
                _P, _P, _P,  # v_sid, v_pos, v_lane
                _P, _P, _I, _I, _I,  # both, lens, nb, lmax, e
                _I, _P, _P, _P, _P,  # num_slots, used, ed, end, stream
            ]
            lib.fem_filter_tail_plan.restype = _I
            lib.fem_filter_tail_plan.argtypes = [_I, _I, _PI, _PI64]
            lib.fem_filter_tail.restype = _I
            lib.fem_filter_tail.argtypes = [
                _P, _P, _I, _I, _I, _I, _I, _I,  # sid, diag, nb, G, cap, cc, e, a
                _P, _P, _P,  # out_sid, out_pos, overflow
                _P, _I, _I, _P,  # workspace, its rows, threads (0: the plan's), stream
            ]
            lib.fem_occ_slab.restype = _I
            lib.fem_occ_slab.argtypes = [
                _P, _P, _P, _P, _P, _I64,  # off, lfreq, start, lane_ok, occ, n_occ
                _I64, _I, _I, _I, _P,  # items, S, cap, mode, tkey_in
                _P, _P, _P, _P, _P,  # out_sid, out_diag, overflow, tkey_out, stream
            ]
            lib.fem_verify_slab.restype = _I
            lib.fem_verify_slab.argtypes = [
                _P, _P, _P, _P, _I, _P, _P,  # sid, pos, lens, ref_len, seqs, own_start, own_end
                _I64, _I, _I, _I64,  # nb, cc, e, cap
                _P, _P, _P, _P, _P,  # buf, num, off, total, stream
            ]
            lib.fem_accept_slab.restype = _I
            lib.fem_accept_slab.argtypes = [
                _P, _P, _P, _P, _P, _P, _P,  # v_sid, v_pos, ed, end, accepted, num, off
                _I64, _I, _I64, _I64,  # nb, cc, vcap, acap
                _P, _P, _P, _P,  # buf, ok, n_accepted, stream
            ]
            lib.fem_cuda_error_string.restype = ctypes.c_char_p
            lib.fem_cuda_error_string.argtypes = [_I]
            _lib = lib
        return _lib


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().fem_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def build_host_check(out_dir: str) -> ctypes.CDLL:
    """g++ build of csrc/host_check.cpp: the kernels' per-lane header code
    compiled for the host, for the CPU tests. Raises on a compile error."""
    target = os.path.join(out_dir, "libfem_tpu_torch_host_check.so")
    compile_to(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Wno-unknown-pragmas", "-U_FORTIFY_SOURCE", "-shared",
         "-fPIC", os.path.join(CSRC, "host_check.cpp")],
        target,
    )
    lib = ctypes.CDLL(target)
    lib.fem_host_filter_tail.restype = _I
    lib.fem_host_filter_tail.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I]
    lib.fem_host_filter_tail_plan.restype = _I
    lib.fem_host_filter_tail_plan.argtypes = [_I, _I, _PI, _PI64]
    lib.fem_host_banded_myers.restype = None
    lib.fem_host_banded_myers.argtypes = [
        _P, _I64, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
    ]
    lib.fem_host_occ_slab.restype = _I
    lib.fem_host_occ_slab.argtypes = [
        _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _I,
    ]
    lib.fem_host_verify_slab.restype = _I
    lib.fem_host_verify_slab.argtypes = [
        _P, _P, _P, _P, _I, _P, _P, _I64, _I, _I, _I64, _P, _P, _P, _P, _I,
    ]
    lib.fem_host_accept_slab.restype = _I
    lib.fem_host_accept_slab.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I64, _I64, _P, _P, _P, _I,
    ]
    return lib
