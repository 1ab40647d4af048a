"""On-demand build of the port's native host code (fem_tpu/native/build.py).

g++ compiles native/src/ into build/fem_tpu_torch/ at the repository
root: the shared library `libfem_tpu_torch_native.so` (SAM emitter, exact
CPU mapper, FASTQ reader; a C API consumed via ctypes), the standalone
`fem_baseline` mapper binary and the ThreadSanitizer stress binary
`tsan_stress`. Nothing is written next to the sources, so
this package's builds never collide with fem_tpu's. A target is rebuilt
when a source is newer, under the build lock across processes
(`_build.build_if_stale`); a compile error raises with the compiler's stderr.
"""

from __future__ import annotations

import os
import threading

from fem_tpu_torch._build import BUILD_DIR, build_if_stale, compile_to

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
LIB_PATH = os.path.join(BUILD_DIR, "libfem_tpu_torch_native.so")
BASELINE_PATH = os.path.join(BUILD_DIR, "fem_baseline")
TSAN_STRESS_PATH = os.path.join(BUILD_DIR, "tsan_stress")
_lock = threading.Lock()

_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-Wall"]
_MAINS = ("baseline.cpp", "tsan_stress.cpp")  # standalone binaries, not in the library


def _listed(suffix: str) -> list[str]:
    return [os.path.join(SRC_DIR, f) for f in sorted(os.listdir(SRC_DIR))
            if f.endswith(suffix)]


def build_native(force: bool = False) -> str:
    """Build the shared library consumed via ctypes; returns its path."""
    with _lock:
        srcs = [s for s in _listed(".cpp") if os.path.basename(s) not in _MAINS]
        build_if_stale(LIB_PATH, srcs + _listed(".h"), lambda: compile_to(
            ["g++", *_CXXFLAGS, "-pthread", "-shared", "-fPIC", *srcs, "-lz"],
            LIB_PATH,
        ), force)
        return LIB_PATH


def build_baseline(force: bool = False) -> str:
    """Build the standalone fem_baseline CPU mapper binary; returns its path."""
    with _lock:
        src = os.path.join(SRC_DIR, "baseline.cpp")
        build_if_stale(BASELINE_PATH, [src] + _listed(".h"), lambda: compile_to(
            ["g++", *_CXXFLAGS, "-pthread", src, "-lz"], BASELINE_PATH), force)
        return BASELINE_PATH


def build_tsan_stress(force: bool = False) -> str:
    """Build the ThreadSanitizer stress binary: tsan_stress.cpp with the
    library's sources at -O1 -fsanitize=thread (fem_tpu/native/build.py).
    It drives the emitter and the CPU mapper from many threads, as the
    engine's drain threads do, and exits non-zero on any TSan report.
    Raises with the compiler's stderr where the build fails."""
    with _lock:
        srcs = [os.path.join(SRC_DIR, "tsan_stress.cpp")] + [
            s for s in _listed(".cpp") if os.path.basename(s) not in _MAINS]
        build_if_stale(TSAN_STRESS_PATH, srcs + _listed(".h"), lambda: compile_to(
            ["g++", "-O1", "-g", "-std=c++17", "-Wall", "-fsanitize=thread", "-pthread",
             *srcs, "-lz"], TSAN_STRESS_PATH), force)
        return TSAN_STRESS_PATH


_lib = None


def native_library():
    """The loaded shared library (built on first use), one handle for the
    emitter, the mapper and the reader. A failed build raises."""
    import ctypes

    global _lib
    path = build_native()
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(path)
            _lib.fem_free.argtypes = [ctypes.c_void_p]
        return _lib
