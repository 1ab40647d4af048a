"""Shared by the port's two build modules (kernels.py: nvcc, native/build.py:
g++): where build products go and how a target is written.

Many processes may start on a fresh checkout at once (`map -t N`, the
bench's workers, pytest's workers), and each would find every target
missing. `build_if_stale` holds an exclusive `fcntl.flock` on a lock file
in the target's directory around the stale check and the build, and checks
again once it holds the lock: one process compiles, the others wait and
load the file it wrote. Without the lock each process would compile and
replace the file the others had already loaded.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import sys
import time

# build/fem_tpu_torch/ at the repository root; never next to the sources.
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "fem_tpu_torch"
)
LOCK_NAME = ".build.lock"


def stale(target: str, srcs: list[str]) -> bool:
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(s) > t for s in srcs)


@contextlib.contextmanager
def build_lock(directory: str):
    """Exclusive lock across processes on `directory`/.build.lock. The
    kernel releases it when its holder exits, so a killed build leaves no
    lock behind."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, LOCK_NAME), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_if_stale(target: str, srcs: list[str], build, force: bool = False) -> bool:
    """Call `build()` to (re)write `target` if it is missing or older than a
    source (always with `force`), under the build lock. Returns whether this
    process built it. One line on stderr says which process built and how
    long one that found it stale waited for another's build."""
    if not force and not stale(target, srcs):
        return False
    t0 = time.perf_counter()
    with build_lock(os.path.dirname(target)):
        waited = time.perf_counter() - t0
        name = os.path.basename(target)
        if not force and not stale(target, srcs):
            print(f"[build] pid {os.getpid()} waited {waited:.1f} s for {name}, "
                  f"built by another process", file=sys.stderr)
            return False
        t1 = time.perf_counter()
        build()
        print(f"[build] pid {os.getpid()} built {name} in {time.perf_counter() - t1:.1f} s "
              f"(waited {waited:.1f} s for the lock)", file=sys.stderr)
        return True


def compile_to(cmd: list[str], target: str) -> str:
    """Run a compiler writing `target` via a per-process temp name, so
    concurrent builds never load a half-written file. Raises with the
    compiler's stderr on failure; returns its stderr (warnings, -Xptxas -v
    resource usage) otherwise."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    return proc.stderr
