"""Shared by the port's two build modules (kernels.py: nvcc, native/build.py:
g++): where build products go and how a target is written."""

from __future__ import annotations

import os
import subprocess

# build/fem_tpu_torch/ at the repository root; never next to the sources.
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "fem_tpu_torch"
)


def stale(target: str, srcs: list[str]) -> bool:
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(s) > t for s in srcs)


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
