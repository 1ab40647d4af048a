"""The port's build lock across processes (fem_tpu_torch/_build.py).

Processes that start together on a fresh checkout (`map -t N`, the bench's
workers, pytest's workers) must compile a target once: the others wait
for the lock, find the target fresh and load the file the first one wrote.
Without the lock each one compiled and replaced the file the others had
already loaded, which /proc/self/maps then showed as "(deleted)".
"""

import json
import os
import subprocess
import sys
import time

import pytest

from fem_tpu_torch import _build

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One process: say it is ready, wait for the start signal, build the library
# through the locked helper, load it, and report what /proc/self/maps shows
# of it.
_CHILD = r"""
import ctypes, json, os, sys, time
from fem_tpu_torch import _build

cc, src, target, go = sys.argv[1:5]
open(f"{go}.ready.{os.getpid()}", "w").close()
while not os.path.exists(go):
    time.sleep(0.005)
built = _build.build_if_stale(
    target, [src], lambda: _build.compile_to([cc, "-shared", "-fPIC", src], target))
lib = ctypes.CDLL(target)
assert lib.answer() == 42
with open("/proc/self/maps") as f:
    maps = sorted({line.split(None, 5)[-1].strip() for line in f
                   if os.path.basename(target) in line})
print(json.dumps({"built": built, "maps": maps}))
"""


def _compiler(tmp_path):
    """g++ behind a script that counts its runs and takes a second, so that
    the other processes reach the stale check while it runs."""
    count = tmp_path / "compiler_runs"
    cc = tmp_path / "cc.sh"
    cc.write_text(f'#!/bin/sh\necho run >> "{count}"\nsleep 1\nexec g++ "$@"\n')
    cc.chmod(0o755)
    return str(cc), count


def test_four_processes_compile_once(tmp_path):
    cc, count = _compiler(tmp_path)
    src = tmp_path / "answer.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    target = str(tmp_path / "build" / "libanswer.so")
    go = tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, cc, str(src), target, str(go)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    deadline = time.time() + 60  # every process at the start line, then go
    while len(list(tmp_path.glob("go.ready.*"))) < 4 and time.time() < deadline:
        time.sleep(0.01)
    go.write_text("")
    results = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
        assert ("built libanswer.so" in err) or ("built by another process" in err), err
    assert count.read_text().count("run") == 1
    assert sum(r["built"] for r in results) == 1
    for r in results:
        assert r["maps"] == [target], r["maps"]  # loaded, and not "(deleted)"
    assert os.path.exists(os.path.join(os.path.dirname(target), _build.LOCK_NAME))


@pytest.mark.parametrize("case", ["fresh", "source_newer", "force", "missing"])
def test_build_if_stale_builds_when_it_must(tmp_path, case):
    src = tmp_path / "a.txt"
    target = tmp_path / "out" / "a.bin"
    src.write_text("x")
    calls = []

    def build():
        calls.append(1)
        target.write_text("built")

    if case != "missing":
        assert _build.build_if_stale(str(target), [str(src)], build)
        calls.clear()
    if case == "source_newer":
        later = os.path.getmtime(target) + 5
        os.utime(src, (later, later))
    built = _build.build_if_stale(str(target), [str(src)], build, force=case == "force")
    assert built == (case != "fresh") and len(calls) == int(built)
    assert target.read_text() == "built"


def test_lock_excludes_a_second_holder(tmp_path):
    """While one process holds the lock, another's build_lock blocks."""
    code = (
        "import sys, time\n"
        "from fem_tpu_torch import _build\n"
        "with _build.build_lock(sys.argv[1]):\n"
        "    print('held', flush=True)\n"
        "    time.sleep(1.5)\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    with subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                          stdout=subprocess.PIPE, text=True) as p:
        assert p.stdout.readline().strip() == "held"
        t0 = time.perf_counter()
        with _build.build_lock(str(tmp_path)):
            waited = time.perf_counter() - t0
        p.wait(timeout=30)
    assert p.returncode == 0
    assert waited > 0.5
