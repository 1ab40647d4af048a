"""The port's native host layer under ThreadSanitizer
(fem_tpu_torch/native/src/tsan_stress.cpp, a byte copy of fem_tpu's):
concurrent fem_emit_batch calls, as the engine's drain threads make them,
and fem_mapper_map on one handle per thread and on one shared handle under
a mutex. Any TSan report makes the binary exit non-zero.

The test skips only where the compiler cannot build a trivial unit with
-fsanitize=thread; any other build error of the stress binary fails it.
"""

import subprocess

import pytest

from fem_tpu_torch import _build
from fem_tpu_torch.native.build import build_tsan_stress


@pytest.fixture(scope="module")
def tsan_available(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsan_probe")
    src = d / "probe.cpp"
    src.write_text("#include <thread>\nint main() { std::thread t([] {}); t.join(); }\n")
    try:
        _build.compile_to(["g++", "-fsanitize=thread", "-pthread", str(src)], str(d / "probe"))
    except RuntimeError as exc:
        pytest.skip(f"this compiler does not build with -fsanitize=thread: {exc}")


def test_tsan_stress(tsan_available):
    binary = build_tsan_stress()
    res = subprocess.run([binary], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "tsan_stress ok" in res.stdout
