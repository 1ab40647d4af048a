"""Each metric reader against what traced runs on the card recorded
(fixtures/<cell>.json: what the readers read, the window's counters and
engine.report()'s retries, the profiler trace's summary, and the values
the run printed); and readers that find nothing to read return nothing,
never 0."""

import glob
import json
import os

import pytest

from fembench import harness, trace

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "*.json")))
bench = harness.load_benchmark()
PER_LAYER = [m["name"] for m in bench["per_layer"]]
READERS = PER_LAYER + [m["name"] for m in bench["end_to_end"] if m["source"] == "device_trace"]


def _p95_of_the_window(run, value):
    lat = sorted(run["window"]["latencies_s"])
    return lat[int(0.9 * len(lat))] * 1e3 <= value <= lat[-1] * 1e3


# Metrics added after the recordings, each against its own definition.
DEFINED = {
    "batch_p95_ms": _p95_of_the_window,
    "stream_reads_per_s": lambda run, v: v == run["window"]["reads_completed"]
    / run["window"]["seconds"],
    "reads_per_device_s": lambda run, v: v == run["window"]["pulled_reads"]
    / run["trace"]["busy_s"],
}


def test_fixtures_are_there():
    assert FIXTURES


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
@pytest.mark.parametrize("name", READERS)
def test_reader_gives_what_the_card_printed(path, name):
    with open(path) as f:
        rec = json.load(f)
    value = harness.metric_reader(name)(rec["run"])
    if name in rec["metrics"]:
        assert value == pytest.approx(rec["metrics"][name]["value"], rel=1e-12)
    else:
        assert DEFINED[name](rec["run"], value)
    if name.endswith("_roofline_pct"):
        assert 0 < value <= 100


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_trace_summary_holds_the_kernels(path):
    with open(path) as f:
        t = json.load(f)["run"]["trace"]
    assert 0 < t["busy_s"] <= t["window_s"]
    for prefix in ("filter_tail", "banded_myers"):
        secs, n = trace.kernel_seconds(t, prefix)
        assert secs > 0 and n > 0
    top = trace.breakdown(t)
    assert len(top["device_ops"]) == 10 and len(top["idle_gaps"]) <= 10


@pytest.mark.parametrize("name", [n for n in READERS if n != "stream_reads_per_s"])
def test_reader_finds_nothing_in_an_empty_trace(name):
    run = {"window": {"totals": dict.fromkeys(harness.COUNTERS, 0), "retried_reads": 0,
                      "pulled_reads": 0, "seconds": 1.0, "latencies_s": []},
           "trace": {"window_s": 1.0, "busy_s": 0.0, "ops": {}, "idle_gaps": []},
           "fem": {"error_threshold": 5}, "read_length": 100}
    assert harness.metric_reader(name)(run) is None


def test_kernel_base_names():
    assert trace.kernel_base("void (anonymous namespace)::filter_tail_block_kernel<256>"
                             "(int const*, int const*)") == "filter_tail_block_kernel"
    assert trace.kernel_base("banded_myers_kernel(unsigned char const*, long)") == "banded_myers_kernel"
    assert trace.kernel_base("void at::native::vectorized_elementwise_kernel<4>(int)") == \
        "vectorized_elementwise_kernel"
    assert trace.kernel_base("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"


def test_busy_is_the_union_of_intervals():
    import numpy as np

    t = trace.reduce(["a", "b", "c", "d"], np.array([0.0, 0.5, 2.0, 2.1]),
                     np.array([1.0, 1.5, 2.5, 2.2]), [("host", 1.4, 2.1, 7)], 3.0)
    assert t["busy_s"] == pytest.approx(2.0)
    assert t["idle_gaps"] == [["host", pytest.approx(0.5)]]
    assert t["ops"]["a"] == [1.0, 1]
