"""A configuration, a traffic mix and a metric are files of their own that
the harness finds by name: adding one needs no edit to a file that is
there. And BENCHMARK.json names only files and readers that exist."""

import json
import os
import shutil

from fembench import harness

HERE = os.path.dirname(os.path.abspath(harness.__file__))


def test_benchmark_names_existing_files():
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert harness.load_json("traffic", w["traffic"])["name"] == w["traffic"]
        e2e, layer = harness.cell_metrics(bench, w["name"])
        assert {m["name"] for m in e2e} == {"reads_per_device_s", "setup_s"}
        assert layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "fembench"
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, kind), base / kind)
    before = {p: (base / p).read_bytes() for p in
              [os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base) for f in fs]}
    cfg = dict(harness.load_json("configs", "chr21_e5"), name="chr21_e7")
    cfg["fem"] = dict(cfg["fem"], error_threshold=7)
    (base / "configs" / "chr21_e7.json").write_text(json.dumps(cfg))
    mix = dict(harness.load_json("traffic", "wgs"), name="len150", read_length=150)
    (base / "traffic" / "len150.json").write_text(json.dumps(mix))
    (base / "metrics" / "emitted_mb.py").write_text(
        "def read(run):\n    return run['window']['totals']['num_mappings'] * 0.25\n")
    assert harness.load_json("configs", "chr21_e7", base=str(base))["fem"]["error_threshold"] == 7
    assert harness.load_json("traffic", "len150", base=str(base))["read_length"] == 150
    reader = harness.metric_reader("emitted_mb", base=str(base))
    assert reader({"window": {"totals": {"num_mappings": 8}}}) == 2.0
    bench = harness.load_benchmark()
    bench["workloads"].append({"name": "chr21_e7.len150", "config": "chr21_e7",
                               "traffic": "len150", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "emitted_mb", "unit": "MB", "better": "lower",
                               "source": "program_counter", "layer": "emission",
                               "moves": "reads_per_device_s", "workloads": ["chr21_e7.len150"]})
    e2e, layer = harness.cell_metrics(bench, "chr21_e7.len150")
    assert [m["name"] for m in layer] == ["emitted_mb"]
    assert {m["name"] for m in e2e} == {"reads_per_device_s", "setup_s"}
    for p, data in before.items():  # nothing that was there changed
        assert (base / p).read_bytes() == data


def test_per_layer_without_workloads_goes_to_every_cell_of_its_metric():
    bench = harness.load_benchmark()
    bench["per_layer"].append({"name": "all_cells", "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "device",
                               "moves": "setup_s"})
    for w in bench["workloads"]:
        assert "all_cells" in [m["name"] for m in harness.cell_metrics(bench, w["name"])[1]]
