"""Cells, configurations, mixes and metrics are found by name from files
alone; the contract's shape of BENCHMARK.json."""
import json
import re
import shutil

import pytest

from conftest import ROOT, tiny_cell, write_json
from stereo_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_cell_finds_its_files(spec):
    for w in spec["workloads"]:
        cell = harness.Cell.from_spec(spec, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["entry"] in ("match", "match_batched_device")
        assert (harness.BENCH / "entries" /
                f"{cell.traffic['entry']}.py").is_file()
        cell.scene()
        assert cell.e2e and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.e2e}
        for m in cell.e2e:
            harness.find_reader("e2e", m["name"])
        for m in cell.per_layer:
            harness.find_reader("metrics", m["name"])


def test_cells_report_their_metrics(spec):
    stream = harness.Cell.from_spec(spec, "kitti.stream")
    cones = harness.Cell.from_spec(spec, "cones.stream")
    batch = harness.Cell.from_spec(spec, "cones.batch8")
    assert {m["name"] for m in stream.e2e} == {
        "latency_ms", "latency_ms.p95", "setup_s"}
    assert {m["name"] for m in cones.e2e} == {
        "latency_ms", "latency_ms.p95", "setup_s"}
    assert {m["name"] for m in batch.e2e} == {"throughput", "setup_s"}
    assert {m["name"] for m in batch.per_layer} == {
        "device.idle_pct.batch", "stages.torch_ms.batch",
        "kernels.hand_ms.batch"}
    assert len(stream.per_layer) == 5


def test_spec_keeps_to_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert len(c["source"]) <= 200
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    layers = {m["layer"] for m in spec["per_layer"]}
    assert layers == {"device", "entry", "stages", "kernels"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        # every cell a per-layer metric lists reports what it moves
        moved = e2e[m["moves"]].get("workloads", m["workloads"])
        assert set(m["workloads"]) <= set(moved), m["name"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(spec)) < 64 * 1024


def _copy_bench(tmp_path):
    bench = tmp_path / "stereo_bench"
    shutil.copytree(ROOT / "stereo_bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return bench


def test_a_new_configuration_mix_and_metric_are_picked_up(tmp_path, spec):
    """A later change adds files and entries only: a new configuration,
    traffic mix and per-layer metric in a copy of the folder."""
    bench = _copy_bench(tmp_path)
    cfg = json.loads((bench / "configs" / "kitti2015.json").read_text())
    cfg.update(name="kitti2012", width=1226, height=370)
    write_json(bench / "configs" / "kitti2012.json", cfg)
    mix = json.loads((bench / "traffic" / "stream.json").read_text())
    write_json(bench / "traffic" / "stream-warm5.json",
               dict(mix, warmup_requests=5))
    (bench / "metrics" / "device.ops_count.py").write_text(
        "def read(trace):\n    return float(len(trace.device_ops))\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "kitti2012", "source": "KITTI 2012",
                           "file": "stereo_bench/configs/kitti2012.json",
                           "reduced": [], "why": "another frame size"})
    new["workloads"].append({"name": "kitti12.stream", "config": "kitti2012",
                             "traffic": "stream-warm5", "chips": 1,
                             "why": "test"})
    new["per_layer"].append({"name": "device.ops_count", "unit": "ops",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "latency_ms",
                             "workloads": ["kitti12.stream"]})
    write_json(tmp_path / "BENCHMARK.json", new)
    cell = harness.Cell.from_spec(harness.load_spec(tmp_path),
                                  "kitti12.stream", root=tmp_path,
                                  bench=bench)
    assert (cell.config["width"], cell.traffic["warmup_requests"]) == (1226, 5)
    assert cell.pair_work() == 1226 * 370 * 256
    names = [m["name"] for m in cell.per_layer]
    assert names == ["device.ops_count"]
    path = harness.find_reader("metrics", "device.ops_count", bench)
    assert path.parent == bench / "metrics"
    cell.traffic["pool_pairs"] = 1
    lefts, _, _ = harness.make_pool(cell, 3)
    assert lefts[0].shape == (370, 1226, 3)


def test_a_new_mix_with_its_own_entry_and_loop_runs(tmp_path, spec):
    """A mix that calls another entry of the program, with keyword
    arguments, in an open loop at a fixed rate, is a data file and an
    entry file: a whole run takes it up without an edit elsewhere."""
    bench = _copy_bench(tmp_path)
    (bench / "entries" / "match_device_pairs.py").write_text(
        "INPUTS = 'pairs'\n"
        "CALLS = []\n"
        "def make(device, opts, **args):\n"
        "    import torch\n"
        "    from adcensus_torch.stages import pipeline\n"
        "    def call(pairs):\n"
        "        CALLS.append(args)\n"
        "        return [pipeline.match_device(torch.as_tensor(l),\n"
        "                torch.as_tensor(r), opts, device=device, **args)\n"
        "                .cpu().numpy() for l, r in pairs]\n"
        "    return call\n")
    write_json(bench / "traffic" / "pairs2-open.json", {
        "entry": "match_device_pairs", "entry_args": {"cross_backend": "roll"},
        "loop": "open", "rate_hz": 200.0, "pairs_per_request": 2,
        "pool_pairs": 3, "warmup_requests": 1, "trace_requests": 2})
    new = json.loads(json.dumps(spec))
    new["workloads"].append({"name": "cones.pairs2-open",
                             "config": "middlebury2003-cones",
                             "traffic": "pairs2-open", "chips": 1,
                             "why": "test"})
    new["end_to_end"][0].setdefault("workloads", []).append(
        "cones.pairs2-open")
    write_json(tmp_path / "BENCHMARK.json", new)
    cell = harness.Cell.from_spec(harness.load_spec(tmp_path),
                                  "cones.pairs2-open", root=tmp_path,
                                  bench=bench)
    cell.config = tiny_cell("cones.stream").config
    out = harness.run_cell(cell, seed=2 ** 40 + 3, seconds=0.05, trace=False,
                           device="cpu", log=lambda *a: None)
    assert out.correct, out.checks
    assert out.attempted >= 2 and out.attempted % 2 == 0
    assert set(out.metrics) >= {"setup_s", new["end_to_end"][0]["name"]}


@pytest.mark.parametrize("change, error", [
    ({"clients": 4}, "not read"),
    ({"loop": "poisson"}, "loop must be"),
    ({"loop": "open"}, "rate_hz"),
    ({"rate_hz": 10.0}, "rate_hz"),
    ({"pool_pairs": 0}, "pool_pairs"),
    ({"entry_args": [1]}, "entry_args"),
])
def test_a_mix_with_a_setting_the_harness_does_not_run_is_refused(
        change, error):
    mix = json.loads((ROOT / "stereo_bench/traffic/stream.json").read_text())
    with pytest.raises(ValueError, match=error):
        harness.check_traffic("x", dict(mix, **change))
    with pytest.raises(FileNotFoundError):
        harness.check_traffic("x", dict(mix, entry="nope"))


def test_unknown_cell_and_reader_raise(spec):
    with pytest.raises(KeyError):
        harness.Cell.from_spec(spec, "nope.stream")
    with pytest.raises(FileNotFoundError):
        harness.find_reader("metrics", "nope.metric")


def test_variant_falls_back_to_the_quantity_reader():
    assert harness.find_reader("metrics", "device.idle_pct.batch").name == \
        "device.idle_pct.py"
    assert harness.find_reader("metrics", "device.idle_pct.stream").name == \
        "device.idle_pct.stream.py"
    assert harness.find_reader("e2e", "latency_ms.p95").name == \
        "latency_ms.p95.py"
