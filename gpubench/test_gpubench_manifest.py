"""BENCHMARK.json against the contract's form, and the harness finding its
files by name."""

import json
import shutil
from pathlib import Path

import pytest

from gpubench.manifest import NAME, UNIT, Bench
from gpubench.readings import kernel_names, load_reader

ROOT = Path(__file__).resolve().parent.parent
TEXT_KEYS = ("why", "layer", "source")


def _doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_size():
    doc = _doc()
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= doc["run_seconds"] <= 51
    assert doc["paths"] == ["gpubench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in doc["command"])


def test_names_and_units_use_the_allowed_characters():
    doc = _doc()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in doc[k]]
    names += [w[k] for w in doc["workloads"] for k in ("config", "traffic")]
    names += [r for c in doc["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        own = [x["name"] for x in doc[k]]
        assert len(own) == len(set(own))
    units = [m["unit"] for k in ("end_to_end", "per_layer") for m in doc[k]]
    assert all(UNIT.match(u) for u in units), units
    for k in ("configs", "workloads", "per_layer"):
        for x in doc[k]:
            for t in TEXT_KEYS:
                if t in x:
                    assert 1 <= len(x[t]) <= 200
                    assert "\n" not in x[t] and "\t" not in x[t]


def test_each_configuration_file_states_its_reduced_keys():
    doc = _doc()
    for c in doc["configs"]:
        own = json.loads((ROOT / c["file"]).read_text())
        assert own["reduced"] == c["reduced"]
        assert own["source"] == c["source"]


def test_metrics_keep_to_the_contract():
    doc = _doc()
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
        # no rate over busy time, no median of chunks or gaps
        assert "busy" not in m["name"] and "median" not in m["name"]
    bench = Bench(ROOT)
    for w in doc["workloads"]:
        reported = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(w["name"])
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [w["name"] for w in doc["workloads"]]):
            # a per-layer metric only where its end-to-end metric is
            assert m["moves"] in {x["name"] for x in bench.end_to_end(w)}


def test_every_named_file_is_there():
    bench = Bench(ROOT)
    for w in bench.doc["workloads"]:
        cell = bench.cell(w["name"])
        assert bench.config(cell.config)
        assert bench.traffic(cell.traffic)["kind"] in ("train", "predict")
        assert bench.limits(cell.name)
    for m in bench.doc["per_layer"]:
        assert callable(load_reader(bench.metric_dir(m["name"])))
    assert "wide_cols_kernel" in kernel_names(
        bench.metric_dir("fanout_roofline.train"))


def test_a_new_traffic_mix_is_found_without_an_edit(tmp_path):
    """A cell added as files: a traffic mix, its limits and its entry in
    BENCHMARK.json; nothing else changes."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = _doc()
    doc["workloads"].append({"name": "reddit-exact-b2048",
                             "config": "reddit-gs2-h128",
                             "traffic": "exact-b2048", "chips": 1,
                             "why": "a mix added as data"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    traffic = json.loads((ROOT / "gpubench/traffic/exact-b4096.json")
                         .read_text())
    (tmp_path / "gpubench/traffic/exact-b2048.json").write_text(
        json.dumps(dict(traffic, batch_size=2048)))
    shutil.copy(ROOT / "gpubench/limits/reddit-exact-b4096.json",
                tmp_path / "gpubench/limits/reddit-exact-b2048.json")
    bench = Bench(tmp_path)
    cell = bench.cell("reddit-exact-b2048")
    assert bench.traffic(cell.traffic)["batch_size"] == 2048
    assert bench.limits(cell.name) == Bench(ROOT).limits(
        "reddit-exact-b4096")
    assert {m["name"] for m in bench.end_to_end(cell.name)} == {
        "peak_mem_gib", "setup_s"}
    with pytest.raises(KeyError):
        Bench(ROOT).cell("reddit-exact-b2048")
