"""The manifest and the files it names: the contract's rules, and that a
cell, a metric or a configuration is added by files alone."""

import json
import shutil

import pytest

from port_bench import manifest as mf


def test_manifest_loads_and_every_file_has_its_entry():
    m = mf.load()
    assert {c["name"] for c in m["configs"]} == {"cvae", "conv_cvae"}
    for w in m["workloads"]:
        workload, config, traffic = mf.cell(m, w["name"])
        assert config["name"] == w["config"]
        assert mf.driver(traffic["driver"]).__name__ == "Driver"
    for p in m["per_layer"]:
        assert callable(mf.reader(p["name"]))


def test_names_units_and_reporting_rules():
    m = mf.load()
    for e in m["end_to_end"] + m["per_layer"]:
        assert mf.UNIT.match(e["unit"]), e
        assert mf.NAME.match(e["name"]), e
    for p in m["per_layer"]:
        for cell in p.get("workloads", []):
            assert cell in mf.cells_reporting(m, p["moves"])
    assert {w["config"] for w in m["workloads"]} == {c["name"] for c in m["configs"]}
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    for w in m["workloads"]:
        assert mf.per_layer_for(m, w["name"])


@pytest.mark.parametrize("edit, message", [
    (lambda m: m["workloads"][0].update(name="bad name"), "not a name"),
    (lambda m: m["end_to_end"][0].update(unit="tokens per s"), "unit"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "unknown metric"),
    (lambda m: m["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda m: m["configs"].append(dict(m["configs"][0], name="lonely")), "needs a cell"),
    (lambda m: [w.update(chips=4) for w in m["workloads"]], "four-chip"),
    (lambda m: m["per_layer"][0].update(why="extra key"), "unknown"),
])
def test_contract_refusals(edit, message):
    m = json.loads((mf.ROOT / "BENCHMARK.json").read_text())
    edit(m)
    with pytest.raises(mf.ManifestError, match=message):
        mf.validate(m)


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """A copy of the benchmark's files that the manifest module reads."""
    shutil.copytree(mf.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(mf.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(mf, "HERE", tmp_path / "port_bench")
    monkeypatch.setattr(mf, "ROOT", tmp_path)
    return tmp_path


def test_a_new_workload_file_is_picked_up(tree):
    traffic = json.loads((tree / "port_bench/traffic/scale-131072x200.json").read_text())
    traffic["rows"] = 65536
    (tree / "port_bench/traffic/scale-65536x200.json").write_text(json.dumps(traffic))
    m = json.loads((tree / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "cvae-scale-64k", "config": "cvae",
                           "traffic": "scale-65536x200", "chips": 1, "why": "half the corpus"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "cvae-scale-bf16" in e.get("workloads", []):
            e["workloads"].append("cvae-scale-64k")
    (tree / "BENCHMARK.json").write_text(json.dumps(m))
    loaded = mf.load()
    _, _, t = mf.cell(loaded, "cvae-scale-64k")
    assert t["rows"] == 65536 and t["driver"] == "scale_train"
    assert "cvae-scale-64k" in mf.cells_reporting(loaded, "setup_s")


def test_a_file_without_an_entry_is_refused(tree):
    (tree / "port_bench/layer_metrics/orphan.py").write_text("def read(*a):\n    return 1\n")
    with pytest.raises(mf.ManifestError, match="orphan"):
        mf.load()


def test_an_entry_without_a_file_is_refused(tree):
    (tree / "port_bench/traffic/serve-b16-closed.json").unlink()
    with pytest.raises(mf.ManifestError, match="no file"):
        mf.load()
