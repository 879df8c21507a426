"""``BENCHMARK.json`` and the files it names.

Every configuration, traffic mix, driver and per-layer metric is a file of
its own, found by the name the manifest gives it.  :func:`load` refuses an
entry that has no file and a file that has no entry, so a later change adds
a cell, a configuration or a metric by adding files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class ManifestError(ValueError):
    pass


def _line(s, what, limit=200):
    if not isinstance(s, str) or not 1 <= len(s) <= limit or "\n" in s or "\t" in s:
        raise ManifestError(f"{what}: 1 to {limit} characters on one line, no tab")


def _name(s, what):
    if not isinstance(s, str) or not NAME.match(s):
        raise ManifestError(f"{what} {s!r} is not a name (letters, digits, _ . -, "
                            f"at most 64, not starting with . or -)")


def _keys(entry, allowed, what, optional=()):
    missing = allowed - set(entry)
    extra = set(entry) - allowed - set(optional)
    if missing or extra:
        raise ManifestError(f"{what}: missing {sorted(missing)}, unknown {sorted(extra)}")


def validate(m: dict) -> None:
    """The contract's rules on the manifest itself."""
    if set(m) != KEYS:
        raise ManifestError(f"BENCHMARK.json keys {sorted(m)} != {sorted(KEYS)}")
    if not 1 <= int(m["run_seconds"]) <= 51 or m["run_seconds"] != int(m["run_seconds"]):
        raise ManifestError("run_seconds must be a whole number from 1 to 51")
    if not 1 <= len(m["paths"]) <= 16:
        raise ManifestError("1 to 16 paths")
    for p in m["paths"]:
        if not re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) or p.startswith("/") or ".." in p:
            raise ManifestError(f"path {p!r}")
    if not 1 <= len(m["command"]) <= 32:
        raise ManifestError("the command is 1 to 32 words")
    for w in m["command"]:
        _line(w, "a word of the command")
    names = set()
    for c in m["configs"]:
        _keys(c, CONFIG_KEYS, f"config {c.get('name')}")
        _name(c["name"], "config")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if len(c["reduced"]) > 16:
            raise ManifestError(f"config {c['name']}: at most 16 reduced keys")
        for k in c["reduced"]:
            _name(k, "a reduced key")
    configs = {c["name"] for c in m["configs"]}
    if len(configs) != len(m["configs"]) or not 1 <= len(configs) <= 24:
        raise ManifestError("1 to 24 configurations, each named once")
    pairs, cells = set(), set()
    for w in m["workloads"]:
        _keys(w, CELL_KEYS, f"workload {w.get('name')}")
        _name(w["name"], "workload")
        _name(w["traffic"], "traffic")
        _line(w["why"], f"workload {w['name']} why")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips must be 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"workload {w['name']}: its config and traffic repeat a cell")
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    if len(cells) != len(m["workloads"]) or not 1 <= len(cells) <= 24:
        raise ManifestError("1 to 24 workloads, each named once")
    four = sum(w["chips"] == 4 for w in m["workloads"])
    if four > max(1, len(cells) // 4):
        raise ManifestError(f"{four} four-chip cells of {len(cells)}")
    if configs - {w["config"] for w in m["workloads"]}:
        raise ManifestError("every configuration needs a cell")
    e2e = {}
    for e in m["end_to_end"]:
        _keys(e, E2E_KEYS, f"metric {e.get('name')}", optional=("workloads",))
        _name(e["name"], "metric")
        if e["source"] not in E2E_SOURCES:
            raise ManifestError(f"{e['name']}: an end-to-end source is host_clock or device_trace")
        if not 0.01 <= e["bound"] <= 0.25:
            raise ManifestError(f"{e['name']}: bound from 0.01 to 0.25")
        e2e[e["name"]] = e
    if "setup_s" not in e2e or not 1 <= len(e2e) <= 16:
        raise ManifestError("1 to 16 end-to-end metrics, setup_s among them")
    for e in list(m["end_to_end"]) + list(m["per_layer"]):
        if not UNIT.match(e["unit"]):
            raise ManifestError(f"{e['name']}: unit {e['unit']!r}")
        if e["better"] not in ("lower", "higher"):
            raise ManifestError(f"{e['name']}: better is lower or higher")
        for cell in e.get("workloads", []):
            if cell not in cells:
                raise ManifestError(f"{e['name']}: unknown workload {cell!r}")
    layer_names = set()
    for p in m["per_layer"]:
        _keys(p, LAYER_KEYS, f"metric {p.get('name')}", optional=("workloads",))
        _name(p["name"], "metric")
        _line(p["layer"], f"{p['name']} layer")
        if p["source"] not in SOURCES:
            raise ManifestError(f"{p['name']}: source {p['source']!r}")
        if p["moves"] not in e2e:
            raise ManifestError(f"{p['name']}: moves an unknown metric {p['moves']!r}")
        for cell in p.get("workloads", []):
            if cell not in cells_reporting(m, p["moves"]):
                raise ManifestError(f"{p['name']}: {cell} does not report {p['moves']}")
        layer_names.add(p["name"])
    if len(layer_names) != len(m["per_layer"]) or not 1 <= len(layer_names) <= 128:
        raise ManifestError("1 to 128 per-layer metrics, each named once")
    if layer_names & set(e2e):
        raise ManifestError("a per-layer metric shares a name with an end-to-end one")
    for cell in cells:
        got = [e for e in e2e if cell in cells_reporting(m, e)]
        if "setup_s" not in got or len(got) < 2:
            raise ManifestError(f"{cell}: reports setup_s and one more end-to-end metric")
        if not per_layer_for(m, cell):
            raise ManifestError(f"{cell}: reports no per-layer metric")


def cells_reporting(m: dict, metric: str):
    """The cells that report end-to-end ``metric``."""
    e = next(x for x in m["end_to_end"] if x["name"] == metric)
    return e.get("workloads", [w["name"] for w in m["workloads"]])


def end_to_end_for(m: dict, cell: str):
    return [e for e in m["end_to_end"] if cell in cells_reporting(m, e["name"])]


def per_layer_for(m: dict, cell: str):
    return [p for p in m["per_layer"]
            if cell in p.get("workloads", cells_reporting(m, p["moves"]))]


def _stems(folder: str, suffix: str):
    return {p.name[:-len(suffix)] for p in (HERE / folder).glob("*" + suffix)
            if p.name != "__init__.py"}


def check_files(m: dict) -> None:
    """Each entry has its file and each file its entry."""
    cfg_files = {(ROOT / c["file"]).resolve() for c in m["configs"]}
    for c in m["configs"]:
        if not (ROOT / c["file"]).is_file():
            raise ManifestError(f"config {c['name']}: no file {c['file']}")
        if pathlib.Path(c["file"]).stem != c["name"] or pathlib.Path(c["file"]).parent != \
                pathlib.Path(HERE.name, "configs"):
            raise ManifestError(f"config {c['name']}: its file is configs/{c['name']}.json")
    for p in (HERE / "configs").glob("*.json"):
        if p.resolve() not in cfg_files:
            raise ManifestError(f"{p.name}: a configuration file with no entry")
    traffic = {w["traffic"] for w in m["workloads"]}
    for t in traffic:
        if not (HERE / "traffic" / f"{t}.json").is_file():
            raise ManifestError(f"traffic {t}: no file traffic/{t}.json")
    if _stems("traffic", ".json") - traffic:
        raise ManifestError(f"traffic files with no cell: {sorted(_stems('traffic', '.json') - traffic)}")
    drivers = {load_traffic(t)["driver"] for t in traffic}
    for d in drivers:
        if not (HERE / "drivers" / f"{d}.py").is_file():
            raise ManifestError(f"driver {d}: no file drivers/{d}.py")
    if _stems("drivers", ".py") - drivers:
        raise ManifestError(f"drivers no traffic names: {sorted(_stems('drivers', '.py') - drivers)}")
    metrics = {p["name"] for p in m["per_layer"]}
    for name in metrics:
        if not (HERE / "layer_metrics" / f"{name}.py").is_file():
            raise ManifestError(f"metric {name}: no reader layer_metrics/{name}.py")
    if _stems("layer_metrics", ".py") - metrics:
        raise ManifestError(f"readers of no metric: {sorted(_stems('layer_metrics', '.py') - metrics)}")


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        t = json.load(f)
    if "driver" not in t:
        raise ManifestError(f"traffic {name}: names no driver")
    _name(t["driver"], "driver")
    return t


def load(path=None) -> dict:
    """The manifest, checked against the contract and against the files."""
    path = ROOT / "BENCHMARK.json" if path is None else pathlib.Path(path)
    with open(path) as f:
        m = json.load(f)
    validate(m)
    check_files(m)
    return m


def cell(m: dict, name: str):
    """(workload entry, configuration dict, traffic dict) of cell ``name``."""
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise ManifestError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(ROOT / c["file"]) as f:
        config = json.load(f)
    return w, config, load_traffic(w["traffic"])


def reader(metric: str):
    """The ``read`` function of per-layer metric ``metric``'s reader."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.layer_metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """The ``Driver`` class of driver ``name``."""
    return importlib.import_module(f"port_bench.drivers.{name}").Driver
