"""``BENCHMARK.json`` and the files it names, loaded by name."""
import importlib
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]       # portbench/
ROOT = PKG.parent                               # the checkout


def benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _data(kind, name):
    with open(PKG / kind / f"{name}.json") as f:
        return json.load(f)


def cell(workload, overrides=None):
    """The cell ``workload``: ``(bench, work, config, traffic)``; the
    configuration's keys updated from ``overrides`` (smaller sizes, for the
    CPU tests)."""
    bench = benchmark()
    works = {w["name"]: w for w in bench["workloads"]}
    if workload not in works:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(works)}")
    work = works[workload]
    cfg = _data("configs", work["config"])
    cfg.update(overrides or {})
    return bench, work, cfg, _data("traffic", work["traffic"])


def module(kind, name):
    """``portbench.<kind>.<name>``, a module found by the name a data file
    gives (a geometry, a reference, a store, a metric reader)."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def spans():
    """``{span name: [(module, function), ...]}`` from ``spans/*.json``."""
    out = {}
    for p in sorted((PKG / "spans").glob("*.json")):
        with open(p) as f:
            wrap = json.load(f)["wrap"]
        out[p.stem] = [tuple(w.split(":")) for w in wrap]
    return out


def per_layer(bench, workload):
    """The per-layer metrics this cell reports: those with no
    ``workloads`` key and those that list it."""
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])]


def end_to_end(bench, workload):
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]
