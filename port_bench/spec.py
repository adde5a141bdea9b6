"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration's file is the ``file`` of its entry in ``configs``;
- a traffic mix ``<mix>`` is ``port_bench/traffic/<mix>.json``;
- a per-layer metric ``<metric>`` is read by ``port_bench/metrics/<metric>.py``
  (its ``read(ctx)``);
- the limits of a cell ``<workload>`` are ``port_bench/limits/<workload>.json``.

A cell added as new files and a new entry in ``BENCHMARK.json`` is run
with no change here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = "port_bench"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def load(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench, name, root=ROOT):
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _data(root, folder, name):
    with open(Path(root) / HERE / folder / f"{name}.json") as f:
        return json.load(f)


def traffic(name, root=ROOT):
    return _data(root, "traffic", name)


def limits(workload_name, root=ROOT):
    return _data(root, "limits", workload_name)


def metric_reader(name, root=ROOT):
    """``read(ctx)`` of the metric's own file."""
    path = Path(root) / HERE / "metrics" / f"{name}.py"
    mod_name = "port_bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric, wl_name):
    return "workloads" not in metric or wl_name in metric["workloads"]


def end_to_end(bench, wl_name):
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"] if _applies(m, wl_name)]


def per_layer(bench, wl_name):
    """The per-layer metrics a cell reports: those that list it, or,
    without a list, those whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, wl_name)}

    def reported(m):
        if "workloads" in m:
            return wl_name in m["workloads"]
        return m["moves"] in e2e
    return [m for m in bench["per_layer"] if reported(m)]


def problems(bench):
    """What in ``bench`` breaks the contract's rules of names, units and
    references between entries (an empty list when nothing does)."""
    out = []

    def name_ok(kind, s):
        if not isinstance(s, str) or not NAME.fullmatch(s):
            out.append(f"{kind} {s!r} is not a name")

    for key in ("command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"):
        if key not in bench:
            out.append(f"missing {key}")
    for p in bench.get("paths", []):
        if not PATH.fullmatch(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    configs = {c["name"] for c in bench.get("configs", [])}
    for c in bench.get("configs", []):
        name_ok("configuration", c["name"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
    e2e = {m["name"] for m in bench.get("end_to_end", [])}
    cells = {w["name"] for w in bench.get("workloads", [])}
    for w in bench.get("workloads", []):
        name_ok("workload", w["name"])
        name_ok("traffic", w["traffic"])
        if w["config"] not in configs:
            out.append(f"workload {w['name']} names no configuration")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} chips {w['chips']}")
        if len(w["why"]) > 200 or "\n" in w["why"]:
            out.append(f"workload {w['name']} why")
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        name_ok("metric", m["name"])
        if not UNIT.fullmatch(m["unit"]):
            out.append(f"unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better {m['better']!r}")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"metric {m['name']} lists no cell {w}")
    for m in bench.get("per_layer", []):
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']} moves no end-to-end metric")
    names = [m["name"] for m in bench.get("end_to_end", []) + bench.get("per_layer", [])]
    if len(set(names)) != len(names):
        out.append("two metrics share a name")
    return out
