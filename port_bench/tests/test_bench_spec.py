"""``BENCHMARK.json`` against the contract's rules of form, and the
harness's lookup of every cell's files by name.

    python -m pytest port_bench/tests -q
"""

import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
LINE = re.compile(r"[^\t\n]{1,200}")
# keys that name a width, which no configuration may reduce
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*_(dim|rank)")


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert spec.problems(BENCH) == []


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys(kind):
    entries = BENCH[kind]
    assert entries
    for e in entries:
        extra = set(e) - ENTRY_KEYS[kind]
        assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
        assert ENTRY_KEYS[kind] <= set(e), e["name"]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.fullmatch(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert spec.PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES
        assert LINE.fullmatch(m["layer"])
        assert m["moves"] in e2e
        for wl in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in spec.end_to_end(BENCH, wl)}, (m, wl)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.per_layer(BENCH, w["name"]), w["name"]
        assert LINE.fullmatch(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    path = ROOT / cfg["file"]
    assert any(cfg["file"].startswith(p + "/") for p in BENCH["paths"])
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert not [k for k in cfg["reduced"] if WIDTH.fullmatch(k)]
    assert LINE.fullmatch(cfg["source"]) and LINE.fullmatch(cfg["why"])
    used = [w for w in BENCH["workloads"] if w["config"] == cfg["name"]]
    assert used
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_by_name(wl):
    assert spec.config(BENCH, wl["config"], ROOT)
    traffic = spec.traffic(wl["traffic"], ROOT)
    assert traffic["call"] in ("simulate", "value_and_grad")
    limits = spec.limits(wl["name"], ROOT)
    assert limits and all(v["limit"] > 0 for v in limits.values())
    for m in spec.per_layer(BENCH, wl["name"]):
        assert callable(spec.metric_reader(m["name"], ROOT))


def test_a_cell_added_as_new_files_is_picked_up(tmp_path):
    """A later PR adds a traffic mix, a metric and a cell's limits as new
    files and one entry each in BENCHMARK.json; the harness finds them
    with no change to its code."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = bench["workloads"][0]
    mix = json.loads((ROOT / "port_bench/traffic" / f"{first['traffic']}.json").read_text())
    mix["n_steps"] = 3
    (tmp_path / "port_bench/traffic/forward_three.json").write_text(json.dumps(mix))
    (tmp_path / "port_bench/metrics/steps_of_first.py").write_text(
        "def read(ctx):\n    return ctx.steps_per_unit\n")
    (tmp_path / "port_bench/limits/new.cell.json").write_text(
        json.dumps({"c_err": {"limit": 1.0}, "u_err": {"limit": 1.0}}))
    bench["workloads"].append({"name": "new.cell", "config": first["config"],
                               "traffic": "forward_three", "chips": 1, "why": "a test"})
    moves = next(m for m in bench["end_to_end"] if m["name"] != "setup_s")
    moves.setdefault("workloads", []).append("new.cell")
    bench["per_layer"].append({"name": "steps_of_first", "unit": "steps", "better": "lower",
                               "source": "program_counter", "layer": "time loop",
                               "moves": moves["name"], "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load(tmp_path)
    assert spec.problems(loaded) == []
    wl = spec.workload(loaded, "new.cell")
    assert spec.traffic(wl["traffic"], tmp_path)["n_steps"] == 3
    assert spec.limits("new.cell", tmp_path)["c_err"]["limit"] == 1.0
    names = [m["name"] for m in spec.per_layer(loaded, "new.cell")]
    assert names == ["steps_of_first"]
    ctx = type("Ctx", (), {"steps_per_unit": 3})()
    assert spec.metric_reader("steps_of_first", tmp_path)(ctx) == 3
