"""The benchmark's data: BENCHMARK.json against its contract, every cell
found by name with its configuration, traffic, driver and readers, and a
cell, configuration, traffic mix and metric added by files and entries
alone."""

import json
import re
import shutil

import pytest

from pb_tiny import REPO
from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200 and c["source"].startswith(
            "https://")
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"setup_s", "search_rate", "keys_per_s",
                        "key_s_p80"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_metrics_need():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]], (m["name"], w)
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for w in cells:
        assert any(w in s for k, s in e2e.items() if k != "setup_s")
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    c = bench.cell(name)
    assert c.config["source"]
    assert c.config["guarantees"]
    assert set(c.config["reduced"]) == set(
        next(x["reduced"] for x in BENCH["configs"]
             if x["name"] == c.config_name))
    assert bench.driver(c).run
    readers = bench.readers(c)
    assert set(readers) == {m["name"] for m in c.per_layer}
    assert all(callable(r.read) for r in readers.values())


def test_cell_added_by_data_alone(tmp_path):
    """A new configuration, traffic mix, per-layer metric and cell, each a
    file and an entry, in a temporary copy of the data."""
    root = tmp_path / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench/configs/puzzle85.json").read_text())
    cfg["dp_size"] = 18
    (root / "portbench/configs/puzzle85-dp18.json").write_text(
        json.dumps(cfg))
    (root / "portbench/traffic/search-long.json").write_text(json.dumps(
        {"driver": "search", "symmetry": False, "warmup_ticks": 3,
         "sample_lanes": 8, "sample_records": 16}))
    (root / "portbench/metrics/ticks_in_window.py").write_text(
        "def read(ctx):\n    return ctx['outcome'].program.get('ticks')\n")
    b["configs"].append({"name": "puzzle85-dp18", "source": "https://x",
                         "file": "portbench/configs/puzzle85-dp18.json",
                         "reduced": [], "why": "dp 18"})
    b["workloads"].append({"name": "puzzle85-dp18.search-long",
                           "config": "puzzle85-dp18",
                           "traffic": "search-long", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "ticks_in_window", "unit": "ticks",
                           "better": "higher", "source": "program_counter",
                           "layer": "solver loop", "moves": "search_rate",
                           "workloads": ["puzzle85-dp18.search-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = bench.cell("puzzle85-dp18.search-long", root)
    assert c.config["dp_size"] == 18 and c.traffic["warmup_ticks"] == 3
    assert c.chips == 1
    readers = bench.readers(c)
    assert list(readers) == ["ticks_in_window"]

    class Out:
        program = {"ticks": 7}

    assert readers["ticks_in_window"].read({"outcome": Out}) == 7
    assert bench.driver(c).__file__.startswith(str(root))
    with pytest.raises(KeyError):
        bench.cell("puzzle85-dp18.search-long")
