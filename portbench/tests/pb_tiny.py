"""A copy of the benchmark's data at sizes a CPU test can hold, and a way
to run one of its cells there (`python -m portbench.run --device cpu`).

Each configuration keeps its kind but shrinks: 64 lanes a card (128 for
the batch), a 2^40 range for the searches and a 2^24 one for the batch,
16 steps a tick at dp 4 for the searches, dp 3 and a set of 4 keys for
the batch.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "search": {"lanes_per_card": 64, "range_start": "8000000000",
               "range_end": "17FFFFFFFFF", "dp_size": 4, "nb_run": 16,
               "windows_per_tick": 1},
    "batch": {"lanes_per_card": 128, "range_start": "1000000",
              "range_end": "1FFFFFF", "dp_size": 3},
}


def make_root(tmp: Path, max_ticks: int = 400) -> Path:
    """A data root under tmp: BENCHMARK.json and portbench/{configs,
    traffic, drivers, metrics} copied, the configurations shrunk, and a
    search cell on four shards added (`puzzle85-4shard.search`: the
    path of a cell on four cards, here four CPU shards)."""
    root = Path(tmp) / "root"
    (root / "portbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(REPO / "portbench" / d, root / "portbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    four = json.loads((root / "portbench/configs/puzzle85.json").read_text())
    four["cards"] = 4
    (root / "portbench/configs/puzzle85-4shard.json").write_text(
        json.dumps(four))
    bench["configs"].append({"name": "puzzle85-4shard", "source": "test",
                             "file": "portbench/configs/puzzle85-4shard.json",
                             "reduced": [], "why": "four shards"})
    bench["workloads"].append({"name": "puzzle85-4shard.search",
                               "config": "puzzle85-4shard",
                               "traffic": "search", "chips": 4,
                               "why": "four shards"})
    for m in bench["end_to_end"]:
        if m["name"] == "search_rate":
            m["workloads"].append("puzzle85-4shard.search")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic_of = {w["config"]: w["traffic"] for w in bench["workloads"]}
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        mix = json.loads((root / "portbench" / "traffic"
                          / f"{traffic_of[c['name']]}.json").read_text())
        cfg.update(TINY[mix["driver"]])
        path.write_text(json.dumps(cfg))
    keys = root / "portbench" / "traffic" / "keys.json"
    mix = json.loads(keys.read_text())
    mix["max_ticks"] = max_ticks
    mix["key_set"] = 4
    keys.write_text(json.dumps(mix))
    return root


def run_cell(root: Path, cell: str, seed: int, seconds: float = 1.0,
             fault: str = "", trace: int = 0, device: str = "cpu",
             timeout: float = 600.0):
    """One run of the harness in its own process; returns (exit code,
    the result line as a dict or None, standard error)."""
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace), "--device", device]
    if root is not None:
        cmd += ["--root", str(root)]
    if fault:
        cmd += ["--fault", fault]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    result = None
    if lines and lines[-1].startswith("{"):
        result = json.loads(lines[-1])
    return p.returncode, result, p.stderr
