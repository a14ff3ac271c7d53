"""Both drivers end to end on CPU shards at a tiny size, and the
comparison that decides `correct` against the faults planted under the
timed path (`portbench/faults.py`): the control (drop_dps, every other
DP dropped: the guarantee that every DP is kept, broken) and each fault
that a cell can have must come out not correct."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from pb_tiny import REPO, make_root, run_cell

pytest.importorskip("torch")

CELLS = ("puzzle85.search", "puzzle85.search-sym", "batch40.keys",
         "puzzle85-4shard.search")

FAULTS = [
    ("puzzle85.search", "drop_dps"),
    ("puzzle85.search", "stale_step"),
    ("puzzle85.search", "half_lanes"),
    ("puzzle85.search", "alter_dp"),
    ("puzzle85.search-sym", "drop_dps"),
    ("puzzle85.search-sym", "half_lanes"),
    ("puzzle85-4shard.search", "drop_shard"),
    ("batch40.keys", "drop_dps"),
    ("batch40.keys", "stale_step"),
    ("batch40.keys", "half_lanes"),
    ("batch40.keys", "alter_dp"),
    ("batch40.keys", "alter_key"),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("pb"), max_ticks=60)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(root, cell):
    rc, res, err = run_cell(root, cell, seed=3_000_000_017)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["device"]["platform"] == "cpu"
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(root, cell, fault):
    rc, res, err = run_cell(root, cell, seed=2_147_483_713, fault=fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, err[-3000:]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _info(err, name):
    return float(re.search(rf"^info {name} = (\S+)$", err, re.M).group(1))


def test_trace_run_reports_per_layer(root):
    rc, res, err = run_cell(root, "batch40.keys", seed=11, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    # the program's spans are read; the CPU run has no device operation,
    # so the device's idle share is left out, never written as 0
    assert {"herd_s_per_key", "loop_ms_per_tick"} <= set(res["metrics"])
    assert "device_idle.batch" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    # the spans come from the first pass, the trace from the passes after
    assert _info(err, "passes") >= 2
    assert res["device"]["window_s"] < _info(err, "window_s")


@pytest.mark.parametrize("seed", [5, 2_147_483_999])
def test_batch_window_is_whole_passes(root, seed):
    """Every run solves the same keys: whole passes over the key set,
    the seed only orders them."""
    rc, res, err = run_cell(root, "batch40.keys", seed=seed)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    keys, passes = _info(err, "keys"), _info(err, "passes")
    assert passes >= 1 and keys == 4 * passes
    assert _info(err, "keys_whose_ticks_differ") == 0
    assert {"keys_per_s", "key_s_p80", "setup_s"} == set(res["metrics"])


def test_reader_that_loads_jax_gives_no_result(tmp_path):
    """The check for JAX comes after every per-layer reader has been
    loaded and run: a reader that imports (a stand-in for) jax stops the
    run before its result line."""
    r = make_root(tmp_path, max_ticks=60)
    stub = r / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('"""A stand-in for jax."""\n')
    (r / "portbench" / "metrics" / "leaky.py").write_text(
        "import sys\n"
        "from pathlib import Path\n"
        "sys.path.insert(0, str(Path(__file__).resolve().parents[2]"
        " / 'stub'))\n"
        "import jax  # noqa: E402,F401\n\n\n"
        "def read(ctx):\n"
        "    return 1.0\n")
    b = json.loads((r / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "leaky", "unit": "s", "better": "lower",
                           "source": "program_span", "layer": "herd creation",
                           "moves": "search_rate",
                           "workloads": ["puzzle85.search"]})
    (r / "BENCHMARK.json").write_text(json.dumps(b))
    rc, res, err = run_cell(r, "puzzle85.search", seed=21, trace=1)
    assert rc != 0 and res is None, err[-3000:]
    assert "jax" in err.strip().splitlines()[-1]


def test_same_seed_same_inputs(root):
    a = run_cell(root, "puzzle85.search", seed=77)[2]
    b = run_cell(root, "puzzle85.search", seed=77)[2]

    def inputs(err):
        return [ln for ln in err.splitlines()
                if ln.startswith(("info key ", "info herd_seed "))]

    assert inputs(a) == inputs(b) and len(inputs(a)) == 2


def test_no_card_no_result(root):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc, res, err = run_cell(root, "puzzle85.search", seed=1, device="cuda")
    assert rc != 0 and res is None
    assert "CUDA" in err


def test_without_the_port_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, a run
    fails and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "puzzle85.search", "--seed", "1", "--seconds", "1", "--trace", "0",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert p.returncode != 0
    assert not p.stdout.strip()
