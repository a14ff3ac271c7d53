"""The four-card search cell, `puzzle85-4card.search`, at the tiny size
of `pb_tiny` on four CPU shards: a sound run is correct and its traced
run reads the shard and DP-table metrics; a run whose shards but the
first never reach the host table (`drop_shard`) and the control
(`drop_dps`) are not correct."""

import pytest

from pb_tiny import make_root, run_cell

pytest.importorskip("torch")

CELL = "puzzle85-4card.search"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("pb4"), max_ticks=60)


def test_four_card_cell_is_shrunk_to_four_shards(root):
    from portbench import bench

    c = bench.cell(CELL, root)
    assert c.chips == 4 and c.config["cards"] == 4
    assert c.config["lanes_per_card"] == 64


def test_four_card_cell_traced_run_correct(root):
    # a few ticks in the window, so that some are drained inside a tick
    rc, res, err = run_cell(root, CELL, seed=3_000_000_017, seconds=4.0,
                            trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["device"]["count"] == 4
    m = res["metrics"]
    for name in ("pull_lag_ms", "drain_us_per_dp", "compact_ms_max",
                 "drain_ms_per_tick.search", "herd_s.setup"):
        assert m[name]["value"] >= 0, name
    assert m["drain_us_per_dp"]["value"] > 0


@pytest.mark.parametrize("fault", ["drop_shard", "drop_dps"])
def test_four_card_fault_is_not_correct(root, fault):
    rc, res, err = run_cell(root, CELL, seed=2_147_483_713, fault=fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, err[-3000:]
    assert res["checks"]["dp_missing"]["value"] > 0
