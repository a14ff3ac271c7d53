"""The four-card search cell on four cards at its own size (`cuda`
marker: the tests skip where there are fewer than four cards).  A sound
run is correct; the control, every other DP dropped before the drain,
and a run whose shards but the first never reach the host table are
not.

    python3 -m pytest portbench/tests/test_portbench_card4.py -m cuda
"""

import pytest

from pb_tiny import run_cell

pytestmark = pytest.mark.cuda

CELL = "puzzle85-4card.search"


@pytest.fixture
def four_cards():
    torch = pytest.importorskip("torch")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 4:
        pytest.skip(f"needs 4 CUDA cards, {have} available")


def test_four_card_cell_correct(four_cards):
    rc, res, err = run_cell(None, CELL, seed=2_147_483_903, seconds=10,
                            device="cuda")
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == 4


@pytest.mark.parametrize("fault", ["drop_dps", "drop_shard"])
def test_four_card_control_not_correct(four_cards, fault):
    rc, res, err = run_cell(None, CELL, seed=2_147_483_904, seconds=45,
                            device="cuda", fault=fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, err[-3000:]
    assert res["checks"]["dp_missing"]["value"] > 0
