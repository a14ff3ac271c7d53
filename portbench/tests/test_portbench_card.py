"""The cells on the card at their own size (`cuda` marker: they skip
where there is no card).  A sound run is correct; the control, every
other DP dropped before the drain, is not.

    python3 -m pytest portbench/tests/test_portbench_card.py -m cuda
"""

import pytest

from pb_tiny import run_cell

pytestmark = pytest.mark.cuda

ONE_CARD = ("puzzle85.search", "puzzle85.search-sym", "batch40.keys")


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.device_count()


@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_correct_on_the_card(card, cell):
    rc, res, err = run_cell(None, cell, seed=2_147_483_901, seconds=10,
                            device="cuda")
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_not_correct_on_the_card(card, cell):
    rc, res, err = run_cell(None, cell, seed=2_147_483_902, seconds=45,
                            device="cuda", fault="drop_dps")
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, err[-3000:]
    assert res["checks"]["dp_missing"]["value"] > 0
