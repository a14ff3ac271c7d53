"""The CUDA walk kernel against the plain walk, on the card.

Needs a CUDA card (the kernel has no CPU mode) and skips without one.
Imports only the port, so it runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py runs the same comparison at the main path's shape (2^22
lanes, 256 blocks), the plain walk on 64 lanes of every block, for the
plain and the symmetry kernel.
"""

import pytest

torch = pytest.importorskip("torch")

from kangaroo_torch.core import curve, herd  # noqa: E402
from kangaroo_torch.core.jumptable import create_jump_table  # noqa: E402
from kangaroo_torch.ops import field, jump_cuda, jump_ref  # noqa: E402
from kangaroo_torch.utils.rng import MT19937  # noqa: E402

NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dp_size,slots", [(4, 2), (12, 3)],
                         ids=["overflow", "sparse"])
def test_kernel_matches_plain_on_card(card, dp_size, slots):
    rp = 64
    n = 2 * jump_cuda.LANE_QUANTUM
    state = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                             curve.mul(0xDEADBEEF12345), 0, MT19937(3),
                             device=card)
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(rp).as_arrays()]
    masks = jump_ref.dp_limb_masks(dp_size, card)
    launches = jump_cuda.LAUNCHES
    k = jump_cuda.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                     masks, nb_run=32, slots=slots)
    p = jump_ref.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                    masks, nb_run=32, slots=slots)
    torch.cuda.synchronize()
    assert jump_cuda.LAUNCHES == launches + 1
    for name, a, b in zip(NAMES, k, p):
        if name == "py":
            a, b = field.canonicalize(a), field.canonicalize(b)
        assert torch.equal(a, b), name
    assert int(k[3].sum()) > 0
    assert bool((k[3] > slots).any()) == (dp_size == 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dp_size,slots", [(4, 2), (12, 3)],
                         ids=["overflow", "sparse"])
def test_sym_kernel_matches_plain_on_card(card, dp_size, slots):
    """Symmetry kernel vs the plain symmetry walk, from a class input
    that holds both classes: every output bit-equal (py is canonical)."""
    rp = 64
    n = 2 * jump_cuda.LANE_QUANTUM
    state = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                             curve.mul(0xDEADBEEF12345), 1, MT19937(5),
                             device=card, symmetry=True)
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(rp, symmetry=True).as_arrays()]
    masks = jump_ref.dp_limb_masks(dp_size, card)
    gen = torch.Generator().manual_seed(5)
    sc = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
    sc = sc.to(card)
    launches = (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES)
    k = jump_cuda.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                     masks, nb_run=32, slots=slots,
                                     symmetry=True, symclass=sc.clone())
    p = jump_ref.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                    masks, nb_run=32, slots=slots,
                                    symmetry=True, symclass=sc.clone())
    torch.cuda.synchronize()
    assert (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES) == (
        launches[0], launches[1] + 1)
    for name, a, b in zip(NAMES + ("symclass",), k, p):
        assert torch.equal(a, b), name
    assert int(k[3].sum()) > 0
    assert bool((k[3] > slots).any()) == (dp_size == 4)
    assert 0 < int((k[7] != sc).sum()) < n


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    n = jump_cuda.LANE_QUANTUM
    z16 = torch.zeros((16, n), dtype=torch.int32, device=card)
    z8 = torch.zeros((8, n), dtype=torch.int32, device=card)
    t16 = torch.zeros((16, 32), dtype=torch.int32, device=card)
    t8 = torch.zeros((8, 32), dtype=torch.int32, device=card)
    m = jump_ref.dp_limb_masks(8, card)
    with pytest.raises(ValueError, match="lane quantum"):
        jump_cuda.jump_steps_with_dp(z16[:, :64].contiguous(),
                                     z16[:, :64].contiguous(),
                                     z8[:, :64].contiguous(), t16, t16, t8, m)
    with pytest.raises(ValueError, match="nb_run"):
        jump_cuda.jump_steps_with_dp(z16, z16, z8, t16, t16, t8, m,
                                     nb_run=1 << 16)
    with pytest.raises(ValueError, match="int32"):
        jump_cuda.jump_steps_with_dp(z16.long(), z16, z8, t16, t16, t8, m)
    with pytest.raises(ValueError, match="symclass"):
        jump_cuda.jump_steps_with_dp(z16, z16, z8, t16, t16, t8, m,
                                     symmetry=True, symclass=z8[0, :64])
