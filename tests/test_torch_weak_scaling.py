"""The port's weak-scaling harness (kangaroo_torch.parallel.weak_scaling)
against the JAX script scripts/weak_scaling.py, on the CPU.

The JAX script runs here on the conftest's 8-device CPU mesh with its
sharded step replaced by a stub that records what it is handed: the
herd, jump table and masks it draws per size.  The port's harness must
draw the same arrays (tolerance 0); one tick of it over 8 CPU shards
must equal the JAX package's sharded step over the 8-device mesh on the
same inputs with the same slot count (the reference's lockstep: px
canonical, d, count and every DP slot bit-equal, py equal mod p,
kangaroo_tpu/core/check.py:330-333); and the mechanics that
tests/test_scaling.py asserts of the JAX harness must hold for the
port's: the drain far below the kernel time, the total rate not falling
with the shard count.  The rows and the payload carry the JAX script's
keys.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from kangaroo_tpu.ops import jump_ref as jref  # noqa: E402
from kangaroo_tpu.parallel import sharding as jsharding  # noqa: E402
from kangaroo_torch.ops import field  # noqa: E402
from kangaroo_torch.parallel import weak_scaling  # noqa: E402

# tests/test_scaling.py's sizes and lanes.  The port's CPU shards walk in
# turn, so 8 of them hold the total rate of one (the JAX mesh's virtual
# devices run at once): the sizes are timed in PASSES turns of one
# 2-step tick each, so that both sample the same stretch of a host that
# the suite's other workers share
SIZES, LANES, NB_RUN, REPS, PASSES = (1, 8), 512, 2, 1, 16
NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")
ROW_KEYS = {"devices", "lanes_per_device", "kernel_s_per_tick",
            "drain_s_per_tick", "mks", "mks_per_device", "weak_scaling_eff"}


def _jax_script(monkeypatch, **kw):
    """scripts/weak_scaling.py's run_sizes(**kw), or main() when kw holds
    argv, with its sharded step a stub that records its inputs by lane
    count (the walk itself is compared below): {n: (px, py, d, jx, jy,
    jd, masks)} and the script's return."""
    seen = {}

    def make(mesh, nb_run, **_):
        def step(px, py, d, jx, jy, jd, ms, symclass):
            n = px.shape[1]
            seen.setdefault(n, tuple(np.asarray(a) for a in (
                px, py, d, jx, jy, jd, ms)))
            z = jnp.zeros((2, n), jnp.uint32)
            return (px, py, d, jnp.zeros((n,), jnp.uint32),
                    jnp.zeros((2, 10, n), jnp.uint32),
                    jnp.zeros((2, 8, n), jnp.uint32), z)
        return step

    monkeypatch.setattr(jsharding, "make_sharded_jump_steps", make)
    sys.modules.pop("scripts.weak_scaling", None)
    import scripts.weak_scaling as script

    if "argv" in kw:
        monkeypatch.setattr(sys, "argv", kw["argv"])
        return seen, script.main()
    return seen, script.run_sizes(**kw)


@pytest.fixture(scope="module")
def port_run():
    """The port's run_sizes at tests/test_scaling.py's shapes on 8 CPU
    shards, with each size's first-tick inputs kept."""
    kept = {}

    def keep(nd, inputs, shards, outs):
        kept[nd] = inputs

    results, devices = weak_scaling.run_sizes(
        sizes=SIZES, lanes_per_dev=LANES, nb_run=NB_RUN, reps=REPS,
        device="cpu", passes=PASSES, on_first_tick=keep)
    return results, devices, kept


def test_inputs_equal_the_jax_scripts(port_run, monkeypatch):
    """Herd, jump table and masks at sizes 1 and 8, tolerance 0."""
    seen, _ = _jax_script(monkeypatch, sizes=SIZES, lanes_per_dev=LANES,
                          nb_run=NB_RUN, reps=1)
    _, _, kept = port_run
    assert sorted(seen) == [LANES * nd for nd in SIZES]
    names = ("px", "py", "d", "jx", "jy", "jd", "masks")
    for nd in SIZES:
        for name, a, b in zip(names, kept[nd], seen[LANES * nd]):
            assert a.shape == b.shape, (nd, name)
            np.testing.assert_array_equal(
                np.asarray(a).astype(np.uint32), b.astype(np.uint32),
                err_msg=f"size {nd}: {name}")


def test_sharded_tick_equals_jax_mesh_step():
    """One tick over 8 CPU shards against make_sharded_jump_steps over
    the 8-device mesh (backend xla) on the same inputs and slot count.
    dp 4 and 16 lanes a shard, 4 steps: ~32 DPs, so that the slots carry
    some (the script's dp 16 would leave them empty at this size)."""
    kept = {}

    def keep(nd, inputs, shards, outs):
        kept["in"] = inputs
        kept["out"] = [torch.cat([o[k] for o in outs], dim=-1)
                       for k in range(len(outs[0]))]
        kept["lanes"] = [(s.lo, s.hi) for s in shards]

    rows, _ = weak_scaling.run_sizes(sizes=(8,), lanes_per_dev=16,
                                     nb_run=NB_RUN, reps=1, device="cpu",
                                     dp_bits=4, on_first_tick=keep)
    slots = rows[0]["slots"]
    assert kept["lanes"] == [(16 * i, 16 * i + 16) for i in range(8)]
    px, py, d, jx, jy, jd, masks = kept["in"]
    np.testing.assert_array_equal(masks, np.asarray(jref.dp_limb_masks(4)))

    mesh = jsharding.make_mesh()
    repl = jsharding.replicated(mesh)
    step = jsharding.make_sharded_jump_steps(mesh, NB_RUN, inv_stop=16,
                                             backend="xla", slots=slots)
    hx, hy, hd = jsharding.shard_herd(mesh, *(jnp.asarray(a)
                                              for a in (px, py, d)))
    sc = jax.device_put(jnp.zeros((px.shape[1],), jnp.uint32),
                        NamedSharding(mesh, P(jsharding.HERD_AXIS)))
    want = step(hx, hy, hd, *(jax.device_put(jnp.asarray(a), repl)
                              for a in (jx.astype(np.uint32),
                                        jy.astype(np.uint32),
                                        jd.astype(np.uint32), masks)), sc)
    got = kept["out"]
    assert len(got) == len(NAMES)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        if name == "py":  # relaxed in the plain walk: equal mod p
            g = field.canonicalize(g)
            w = field.canonicalize(torch.from_numpy(w.astype(np.int32)))
            w = w.numpy()
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      w.astype(np.uint32), err_msg=name)
    assert int(got[3].sum()) > 0  # DPs were captured
    assert rows[0]["dps_per_tick"] == int(got[3].clamp(max=slots).sum())


def test_mechanics_of_the_jax_harness_hold(port_run):
    """tests/test_scaling.py's assertions on the port's rows: two rows,
    the second on 8 shards; drain below half the kernel time on each;
    the total rate at 8 shards above 0.8x one shard's (the kernel time
    a size's mean over its passes)."""
    results, devices, _ = port_run
    assert len(devices) == 8 and all(d.type == "cpu" for d in devices)
    assert len(results) == 2
    one, eight = results
    assert eight["devices"] == 8
    for r in results:
        assert len(r["kernel_s_per_pass"]) == PASSES
        assert r["drain_s_per_tick"] < 0.5 * r["kernel_s_per_tick"], r
        assert len(r["drain_s_per_shard"]) == r["devices"]
        assert r["drain_s_per_tick"] == max(r["drain_s_per_shard"])
    assert eight["mks"] > 0.8 * one["mks"], (one, eight)
    assert (one["shared"], eight["shared"]) == (False, True)


def test_rows_and_payload_carry_the_jax_scripts_fields(port_run, tmp_path,
                                                       monkeypatch):
    """The port's rows hold every key of the JAX script's rows, and
    main() writes the JAX payload's fields (the CPU caveat included)."""
    monkeypatch.chdir(tmp_path)
    jout = tmp_path / "jax.json"
    _jax_script(monkeypatch, argv=["weak_scaling.py", "--out", str(jout)])
    jpay = json.loads(jout.read_text())
    out = tmp_path / "torch.json"
    assert weak_scaling.main(["--device", "cpu", "--sizes", "1,2",
                              "--lanes", "32", "--nb-run", "2", "--reps",
                              "1", "--out", str(out)]) == 0
    pay = json.loads(out.read_text())
    assert set(jpay) <= set(pay), (set(jpay), set(pay))
    assert pay["platform"] == jpay["platform"] == "cpu"
    assert "NOT hardware scaling" in pay["caveat"]
    assert [r["devices"] for r in pay["results"]] == [1, 2]
    for rows in (pay["results"], port_run[0]):
        for r in rows:
            assert set(jpay["results"][0]) <= set(r) and ROW_KEYS <= set(r)
    assert pay["results"][0]["weak_scaling_eff"] == 1.0


def test_card_asked_for_without_one_raises(monkeypatch):
    """The default device is the card; asked for one where there is
    none, the harness raises and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(weak_scaling, "draw_herd",
                        lambda *a: calls.append(a))
    for device in ("cuda", "cuda:0,cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            weak_scaling.run_sizes(sizes=(1,), device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weak_scaling.main(["--sizes", "1", "--out",
                           os.devnull])
    assert calls == []
