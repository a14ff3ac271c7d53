"""Multi-process herd: processes that walk the lane shards of one herd.

Counterpart of scripts/multihost_demo.py, where 2 processes form one
global JAX mesh (jax.distributed) and walk a herd sharded over it.  Here
`procs` processes form one torch.distributed group over gloo (the
rendezvous store on a port the OS picks), and each walks its own lanes
of one herd with the production sharded window (sharding.make_shards
from its first lane, herd_mod.create_herd_shards, make_sharded_jump_steps)
on its card (cuda:rank when there are enough, else a shared one) or on
the CPU.  Rank 0 gathers the outputs and checks them against a
one-process walk of the whole herd (one window, bit-equal; py mod p,
the walk's contract); an all_reduce of the DP hit counts must equal the
one-process total.  The walk itself needs no collective: the gather and
the reduction are the check, and the channel a sharded DP reduction
would ride.  Every wait is bounded by `timeout`.

    python -m kangaroo_torch.parallel.multihost [--procs 2]
        [--device cuda|cpu] [--lanes N] [--steps S] [--dp D]
        [--timeout SECONDS]

prints the result as one JSON line and exits 0 when the walk checks.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RANGE_POWER = 64
KEY = 0xDEADBEEF12345
SEED = 99
SLOTS = 2
NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")


def _worker(rank: int, world: int, port: int, device: str, lanes: int,
            steps: int, dp: int, timeout: float, out: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..core import curve, herd as herd_mod
    from ..core.jumptable import create_jump_table
    from ..ops import field, jump_cuda, jump_ref
    from ..utils.rng import MT19937
    from . import sharding

    td = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=td)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=td)
    try:
        if device == "cuda":
            dev = sharding.resolve_devices(0, "cuda")
            dev = dev[rank % len(dev)]
        else:
            dev = torch.device("cpu")
        per = lanes // world
        shards = sharding.make_shards([dev], per, lo=rank * per)
        wd2 = ((1 << RANGE_POWER) - 1) >> 1
        key = curve.mul(KEY)
        tables = sharding.replicate(shards, *(
            torch.from_numpy(a.astype(np.int32))
            for a in create_jump_table(RANGE_POWER).as_arrays()),
            jump_ref.dp_limb_masks(dp))
        herds = [list(h) + [None] for h in herd_mod.create_herd_shards(
            lanes, RANGE_POWER, wd2, key, shards, rng=MT19937(SEED))]
        tick = sharding.make_sharded_jump_steps(shards, steps, SLOTS)
        launches, calls = jump_cuda.LAUNCHES, jump_ref.CALLS
        t = time.time()
        outs = tick(herds, tables)
        sharding.synchronize(shards)
        walk_s = time.time() - t
        launches = jump_cuda.LAUNCHES - launches
        calls = jump_ref.CALLS - calls
        local = [torch.cat([o[k] for o in outs], dim=-1).cpu().contiguous()
                 for k in range(len(NAMES))]
        hits = local[3].sum().to(torch.int64).reshape(1)
        dist.all_reduce(hits)
        info = torch.tensor([launches, calls, int(walk_s * 1e6)],
                            dtype=torch.int64)
        infos = [torch.zeros_like(info) for _ in range(world)]
        dist.all_gather(infos, info)
        gathered = []
        for t_loc in local:
            parts = ([torch.empty_like(t_loc) for _ in range(world)]
                     if rank == 0 else None)
            dist.gather(t_loc, parts, dst=0)
            gathered.append(torch.cat(parts, dim=-1) if rank == 0 else None)
        if rank == 0:
            px, py, d = herd_mod.create_herd(lanes, RANGE_POWER, wd2, key, 0,
                                             MT19937(SEED), device=dev)
            ref = [t.cpu() for t in jump_cuda.jump_steps_with_dp(
                px, py, d, *tables[0], nb_run=steps, slots=SLOTS)]
            errs = {}
            for name, a, b in zip(NAMES, gathered, ref):
                if name == "py":  # the plain walk's py is relaxed
                    a, b = field.canonicalize(a), field.canonicalize(b)
                errs[name] = int((a.long() - b.long()).abs().max())
            res = {
                "processes": world, "device": str(dev),
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "lanes": lanes, "lanes_per_process": per, "steps": steps,
                "dp": dp, "slots": SLOTS,
                "bit_equal": not any(errs.values()), "max_abs_err": errs,
                "reduced_hits": int(hits), "one_process_hits":
                    int(ref[3].sum()),
                "launches": [int(i[0]) for i in infos],
                "plain_calls": [int(i[1]) for i in infos],
                "walk_s": [int(i[2]) / 1e6 for i in infos],
            }
            with open(out, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(procs: int = 2, device: str = "cuda", lanes: int = 1 << 21,
        steps: int = 256, dp: int = 14, timeout: float = 600.0) -> dict:
    """Start `procs` worker processes on one herd of `lanes` lanes and
    return rank 0's result (see the module's note); raises RuntimeError
    when a worker fails or the whole run outlasts `timeout` seconds (the
    workers are then killed)."""
    import torch.distributed as dist

    if lanes % procs:
        raise ValueError(f"{lanes} lanes do not split over {procs} "
                         f"processes")
    td = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False, timeout=td)
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(root)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    deadline = time.time() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(procs)]
        workers = []
        try:
            for r in range(procs):
                with open(logs[r], "w") as log:
                    workers.append(subprocess.Popen(
                        [sys.executable, "-m", __spec__.name, "--worker",
                         str(r), "--port", str(store.port), "--procs",
                         str(procs), "--device", device, "--lanes",
                         str(lanes), "--steps", str(steps), "--dp", str(dp),
                         "--timeout", str(timeout), "--out", out],
                        cwd=root, env=env, stdout=log,
                        stderr=subprocess.STDOUT))
            rcs = [w.wait(timeout=max(1.0, deadline - time.time()))
                   for w in workers]
        except subprocess.TimeoutExpired:
            rcs = None
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                    w.wait()
        if rcs is None or any(rcs) or not os.path.exists(out):
            tails = "".join(
                f"\n--- rank {r} ---\n" + Path(p).read_text()[-3000:]
                for r, p in enumerate(logs) if os.path.exists(p))
            raise RuntimeError(f"multi-process walk failed (exit codes "
                               f"{rcs}, bound {timeout:.0f} s):{tails}")
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--lanes", type=int, default=1 << 21)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--dp", type=int, default=14)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    if a.worker is not None:
        _worker(a.worker, a.procs, a.port, a.device, a.lanes, a.steps, a.dp,
                a.timeout, a.out)
        return 0
    res = run(a.procs, a.device, a.lanes, a.steps, a.dp, a.timeout)
    print(json.dumps(res))
    ok = res["bit_equal"] and res["reduced_hits"] == res["one_process_hits"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
