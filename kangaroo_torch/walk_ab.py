"""Time the walk kernels of two checkouts on one card, in turns.

    python -m kangaroo_torch.walk_ab DIR_A DIR_B [order=ABBA]

Each turn is a fresh process in one checkout's directory, so that it
builds and imports that checkout's own `kangaroo_torch`; it runs only
the public wrapper `ops.jump_cuda.jump_steps_with_dp` and the probe
`ops.probe_cuda.delta_walk("base", ...)`, which both checkouts have.
Per turn, on the same seeded random herd (2^22 lanes) and the range-64
jump tables: the plain and the symmetry walk kernel at 2^22 lanes x
1024 steps (dp 14, 6 slots; ms per launch by CUDA events, one warm-up and
the mean of 3), the P3 base probe at 2^22 x 64 (dp 20, 6 slots), and
hashes of each kernel's outputs (px, canonical py, d, count, every slot,
symclass): after one 64-step window on that random herd, and after one
whole 1024-step window (dp 16, 4 slots) on a puzzle #85 search herd
(2^22 lanes of an 84-bit range, made by `core.herd.create_herd`, the
herd kernel on a card) with its range-84 tables.  The hashes must agree
across the turns: the two kernels compute the same function.  Prints one
line per turn, the card's name and power limit, and a JSON summary as
the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# run in a checkout's directory by `python3 -c`: its kangaroo_torch
_TURN = r'''
import hashlib, json, sys, time
import numpy as np, torch
from concurrent.futures import ThreadPoolExecutor
from kangaroo_torch.core import curve, herd
from kangaroo_torch.core.jumptable import create_jump_table
from kangaroo_torch.ops import field, jump_cuda, jump_ref, probe_cuda
from kangaroo_torch.profile_walk import cuda_ms
from kangaroo_torch.utils.rng import MT19937

t = time.time()
with ThreadPoolExecutor(2) as ex:
    list(ex.map(lambda f: f(), (jump_cuda.build, probe_cuda.build)))
build_s = time.time() - t
dev = torch.device("cuda", 0)
n = 1 << 22
rng = np.random.RandomState(11)
state = [torch.from_numpy(rng.randint(0, 1 << 16, (r, n)).astype(np.int32)
                          ).to(dev) for r in (16, 16, 8)]
sc0 = torch.from_numpy(rng.randint(0, 2, n).astype(np.int32)).to(dev)
out = {"build_s": build_s}
def digest(r):
    r = list(r)
    r[1] = field.canonicalize(r[1])
    h = hashlib.sha256()
    for x in r:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]
def tables(rp, sym):
    return [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in create_jump_table(rp, symmetry=sym).as_arrays()]
for sym in (False, True):
    rp = 84  # puzzle #85: the range [2^84, 2^85)
    hs = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                          curve.mul(0xA1F5302F24DC55964EECE), 0, MT19937(85),
                          device=dev, symmetry=sym)
    kw = {"symmetry": True,
          "symclass": torch.zeros(n, dtype=torch.int32, device=dev)
          } if sym else {}
    window = digest(jump_cuda.jump_steps_with_dp(
        *hs, *tables(rp, sym), jump_ref.dp_limb_masks(16, dev), nb_run=1024,
        slots=4, **kw))
    del hs, kw
    tabs = tables(64, sym)
    masks = jump_ref.dp_limb_masks(14, dev)
    kw = {"symmetry": True, "symclass": sc0.clone()} if sym else {}
    st = [x.clone() for x in state]
    h = digest(jump_cuda.jump_steps_with_dp(*st, *tabs, masks, nb_run=64,
                                            slots=6, **kw))
    def launch():
        return jump_cuda.jump_steps_with_dp(*st, *tabs, masks, nb_run=1024,
                                            slots=6, **kw)
    launch()
    _, ms = cuda_ms(launch, reps=3)
    out["sym" if sym else "plain"] = {"ms": ms, "hash": h,
                                      "hash_1024": window}
tabs = [torch.from_numpy(a.astype(np.int32)).to(dev)
        for a in create_jump_table(64).as_arrays()]
masks = jump_ref.dp_limb_masks(20, dev)
st = [x.clone() for x in state]
def base():
    return probe_cuda.delta_walk("base", *st, *tabs, masks, 64, 6)
base()
out["pkdelta_base_ms"] = cuda_ms(base, reps=3)[1]
print("TURN " + json.dumps(out), flush=True)
'''


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def turn(directory: Path) -> dict:
    """One turn in `directory`: its kernels' times and output hashes."""
    proc = subprocess.run(
        [sys.executable, "-c", _TURN], cwd=directory,
        capture_output=True, text=True, timeout=1800)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("TURN ")), None)
    if proc.returncode or line is None:
        raise SystemExit(f"turn in {directory} failed ({proc.returncode}):"
                         f"\n{proc.stdout}\n{proc.stderr}")
    return json.loads(line[5:])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    dirs = {"A": Path(argv[0]).resolve(), "B": Path(argv[1]).resolve()}
    order = argv[2] if len(argv) > 2 else "ABBA"
    turns = []
    for k in order:
        r = turn(dirs[k])
        turns.append((k, r))
        print(f"{k} ({dirs[k]}): plain {r['plain']['ms']:.1f} ms, symmetry "
              f"{r['sym']['ms']:.1f} ms per 2^22 x 1024 launch; pkdelta "
              f"base {r['pkdelta_base_ms']:.3f} ms per 2^22 x 64; build "
              f"{r['build_s']:.1f} s; output hashes (64 steps, 1024 on the "
              f"search herd) {r['plain']['hash']} {r['sym']['hash']} "
              f"{r['plain']['hash_1024']} {r['sym']['hash_1024']}",
              flush=True)
    hashes = {tuple(r[m][k] for m in ("plain", "sym")
                    for k in ("hash", "hash_1024")) for _, r in turns}
    summary = {}
    for k in sorted(set(order)):
        rs = [r for kk, r in turns if kk == k]
        summary[k] = {
            "dir": str(dirs[k]),
            "plain_ms": [r["plain"]["ms"] for r in rs],
            "sym_ms": [r["sym"]["ms"] for r in rs],
            "pkdelta_base_ms": [r["pkdelta_base_ms"] for r in rs]}
    print(card())
    print(json.dumps({"order": order,
                      "outputs_agree": len(hashes) == 1, **summary}))
    if len(hashes) != 1:
        raise SystemExit("the checkouts' walk kernels disagree")


if __name__ == "__main__":
    main()
