"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds `kangaroo_torch`.  The cell,
its configuration, traffic mix and metrics come from `BENCHMARK.json`
(`portbench/bench.py`); the mix's driver builds the inputs from the
seed, warms up, measures for `--seconds`, and hands what the timed path
produced to the plain reference.  With `--trace 0` the result carries
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics,
read from the window's device trace and the program's counters.

The last line of standard output is one JSON object; the numbers
compared, each with its limit, are the last lines of standard error
and the last key of that object.  With no CUDA card, fewer cards than
the cell asks for, or JAX (or the JAX package) loaded once the window
has closed, the run prints no result and exits with another code
than 0.

Options for the benchmark's own tests: `--device cpu` runs a cell on
CPU shards, `--root` takes the data from another directory, and
`--fault` plants a fault under the timed path (`portbench/faults.py`).
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kangaroo_tpu")
CHECKOUT = Path(__file__).resolve().parents[1]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _cache_dirs() -> None:
    """Kernel caches of the libraries in use go inside the checkout, at
    fixed paths (the program builds its own libraries under
    build/kangaroo_torch/)."""
    base = CHECKOUT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default="")
    p.add_argument("--fault", default="")
    return p.parse_args(argv)


def _device(run, outcome) -> dict:
    import torch

    c = run.cell.chips
    if run.cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": c}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": c}
    dev["memory_peak_bytes"] = outcome.memory_peak_bytes
    tr = run.tracer.trace
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    return dev


def main(argv=None) -> int:
    args = _parse(argv)
    _cache_dirs()
    from portbench import bench, faults
    from portbench.harness import Run
    from portbench.trace import Tracer

    root = Path(args.root) if args.root else bench.ROOT
    cell = bench.cell(args.workload, root)
    import torch

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"card(s), {have} available", file=sys.stderr)
            return 2
    # a checkout without the port fails here, before any result
    import kangaroo_torch  # noqa: F401

    faults.apply(args.fault)
    devices = tuple(range(cell.chips)) if args.device == "cuda" else ()
    run = Run(cell, args.seed, args.seconds, args.device, T_START,
              Tracer(bool(args.trace), devices or (0,)))
    outcome = bench.driver(cell).run(run)

    if args.trace:
        ctx = {"run": run, "outcome": outcome, "trace": run.tracer.trace}
        values = {name: rd.read(ctx)
                  for name, rd in bench.readers(cell).items()}
        values = {k: v for k, v in values.items() if v is not None}
    else:
        want = {m["name"] for m in cell.end_to_end}
        values = {k: v for k, v in outcome.end_to_end.items() if k in want}
    result = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": {k: {"value": v, "unit": bench.unit_of(cell, k)}
                    for k, v in values.items()},
        "device": _device(run, outcome),
    }
    if run.tracer.trace is not None:
        result["breakdown"] = run.tracer.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    if run.tracer.trace is not None:
        outcome.info["trace_read_s"] = run.tracer.read_s
    for k, v in outcome.info.items():
        print(f"info {k} = {v}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} = {c.value} (limit {c.limit}: "
              f"{'ok' if c.ok else 'FAILED'})", file=sys.stderr)
    # last, once every reader has run: what any of them loaded counts
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: modules loaded that the port must not use: "
              f"{leaked}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
