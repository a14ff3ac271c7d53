"""Command-line entry point of the PyTorch/CUDA port.

Flag surface of kangaroo_tpu/cli.py: the standalone solve, plain or
symmetric (-sym), its work files (checkpoint -w/-wi/-ws/-wsplit/-wt,
resume -i, the tools -wm/-wmdir/-winfo/-wpartcreate/-wcheck), the
self-check (-check), the DP server (-s) and its clients (-c, -wss), -l,
and the multi-device herd (-devices) with fused launch windows (-nwin).
-backend and -platform, which pick a JAX backend, exit non-zero naming
-device.

    python -m kangaroo_torch.cli [-d dp] [-nk n] [-nbrun n] [-nwin k]
        [-m maxStep] [-o file] [-dpcost s] [-sym] [-device cuda|cpu]
        [-devices n] [-w file [-wi s] [-ws] [-wsplit] [-wt ms]] [-i file]
        inFile
    python -m kangaroo_torch.cli -s -d dp [-sp port] [-nt ms] [-sym]
        [-w file [-wi s] [-wsplit]] [-o file] (inFile | -i workfile)
    python -m kangaroo_torch.cli -c serverIp [-sp port] [-nt ms] [-nk n]
        [-sym] [-device cuda|cpu] [-devices n] [-w file [-wi s] [-wss]]
        [-i file]
    python -m kangaroo_torch.cli [-device cuda|cpu] -check
    python -m kangaroo_torch.cli [-device cuda|cpu] -wcheck file
    python -m kangaroo_torch.cli -winfo file | -wm f1 f2 dest |
        -wmdir dir dest | -wpartcreate dir | -l
"""

from __future__ import annotations

import math
import sys
import time
from typing import List, Optional

from .constants import DEFAULT_PORT, RELEASE

# Flags of kangaroo_tpu/cli.py that later slices of the port add: none.
NOT_YET_PORTED = ()
# Flags of kangaroo_tpu/cli.py that pick a JAX backend or platform; the
# port's -device does that.
USE_DEVICE = ("-backend", "-platform")


def print_usage() -> None:
    print(
        """kangaroo-torch [options] inFile
 -v: Print version
 -d dpBit: Specify number of leading zeros for the DP method (default is auto)
 -nk n: Number of kangaroos (herd lanes, all shards), default 2^22 per
       card on cuda, 2^10 on cpu
 -nbrun n: Jumps per device tick (default: auto from DP size)
 -nwin k: Launch windows fused per device dispatch (default: auto;
       each dispatch costs a host round trip, fusing k windows
       divides that overhead by k)
 -dpcost s: Host cost per drained DP in seconds used by the auto-DP
       model (default 2e-6)
 -sym: Equivalence-class walk over {P,-P} (~sqrt(2) fewer jumps)
 -device cuda|cpu: Where the walk runs (default cuda; cuda without a
       card is an error)
 -devices n: Number of mesh devices to use (default all): the herd's
       lane shards, one per card and stream (on cpu, n CPU shards)
 -check: Check the kernels and field arithmetic against reference
       implementations on -device (exit 0 when all agree)
 -w workfile: Specify file to save work into (current processed key only)
 -i workfile: Specify file to load work from (current processed key only)
 -wi workInterval: Periodic interval (in seconds) for saving work
 -ws: Save kangaroos in the work file
 -wsplit: Split work file of server and reset hashtable
 -wt timeout: Save work timeout in millisec (default is 3000ms)
 -wm file1 file2 destfile: Merge work file
 -wmdir dir destfile: Merge directory of work files
 -winfo file1: Work file info file
 -wpartcreate name: Create empty partitioned work file (name is a directory)
 -wcheck workfile: Check workfile integrity on -device (exit 0 when every
       DP re-derives)
 -wss: Save kangaroos via the server (client mode, with -w)
 -s: Start in server mode (needs -d)
 -c server_ip: Start in client mode and connect to server server_ip; it
       gives up when the server stays away for 3600 s (CLIENT_TIMEOUT)
 -sp port: Server port, default is 17403 (0: any free port, server mode)
 -nt timeout: Network timeout in millisec (default is 3000ms)
 -l: List the CUDA devices
 -m maxStep: number of operations before give up the search (maxStep*expected operation)
 -o fileName: output result to fileName
 inFile: input configuration file"""
    )


def _arg(argv: List[str], i: int, name: str) -> str:
    if i >= len(argv):
        raise SystemExit(f"Missing argument for {name}")
    return argv[i]


def format_status(solver, elapsed: float, rate: float) -> str:
    """Reference status line (Thread.cpp:306-321)."""
    count = solver.stats.count
    exp = solver.stats.expected_ops
    cnt = f"2^{math.log2(count):.2f}" if count else "2^0"
    left = ""
    if rate > 0 and exp > count:
        left = f"[{(exp - count) / rate:.0f}s left]"
    return (f"[{rate / 1e6:.2f} MK/s][Count {cnt}][Dead "
            f"{solver.stats.dead}][{elapsed:.0f}s]{left}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dp = -1
    nk = 0        # 0: per-device default
    nb_run = 0    # auto
    nwin = 0      # auto
    n_devices = 0
    dp_cost = -1.0
    max_step = 0.0
    out_file = ""
    device = "cuda"
    symmetry = False
    check = False
    in_file = ""
    work_file = ""
    load_file = ""
    save_period = 60
    save_kangaroo = False
    wsplit = False
    save_timeout = 3.0
    wcheck = ""
    server_mode = False
    server_ip = ""
    port = DEFAULT_PORT
    net_timeout = 3.0
    wss = False

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-v":
            print(RELEASE)
            return 0
        elif a in ("-h", "--help"):
            print_usage()
            return 0
        elif a == "-d":
            i += 1; dp = int(_arg(argv, i, a))
        elif a == "-nk":
            i += 1; nk = int(_arg(argv, i, a))
        elif a == "-nbrun":
            i += 1; nb_run = int(_arg(argv, i, a))
        elif a == "-nwin":
            i += 1; nwin = int(_arg(argv, i, a))
        elif a == "-devices":
            i += 1; n_devices = int(_arg(argv, i, a))
        elif a == "-dpcost":
            i += 1; dp_cost = float(_arg(argv, i, a))
        elif a == "-device":
            i += 1; device = _arg(argv, i, a)
        elif a == "-m":
            i += 1; max_step = float(_arg(argv, i, a))
        elif a == "-o":
            i += 1; out_file = _arg(argv, i, a)
        elif a == "-sym":
            symmetry = True
        elif a == "-check":
            check = True
        elif a == "-w":
            i += 1; work_file = _arg(argv, i, a)
        elif a == "-i":
            i += 1; load_file = _arg(argv, i, a)
        elif a == "-wi":
            i += 1; save_period = int(_arg(argv, i, a))
        elif a == "-ws":
            save_kangaroo = True
        elif a == "-wsplit":
            wsplit = True
        elif a == "-wt":
            i += 1; save_timeout = float(_arg(argv, i, a)) / 1000.0
        elif a == "-wm":
            from .io.merge import merge_work

            f1, f2 = _arg(argv, i + 1, a), _arg(argv, i + 2, a)
            dest = argv[i + 3] if i + 3 < len(argv) else ""
            return _merged(merge_work(f1, f2, dest))
        elif a == "-wmdir":
            from .io.merge import merge_dir

            return _merged(merge_dir(_arg(argv, i + 1, a),
                                     _arg(argv, i + 2, a)))
        elif a == "-winfo":
            from .io.backup import work_info

            print(work_info(_arg(argv, i + 1, a)))
            return 0
        elif a == "-wpartcreate":
            from .io.merge import create_empty_part_work

            create_empty_part_work(_arg(argv, i + 1, a))
            return 0
        elif a == "-wcheck":
            i += 1; wcheck = _arg(argv, i, a)
        elif a == "-wss":
            wss = True
        elif a == "-s":
            server_mode = True
        elif a == "-c":
            i += 1; server_ip = _arg(argv, i, a)
        elif a == "-sp":
            i += 1; port = int(_arg(argv, i, a))
        elif a == "-nt":
            i += 1; net_timeout = float(_arg(argv, i, a)) / 1000.0
        elif a == "-l":
            return _list_devices()
        elif a in NOT_YET_PORTED:
            print(f"{a}: not yet ported to kangaroo_torch "
                  f"(use python -m kangaroo_tpu.cli)")
            return 2
        elif a in USE_DEVICE:
            print(f"{a}: kangaroo_torch has no JAX backend or platform; "
                  f"use -device cuda|cpu")
            return 2
        elif a.startswith("-"):
            print(f"Unknown option {a}")
            print_usage()
            return 2
        else:
            in_file = a
        i += 1
    if check:
        from .core.check import run_self_check

        return 0 if run_self_check(device) else 1
    if wcheck:
        from .core.check import check_work_file

        rep = check_work_file(wcheck, device=device)
        print(f"CheckWorkFile: {rep.n_items} DPs, {rep.n_wrong} wrong")
        return 0 if rep.ok else 1
    if symmetry and (server_mode or server_ip):
        # the wire has no symmetry marker (the reference's USE_SYMMETRY
        # is a compile-time property of every participant): a plain
        # client and a -sym server silently mix distance conventions
        print("-sym network mode: ALL participants must run with -sym "
              "(the wire has no symmetry marker)")
    if server_mode:
        return _serve(in_file, load_file, dp, port, net_timeout, work_file,
                      save_period, wsplit, out_file, symmetry, device)
    if not in_file and not load_file and not server_ip:
        print_usage()
        return 2

    from .core.config import parse_config_file
    from .core import curve
    from .core.solver import KangarooSolver, SolverOptions, plan

    if nk <= 0:
        # one full wave of the walk kernel per card
        if device.startswith("cuda"):
            from .parallel.sharding import resolve_devices

            nk = (1 << 22) * len(resolve_devices(n_devices, device))
        else:
            nk = 1 << 10
    opts = SolverOptions(
        nb_kangaroo=nk, dp_size=dp, nb_run=nb_run, windows_per_tick=nwin,
        n_devices=n_devices, dp_cost=dp_cost,
        max_step=max_step, out_file=out_file, device=device,
        symmetry=symmetry, work_file=work_file, save_period=save_period,
        save_kangaroo=save_kangaroo, split_work_file=wsplit,
        save_timeout=save_timeout,
    )
    if server_ip:
        return _client(server_ip, port, net_timeout, opts, wss, load_file)
    if load_file:
        from .core.solver import SymmetryMismatch
        from .io.backup import load_work

        lw = load_work(load_file)
        try:
            solver = KangarooSolver.from_work(lw, opts)
        except SymmetryMismatch as e:
            print(f"{load_file}: {e}")
            return -1
        cfg = solver.cfg
        print(f"Loaded: {solver.hash_table.n_items()} DPs, count "
              f"{solver.offset_count}, {load_file}")
    else:
        cfg = parse_config_file(in_file)
        solver = KangarooSolver(cfg, opts)
    nk = opts.nb_kangaroo

    print(f"Kangaroo-Torch {RELEASE}")
    if solver.device.type == "cuda":
        import torch

        print(f"Device: {torch.cuda.get_device_name(solver.device)}")
    else:
        print("Device: cpu")
    print(f"Start:{cfg.range_start:X}")
    print(f"Stop :{cfg.range_end:X}")
    print(f"Keys :{len(cfg.keys)}")
    print(f"Number of kangaroos: 2^{math.log2(nk):.2f}")
    shards = solver.shards
    print(f"Shards: {len(shards)} x {shards[0].hi - shards[0].lo} lanes on "
          + ", ".join(str(s.device) for s in shards))
    if symmetry:
        print("Symmetry: on (walk over classes {P,-P})")
    if opts.dp_size < 0:
        dp_plan = plan(solver)
        print(f"Suggested DP: {dp_plan.suggested}")
        opts.dp_size = dp_plan.dp_size
        if dp_plan.dp_size != dp_plan.suggested:
            print(f"Drain-balanced DP: {dp_plan.dp_size}")
    exp_op, exp_ram, _ = solver.compute_expected(float(opts.dp_size), nk)
    print(f"Expected operations: 2^{math.log2(exp_op):.2f}")
    print(f"Expected RAM: {exp_ram:.1f}MB")
    dp_eff = min(opts.dp_size, 64)
    dmask = (~((1 << (64 - dp_eff)) - 1)) & 0xFFFFFFFFFFFFFFFF if dp_eff else 0
    print(f"DP size: {dp_eff} [0x{dmask:016x}]")

    last = {"count": 0, "t": time.time()}

    def progress(s, elapsed):
        now = time.time()
        dtn = now - last["t"]
        rate = (s.stats.count - last["count"]) / dtn if dtn > 0 else 0.0
        last["count"] = s.stats.count
        last["t"] = now
        print("\r" + format_status(s, elapsed, rate), end="")

    for key_idx in range(len(cfg.keys)):
        res = solver.solve(key_idx, progress=progress)
        if res is None:
            print("\nAborted")
            return 1
        st = solver.stats
        print(f"\n[herd {st.herd_time:.2f}s][walk {st.time:.2f}s]"
              f"[{st.ticks} ticks][2^{math.log2(max(st.count, 1)):.2f} ops]"
              f"[{st.count / max(st.time, 1e-9) / 1e6:.2f} MK/s]")
        pub = curve.get_public_key_hex(cfg.keys[key_idx], True)
        print(f"Key#{key_idx:2d} [{res.variant}{res.sign_info}]Pub:  0x{pub}")
        print(f"       Priv: 0x{res.private_key:X}")
    return 0


def _list_devices() -> int:
    """-l: the CUDA devices by index and name, then the CPU."""
    import torch

    n = torch.cuda.device_count()
    print(f"CUDA devices: {n}")
    for k in range(n):
        print(f"  {k}: {torch.cuda.get_device_name(k)} (cuda)")
    print("  cpu (-device cpu)")
    return 0


def _serve(in_file, load_file, dp, port, net_timeout, work_file,
           save_period, wsplit, out_file, symmetry, device) -> int:
    """-s: the DP server on in_file's problem, or resumed from the work
    file load_file, whose DP size (unless -d) and -sym it adopts
    (reference: LoadWork before RunServer, main.cpp:338-352)."""
    from .core.config import ProblemConfig, parse_config_file
    from .net.server import DPServer

    lw = None
    if load_file:
        from .io.backup import load_work

        lw = load_work(load_file, load_kangaroos=False)
        cfg = ProblemConfig(lw.range_start, lw.range_end, [lw.key])
        if dp < 0:
            dp = lw.dp_size
        if lw.symmetry != symmetry:
            print(f"{load_file}: work file was saved "
                  f"{'with' if lw.symmetry else 'without'} -sym; adopting "
                  f"the file's convention")
            symmetry = lw.symmetry
    elif in_file:
        cfg = parse_config_file(in_file)
    else:
        print_usage()
        return 2
    if dp < 0:
        print("Server mode requires -d (fixed DP size)")
        return -1
    server = DPServer(cfg, dp, port=port, work_file=work_file,
                      save_period=save_period, split_work_file=wsplit,
                      out_file=out_file, timeout=net_timeout,
                      symmetry=symmetry, device=device)
    if lw is not None:
        server.hash_table = lw.hash_table
        print(f"Loaded: {server.hash_table.n_items()} DPs")
    return 0 if server.run() is not None else 1


def _client(server_ip, port, net_timeout, opts, wss, load_file) -> int:
    """-c: walk on opts.device for the server at server_ip:port."""
    from .net.client import ServerUnreachable, run_client

    try:
        rep = run_client(server_ip, port, opts, timeout=net_timeout,
                         save_kangaroo_server=wss, load_file=load_file)
    except ServerUnreachable as e:
        print(f"\n{e}")
        return 1
    st = rep.solver.stats
    print(f"\n[herd {st.herd_time:.2f}s][walk {st.time:.2f}s]"
          f"[{st.ticks} ticks][2^{math.log2(max(st.count, 1)):.2f} ops]"
          f"[{rep.dps_sent} DPs sent in {rep.sends} sends]"
          f"{'[server: end of search]' if rep.ended else ''}")
    return 0


def _merged(res) -> int:
    """Report a -wm/-wmdir merge that solved the key; exit code 0."""
    _, solved, _ = res
    if solved is not None:
        print("Key# 0 solved during merge")
        print(f"       Priv: 0x{solved.private_key:X}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
