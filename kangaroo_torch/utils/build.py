"""Build native sources into shared libraries at first use.

Every library the port loads with ctypes (the C++ hash table, the CUDA
walk kernel, the host build of the kernel's field arithmetic) is
compiled from the sources in the checkout into `build/kangaroo_torch/`
at the repository root, a git-ignored directory, and rebuilt whenever a
source is newer than the library.  Nothing is fetched.
"""

from __future__ import annotations

import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "kangaroo_torch"

_locks_lock = threading.Lock()
_locks = {}  # one lock per library: different libraries build at once


def _lock_for(name: str) -> threading.Lock:
    with _locks_lock:
        return _locks.setdefault(name, threading.Lock())


def _fresh(out: Path, inputs: Sequence[Path]) -> bool:
    return out.exists() and all(
        out.stat().st_mtime >= p.stat().st_mtime for p in inputs)


def build_shared(name: str, sources: Sequence[Path], cmd: Sequence[str],
                 deps: Sequence[Path] = (), timeout: float = 600.0) -> Path:
    """Compile `sources` into BUILD_DIR/`name`; returns the library path.

    `cmd` is the compiler command without sources and output, e.g.
    ["g++", "-O2", "-shared", "-fPIC"].  `deps` are headers whose change
    also forces a rebuild.  The library is written under a temporary
    name and renamed into place, so concurrent builders (test workers)
    never load a half-written file.  Raises RuntimeError with the
    compiler's output when the build fails.
    """
    out = BUILD_DIR / name
    inputs = [Path(s) for s in sources] + [Path(d) for d in deps]
    with _lock_for(name):
        if _fresh(out, inputs):
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{name}.{os.getpid()}.tmp"
        argv = list(cmd) + [str(s) for s in sources] + ["-o", str(tmp)]
        try:
            proc = subprocess.run(
                argv, capture_output=True, text=True, timeout=timeout
            )
        except FileNotFoundError as e:
            raise RuntimeError(f"compiler not found: {argv[0]}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"build of {name} failed ({' '.join(argv)}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        # the compiler's report (e.g. nvcc -Xptxas -v register/spill
        # counts) stays readable beside the library
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
        return out


def build_shared_parts(name: str, source: Path,
                       part_flags: Sequence[Sequence[str]],
                       cmd: Sequence[str], link_cmd: Sequence[str],
                       deps: Sequence[Path] = (),
                       timeout: float = 600.0) -> Path:
    """Compile `source` once per entry of `part_flags` (that part's extra
    flags, e.g. ["-DPART=1"]), all compilers started together, and link
    the objects into BUILD_DIR/`name` with `link_cmd`; returns the
    library path.

    A large source builds in the time of its slowest part instead of the
    sum.  `cmd` is the compile command without -c, source and output.
    Rebuilds, renaming into place and errors as build_shared; the log
    beside the library holds every part's report, in part order.
    """
    out = BUILD_DIR / name
    inputs = [Path(source)] + [Path(d) for d in deps]
    with _lock_for(name):
        if _fresh(out, inputs):
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f".{name}.{os.getpid()}"
        objs = [BUILD_DIR / f"{stem}.{i}.o" for i in range(len(part_flags))]
        logs = [BUILD_DIR / f"{stem}.{i}.log" for i in range(len(objs) + 1)]
        tmp = BUILD_DIR / f"{stem}.tmp"
        jobs = [list(cmd) + list(flags) + ["-c", str(source), "-o", str(o)]
                for flags, o in zip(part_flags, objs)]
        procs = []
        try:
            for argv, log in zip(jobs, logs):
                procs.append((argv, log, _start(argv, log)))
            for argv, log, proc in procs:
                _wait(name, argv, log, proc, timeout)
            link = list(link_cmd) + [str(o) for o in objs] + ["-o", str(tmp)]
            _wait(name, link, logs[-1], _start(link, logs[-1]), timeout)
            os.replace(tmp, out)
            (BUILD_DIR / f"{name}.log").write_text(
                "".join(log.read_text() for log in logs))
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in objs + logs + [tmp]:
                f.unlink(missing_ok=True)
        return out


def _start(argv: Sequence[str], log: Path) -> subprocess.Popen:
    """argv started with its output (both streams) into `log`."""
    with open(log, "w") as f:
        try:
            return subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT)
        except FileNotFoundError as e:
            raise RuntimeError(f"compiler not found: {argv[0]}") from e


def _wait(name: str, argv: Sequence[str], log: Path,
          proc: subprocess.Popen, timeout: float) -> None:
    """Wait for a compiler started by _start; raises RuntimeError with
    its output when it fails or outlasts `timeout`."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        raise RuntimeError(f"build of {name} failed ({' '.join(argv)}): "
                           f"{rc}\n{log.read_text()}")
