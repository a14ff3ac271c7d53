"""The JAX package's native library for the port's tests, whatever the
order in which parallel test workers reach its first build.

kangaroo_tpu/native/__init__.py builds libkangaroo_native.so with g++
straight into its final path on first use, sets `_tried` before it
loads, and keeps None for the rest of the process when the load fails.
A worker that loads the file while another is still writing it (the
first run on a fresh tree, several workers at once) so loses the JAX
native table for good: `NativeHashTable()` raises, and `make_hash_table`
hands the JAX solver the dict table, which has no `_export`.

`require_jax_native()` makes `get_lib()` return a loaded library in this
process.  From the post-race state (`_tried` True, `_lib` None) it
resets the loader's two globals and loads again, under an fcntl lock in
the git-ignored build/ (one helper at a time builds), once the file is
missing (the loader builds it) or whole (a size above 0 that holds over
one poll).  It waits at most BOUND_S, which covers one g++ build (the
loader's timeout is 120 s), then raises with the library's path: no
unbounded wait and no fallback to the dict table.  The reference
package is not changed; every port test that builds a JAX solver or a
JAX NativeHashTable calls this first (the `jax_native` fixture).
"""

import contextlib
import fcntl
import os
import re
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
LOCK = os.path.join(ROOT, "build", "jax_native.lock")
BOUND_S = 150.0
POLL_S = 0.2


def _settled(path):
    """True when path is missing (the loader then builds it) or holds a
    file of nonzero size that no writer changed over one poll."""
    try:
        a = os.stat(path)
        time.sleep(POLL_S)
        b = os.stat(path)
    except FileNotFoundError:
        return True
    return a.st_size > 0 and (a.st_size, a.st_mtime_ns, a.st_ino) == (
        b.st_size, b.st_mtime_ns, b.st_ino)


@contextlib.contextmanager
def _locked(path, deadline):
    """An exclusive flock on path, polled until the deadline (raises
    TimeoutError then); released on exit."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(path) from None
                time.sleep(POLL_S)
        yield
    finally:
        os.close(fd)


def require_jax_native(bound_s=BOUND_S, lock_path=LOCK):
    """kangaroo_tpu.native.get_lib(), loaded in this process within
    bound_s seconds, or RuntimeError naming the library's path."""
    from kangaroo_tpu import native

    lib = native.get_lib()
    if lib is not None:
        return lib
    deadline = time.monotonic() + bound_s
    with contextlib.suppress(TimeoutError), _locked(lock_path, deadline):
        while True:
            if _settled(native._LIB):
                with native._lock:
                    native._tried = False
                    native._lib = None
                lib = native.get_lib()
                if lib is not None:
                    return lib
            if time.monotonic() >= deadline:
                break
            time.sleep(POLL_S)
    raise RuntimeError(
        f"the JAX package's native library {native._LIB} did not load "
        f"within {bound_s:.0f} s (a g++ build that never completed, or a "
        f"file that is not a shared library)")


@pytest.fixture(scope="module")
def jax_native():
    """The JAX native library, loaded before a module's tests build a
    JAX solver or table (`pytestmark = usefixtures("jax_native")`)."""
    return require_jax_native()


def test_loaded_library_serves_the_jax_native_table():
    """The helper returns the process's library, and the JAX package's
    NativeHashTable (and so make_hash_table) runs on it."""
    from kangaroo_tpu import native
    from kangaroo_tpu.core.hashtable import NativeHashTable, make_hash_table

    lib = require_jax_native()
    assert lib is not None and native.get_lib() is lib
    assert isinstance(make_hash_table(), NativeHashTable)
    assert NativeHashTable()._export() is not None


def _post_race(monkeypatch, path):
    """The loader's state after a lost race, on a library path of the
    test's own: _tried set, _lib None, a zero-byte file at path (a build
    still writing it); monkeypatch restores the loader afterwards."""
    from kangaroo_tpu import native

    require_jax_native()  # the real build, copied below
    real = native._LIB
    path.write_bytes(b"")
    monkeypatch.setattr(native, "_LIB", str(path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert native.get_lib() is None  # what a worker keeps after the race
    return native, real


def test_recovers_from_a_build_that_completes(tmp_path, monkeypatch):
    """A background thread replaces the zero-byte file with a complete
    build after 1 s: the helper comes back with the library loaded from
    that path, within its bound."""
    path = tmp_path / "libkangaroo_native.so"
    native, real = _post_race(monkeypatch, path)

    def complete():
        time.sleep(1.0)
        part = tmp_path / "part.so"
        with open(real, "rb") as src:
            part.write_bytes(src.read())
        os.replace(part, path)

    writer = threading.Thread(target=complete)
    t = time.monotonic()
    writer.start()
    try:
        lib = require_jax_native(bound_s=30.0,
                                 lock_path=str(tmp_path / "lock"))
    finally:
        writer.join()
    elapsed = time.monotonic() - t
    assert lib is not None and native._lib is lib
    assert lib._name == str(path)
    assert 1.0 <= elapsed < 30.0
    h = lib.kt_ht_new()  # a working library
    assert h
    lib.kt_ht_free(h)


def test_raises_when_the_build_never_completes(tmp_path, monkeypatch):
    """The zero-byte file stays: the helper raises after its bound, with
    a message that names the library's path."""
    path = tmp_path / "libkangaroo_native.so"
    native, _ = _post_race(monkeypatch, path)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="did not load") as err:
        require_jax_native(bound_s=1.5, lock_path=str(tmp_path / "lock"))
    elapsed = time.monotonic() - t
    assert str(path) in str(err.value)
    assert 1.5 <= elapsed < 10.0
    assert native._lib is None


def test_waits_for_the_lock_within_its_bound(tmp_path, monkeypatch):
    """Another holder of the build lock (a helper in another worker)
    delays the helper but does not make it wait past its bound."""
    path = tmp_path / "libkangaroo_native.so"
    _post_race(monkeypatch, path)
    lock = str(tmp_path / "lock")
    fd = os.open(lock, os.O_RDWR | os.O_CREAT, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    try:
        t = time.monotonic()
        with pytest.raises(RuntimeError, match=re.escape(str(path))):
            require_jax_native(bound_s=1.0, lock_path=lock)
        assert 1.0 <= time.monotonic() - t < 10.0
    finally:
        os.close(fd)


RACE = r"""
import sys
sys.path.insert(0, sys.argv[1])
from kangaroo_tpu import native
from tests.test_torch_jax_native import require_jax_native
native._LIB = sys.argv[2]
lib = require_jax_native(bound_s=60.0, lock_path=sys.argv[3])
h = lib.kt_ht_new()
lib.kt_ht_free(h)
print("loaded", bool(h))
"""


def test_parallel_first_builds_all_load(tmp_path):
    """A fresh tree: 6 processes (the suite's workers) reach a library
    path where no build exists yet, at once, each with the loader's
    in-place g++ build; every one of them comes back with a loaded
    library."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    lib, lock = str(tmp_path / "libkangaroo_native.so"), str(tmp_path / "lk")
    procs = [subprocess.Popen([sys.executable, "-c", RACE, ROOT, lib, lock],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert all(o.strip().endswith("loaded True") for o in outs), outs
