"""kangaroo_torch's network (DP server, client, wire protocol) on the CPU,
against the JAX package's.

The counterparts of tests/test_network.py on the port, and the wire
contract in bytes: the protocol's encodings, the solver's dp_sink records
over 4 ticks (plain and -sym) and the -wss backup files equal the JAX
package's, tolerance 0 (integer data and file bytes); a port client
solves against a JAX server and a JAX client against the port's server.
The port's server validates the (n, 40) wire records with exact rejected
counts, answers SERVER_END to a client whose search ended during a
SAVEKANG, and its client gives up a lost server within its bound.

Every test bounds itself: servers run with max_seconds, threads are
joined with a timeout and checked, sockets have timeouts, and a test
that still hangs dumps its stacks and ends its process
(faulthandler).  JAX solvers share one geometry (64 lanes, 8 jumps per
tick, dp 2): one compile per mode.
"""

import contextlib
import faulthandler
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

# the JAX solver's native table, loaded whatever the build race
pytestmark = pytest.mark.usefixtures("jax_native")

from kangaroo_tpu.core import curve as jcurve  # noqa: E402
from kangaroo_tpu.core.config import ProblemConfig as JConfig  # noqa: E402
from kangaroo_tpu.core.hashtable import convert as jconvert  # noqa: E402
from kangaroo_tpu.core.herd import true_distance  # noqa: E402
from kangaroo_tpu.core.solver import KangarooSolver as JSolver  # noqa: E402
from kangaroo_tpu.core.solver import SolverOptions as JOptions  # noqa: E402
from kangaroo_tpu.net import client as jclient  # noqa: E402
from kangaroo_tpu.net import protocol as jproto  # noqa: E402
from kangaroo_tpu.net.server import DPServer as JServer  # noqa: E402
from kangaroo_tpu.utils.intutils import limbs_to_ints_fast  # noqa: E402
from kangaroo_torch import cli  # noqa: E402
from kangaroo_torch.constants import HEADKS  # noqa: E402
from kangaroo_torch.core import curve  # noqa: E402
from kangaroo_torch.core.config import ProblemConfig  # noqa: E402
from kangaroo_torch.core.solver import (  # noqa: E402
    KangarooSolver, SolverOptions)
from kangaroo_torch.io import backup  # noqa: E402
from kangaroo_torch.net import client as client_mod  # noqa: E402
from kangaroo_torch.net import protocol as proto  # noqa: E402
from kangaroo_torch.net.client import (  # noqa: E402
    ServerConnection, ServerUnreachable, run_client)
from kangaroo_torch.net.server import DPServer  # noqa: E402
from kangaroo_torch.utils.packing import canon_mod_p  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
START = 0x5000000
# a 16-bit range solves in a few ticks of 64 lanes; in a 26-bit range 4
# ticks of 64 x 8 jumps find no collision
NARROW = (1 << 16) - 1
WIDE = (1 << 26) - 1
K_NARROW = START + 0xBEE
K_WIDE = START + 0x2C5A9E1
DP = 2
WALK = dict(nb_kangaroo=64, nb_run=8, quiet=True)
NET = dict(timeout=5.0, quiet=True, send_period=0.2)
# seconds after which a test that has not ended dumps its stacks and
# ends its process
TEST_LIMIT = 240


@pytest.fixture(autouse=True)
def bounded():
    faulthandler.dump_traceback_later(TEST_LIMIT, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def cfg(width=NARROW, key=K_NARROW):
    return ProblemConfig(START, START + width, [curve.mul(key)])


def jcfg(width=NARROW, key=K_NARROW):
    return JConfig(START, START + width, [jcurve.mul(key)])


def port_opts(**kw):
    return SolverOptions(**{**WALK, "seed": 5, "device": "cpu", **kw})


def jax_opts(**kw):
    return JOptions(**{**WALK, "seed": 5, "dp_size": DP, "n_devices": 1,
                       "backend": "xla", **kw})


@contextlib.contextmanager
def serving(srv, max_seconds=60):
    """Run a port or JAX DPServer in a thread on an ephemeral port; at
    the end, stop it and check that its thread ended."""
    srv.process_period = 0.1
    t = threading.Thread(target=srv.run, daemon=True,
                         kwargs={"max_seconds": max_seconds, "quiet": True})
    t.start()
    deadline = time.time() + 10
    while srv.port == 0 and time.time() < deadline:
        time.sleep(0.02)
    assert srv.port != 0, "the server did not bind"
    try:
        yield srv
    finally:
        srv.end_of_search = True
        t.join(timeout=20)
        assert not t.is_alive(), "the server thread did not end"


def port_server(width=NARROW, key=K_NARROW, **kw):
    return DPServer(cfg(width, key), DP, port=0, device="cpu", **kw)


def jax_server(width=NARROW, key=K_NARROW, **kw):
    return JServer(jcfg(width, key), DP, port=0, **kw)


def in_thread(fn, *a, **kw):
    """Start fn in a daemon thread; returns (thread, box) where box gets
    the result or the exception."""
    box = {}

    def run():
        try:
            box["result"] = fn(*a, **kw)
        except BaseException as e:  # handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


# -- the wire contract ----------------------------------------------------

def test_protocol_roundtrip_and_bytes_equal_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        k, h = int(rng.randint(0, 1 << 31)), int(rng.randint(0, 1 << 18))
        x = int.from_bytes(rng.bytes(16), "little")
        d = int.from_bytes(rng.bytes(16), "little")
        rec = proto.DPRecord(k, h, x, d)
        assert rec.pack() == jproto.DPRecord(k, h, x, d).pack()
        assert proto.DPRecord.unpack(rec.pack()) == rec
    hdr = proto.pack_dp_header(42, 1, 2, 3)
    assert hdr == jproto.pack_dp_header(42, 1, 2, 3)
    assert len(hdr) == proto.DPHEADER_SIZE
    assert proto.unpack_dp_header(hdr) == (42, 1, 2, 3)
    with pytest.raises(proto.ProtocolError):
        proto.unpack_dp_header(b"\0" * proto.DPHEADER_SIZE)
    key = curve.mul(K_WIDE)
    cfgb = proto.pack_config(3, START, START + WIDE, key.x, key.y, 16)
    assert cfgb == jproto.pack_config(3, START, START + WIDE, key.x, key.y,
                                      16)
    assert len(cfgb) == proto.CONFIG_SIZE == jproto.CONFIG_SIZE
    assert proto.unpack_config(cfgb) == (3, START, START + WIDE, key.x,
                                         key.y, 16)
    for name in ("SERVER_HEADER", "KANG_PER_BLOCK", "SERVER_GETCONFIG",
                 "SERVER_STATUS", "SERVER_SENDDP", "SERVER_SETKNB",
                 "SERVER_SAVEKANG", "SERVER_LOADKANG", "SERVER_RESETDEAD",
                 "SERVER_OK", "SERVER_END", "SERVER_BACKUP", "DP_SIZE",
                 "DPHEADER_SIZE"):
        assert getattr(proto, name) == getattr(jproto, name), name
    # the kangaroo checksum: the reference's sum of 128-bit records kept
    # to 256 bits (the JAX package sums them one by one)
    for recs in (rng.bytes(16 * 3000), b"\xff" * 16 * 5000, b""):
        want = sum(int.from_bytes(recs[i:i + 16], "little")
                   for i in range(0, len(recs), 16)) & ((1 << 256) - 1)
        assert proto.kangaroo_checksum(recs) == want
    # recv_exact / send_all move the same bytes as the JAX ones
    a, b = socket.socketpair()
    with a, b:
        data = rng.bytes(1 << 16)
        proto.send_all(a, data, 5.0)
        assert proto.recv_exact(b, len(data), 5.0) == data
        jproto.send_all(a, data, 5.0)
        assert proto.recv_exact(b, len(data), 5.0) == data
        a.close()
        with pytest.raises(ConnectionError):
            proto.recv_exact(b, 1, 5.0)


def _sink_calls(solver, ticks=4):
    calls = []
    solver.solve(0, max_ticks=ticks,
                 dp_sink=lambda raw, nb: calls.append((raw, nb)) or False)
    return calls


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_dp_sink_wire_bytes_equal_jax_solver(symmetry):
    """The port solver's client-mode records, call by call over 4 ticks,
    equal the JAX solver's: the kIdx column the origin lane, then the
    36-byte table record, in walk order; nothing goes to the table."""
    ts = KangarooSolver(cfg(WIDE, K_WIDE),
                        port_opts(dp_size=DP, symmetry=symmetry))
    js = JSolver(jcfg(WIDE, K_WIDE), jax_opts(symmetry=symmetry))
    tcalls, jcalls = _sink_calls(ts), _sink_calls(js)
    assert len(tcalls) == 4 and sum(nb for _, nb in tcalls) > 200
    assert tcalls == jcalls
    raw = np.frombuffer(b"".join(r for r, _ in tcalls), np.uint8)
    lanes = raw.reshape(-1, 40)[:, :4].copy().view("<u4").ravel()
    assert lanes.max() < 64 and len(np.unique(lanes)) > 32
    assert ts.hash_table.n_items() == 0 and ts.stats.count == 4 * 64 * 8


# -- the server ------------------------------------------------------------

def test_loopback_config_and_status():
    with serving(port_server()) as srv:
        conn = ServerConnection("127.0.0.1", srv.port, timeout=5.0)
        conn.connect()
        c, dp = conn.get_config()
        assert dp == DP
        assert (c.range_start, c.range_end) == (srv.range_start,
                                                srv.range_end)
        assert c.keys[0] == srv.cfg.keys[0]
        conn.set_kangaroo_number(64)
        assert conn.get_status() == proto.SERVER_OK
        deadline = time.time() + 5
        while srv.total_rw != 64 and time.time() < deadline:
            time.sleep(0.02)
        assert srv.total_rw == 64
        conn.close()


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_loopback_solve(symmetry):
    """A port client walks a 16-bit range; the port server finds the
    key and the client hears SERVER_END (-sym on both sides: the
    server's shifted collision)."""
    with serving(port_server(symmetry=symmetry)) as srv:
        rep = run_client("127.0.0.1", srv.port,
                         port_opts(symmetry=symmetry), max_ticks=4000,
                         reconnect_timeout=5.0, **NET)
        deadline = time.time() + 10
        while srv.result is None and time.time() < deadline:
            time.sleep(0.02)
    assert srv.result is not None and srv.result.private_key == K_NARROW
    assert rep.ended and rep.dps_sent > 0 and rep.sends > 0
    assert len(rep.sink_stalls) > 0
    assert rep.solver.hash_table.n_items() == 0


def _wire_dps(symmetry):
    """Real DPs of a port walk (64 lanes, 4 ticks) as (n, 40) uint8 wire
    records."""
    s = KangarooSolver(cfg(WIDE, K_WIDE), port_opts(dp_size=DP,
                                                    symmetry=symmetry))
    raw = b"".join(r for r, _ in _sink_calls(s))
    return np.frombuffer(raw, np.uint8).reshape(-1, 40).copy()


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_server_point_validation(symmetry):
    """validate_points re-derives the (n, 40) wire records on the device:
    every forged one (x ^ 1, or the bucket of another record) is
    rejected, every real one kept -- wild -sym DPs of both signs of the
    key included (the counterpart of tests/test_check.py:110)."""
    arr = _wire_dps(symmetry)
    n = len(arr)
    bad = np.zeros(n, dtype=bool)
    bad[::7] = True
    arr[bad[:], 8] ^= 1
    # a bucket forgery on one record that is not otherwise forged
    j = int(np.flatnonzero(~bad)[0])
    h = arr[j, 4:8].copy().view("<u4")[0]
    arr[j, 4:8] = np.array([(h + 1) % (1 << 18)], "<u4").view(np.uint8)
    bad[j] = True
    types = (arr[:, 39] >> 6) & 1
    assert types.min() == 0 and types.max() == 1
    srv = port_server(WIDE, K_WIDE, validate_points=True, symmetry=symmetry)
    srv.recv_dp = [arr.tobytes()]
    srv._process_once()
    assert srv.rejected == int(bad.sum())
    assert srv.hash_table.n_items() + srv.dead == n - int(bad.sum())
    keep = srv._validate(arr)
    np.testing.assert_array_equal(keep, ~bad)
    assert srv._validate(arr[~bad]) is None


def test_server_side_kangaroo_backup(tmp_path, monkeypatch):
    """SAVEKANG then LOADKANG through the port's server gives the records
    back; the port's HEADKS file equals the JAX server's for the same
    payload; a wrong checksum leaves no file."""
    monkeypatch.chdir(tmp_path)
    dists = [(i << 64) + i * 3 + 1 for i in range(1, 3000)]
    recs = b"".join(v.to_bytes(16, "little") for v in dists)
    with serving(port_server()) as srv:
        conn = ServerConnection("127.0.0.1", srv.port, timeout=5.0)
        conn.connect()
        conn.save_kangaroos_via_server("dir/../kang.bak", recs)
        assert conn.get_status() == proto.SERVER_OK  # ordered after it
        assert conn.load_kangaroos_via_server("kang.bak") == recs
        assert conn.load_kangaroos_via_server("none.bak") == b""
        port_file = open("kang.bak", "rb").read()
        # a wrong checksum: the file is not written
        conn._send_name(proto.SERVER_SAVEKANG, "bad.bak")
        conn._send(struct.pack("<Q", 2) + recs[:32] + b"\1" + b"\0" * 31)
        assert conn.get_status() == proto.SERVER_OK
        assert not os.path.exists("bad.bak")
        conn.close()
    assert srv.last_backup[:2] == ("kang.bak", len(dists))
    os.remove("kang.bak")
    with serving(jax_server()) as jsrv:
        jconn = jclient.ServerConnection("127.0.0.1", jsrv.port, timeout=5.0)
        jconn.connect()
        jconn.save_kangaroos_via_server("kang.bak", dists)
        assert jconn.load_kangaroos_via_server("kang.bak") == dists
        jconn.close()
    assert open("kang.bak", "rb").read() == port_file
    assert port_file[:16] == struct.pack("<IIQ", HEADKS, 0, len(dists))


def _jax_hook_payload(symmetry):
    """The JAX client's -wss save_hook (kangaroo_tpu/net/client.py:
    264-275) on the JAX solver's herd after 2 ticks: its d128 values as
    the 16-byte records it sends."""
    got = {}

    def hook(s, px, py, d, elapsed):
        got["d"] = np.asarray(d)
        got["w"] = s.width_div2

    js = JSolver(jcfg(WIDE, K_WIDE), jax_opts(symmetry=symmetry,
                                              save_period=0))
    assert js.solve(0, max_ticks=2, save_hook=hook) is None
    assert js.stats.dead == 0
    ds = limbs_to_ints_fast(got["d"])
    return b"".join(
        jconvert(0, true_distance(int(ds[i]), i % 2, got["w"],
                                  symmetry=symmetry), i % 2)[2]
        .to_bytes(16, "little") for i in range(len(ds)))


@pytest.mark.parametrize("client,server", [
    ("port", "port"), ("port", "jax"), ("jax", "port")],
    ids=["port-port", "port-client-jax-server", "jax-client-port-server"])
def test_wss_backup_equals_jax(tmp_path, monkeypatch, client, server):
    """A -wss client saving at every tick for 2 ticks: the HEADKS file
    the server keeps is the JAX save_hook's payload for the same herd,
    byte for byte, whichever package is the client or the server."""
    monkeypatch.chdir(tmp_path)
    want = _jax_hook_payload(False)
    srv = port_server(WIDE, K_WIDE) if server == "port" else jax_server(
        WIDE, K_WIDE)
    with serving(srv):
        if client == "port":
            rep = run_client("127.0.0.1", srv.port, port_opts(
                work_file="kang.srv", save_period=0), max_ticks=2,
                save_kangaroo_server=True, reconnect_timeout=5.0, **NET)
            assert len(rep.wss) == 2 and not rep.ended
            snap_d = rep.solver._snap[2].numpy()
            assert backup.d128_records(snap_d, rep.solver.width_div2,
                                       False).tobytes() == want
        else:
            jclient.run_client("127.0.0.1", srv.port, jax_opts(
                work_file="kang.srv", save_period=0), max_ticks=2,
                save_kangaroo_server=True, **NET)
    # the client's last SENDDP had its reply after both SAVEKANGs
    data = open("kang.srv", "rb").read()
    assert data[:16] == struct.pack("<IIQ", HEADKS, 0, 64)
    assert data[16:] == want


def test_client_server_kangaroo_backup_flow(tmp_path, monkeypatch):
    """-wss: a client saves its herd through the server at every tick
    and stops after 2 ticks; the herd the server's file rebuilds is the
    snapshot the client sent (px, canonical py, d); a second client
    restores it from the server and runs to the key."""
    monkeypatch.chdir(tmp_path)
    key = START + 0x3C5A9E
    width = (1 << 22) - 1
    with serving(port_server(width, key)) as srv:
        rep = run_client("127.0.0.1", srv.port, port_opts(
            work_file="kang.srv", save_period=0), max_ticks=2,
            save_kangaroo_server=True, reconnect_timeout=5.0, **NET)
        assert not rep.ended and len(rep.wss) == 2
        sent = [b.numpy().astype(np.uint32) for b in rep.solver._snap]
        deadline = time.time() + 5
        while srv.last_backup is None and time.time() < deadline:
            time.sleep(0.02)
        px, py, d = backup.load_kangaroo_file(
            "kang.srv", srv.range_start, srv.range_end, srv.key_to_search,
            device="cpu")
        np.testing.assert_array_equal(px, sent[0])
        np.testing.assert_array_equal(canon_mod_p(py), canon_mod_p(sent[1]))
        np.testing.assert_array_equal(d, sent[2])
        rep2 = run_client("127.0.0.1", srv.port, port_opts(
            seed=6, work_file="kang.srv", save_period=3600), max_ticks=4000,
            save_kangaroo_server=True, reconnect_timeout=5.0, **NET)
        assert rep2.restored == 64 and rep2.ended
        deadline = time.time() + 10
        while srv.result is None and time.time() < deadline:
            time.sleep(0.02)
    assert srv.result is not None and srv.result.private_key == key


def test_end_during_savekang_reaches_client_as_server_end(tmp_path,
                                                          monkeypatch):
    """The reference server's race, made deterministic: the search ends
    while a client is inside a SAVEKANG (no reply) and the server's
    accept loop closes.  The port's server still reads the exchange to
    its end and answers the client's next SENDDP with SERVER_END."""
    monkeypatch.chdir(tmp_path)
    # a 10 s socket timeout: the half-sent SAVEKANG outlives the listener
    srv = port_server(timeout=10.0)
    srv.process_period = 0.1
    t = threading.Thread(target=srv.run, daemon=True,
                         kwargs={"max_seconds": 60, "quiet": True})
    t.start()
    deadline = time.time() + 10
    while srv.port == 0 and time.time() < deadline:
        time.sleep(0.02)
    conn = ServerConnection("127.0.0.1", srv.port, timeout=5.0)
    conn.connect()
    conn.get_config()
    recs = bytes(range(256)) * 64  # 1024 records
    conn._send_name(proto.SERVER_SAVEKANG, "kang.srv")
    conn._send(struct.pack("<Q", 1024) + recs[:8000])
    srv.end_of_search = True  # what the drain does when it finds the key
    closed = False
    deadline = time.time() + 8
    while not closed and time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", srv.port), 1.0).close()
            time.sleep(0.05)
        except OSError:
            closed = True
    assert closed, "the listener did not close"
    # the connection still finishes its exchange, then hears the end
    conn._send(recs[8000:] + proto.kangaroo_checksum(recs).to_bytes(
        32, "little"))
    rec = proto.DPRecord(0, 5, 7, 9).pack()
    assert conn.send_dps_raw(rec, 1) == proto.SERVER_END
    conn.close()
    t.join(timeout=srv.timeout + 5)
    assert not t.is_alive()
    assert open("kang.srv", "rb").read()[16:] == recs


def test_handler_gives_up_a_silent_client_after_the_end():
    """After the end of the search a handler waits `timeout` seconds for
    its client's next command, not CLIENT_TIMEOUT."""
    srv = port_server(timeout=0.5)
    with serving(srv):
        conn = ServerConnection("127.0.0.1", srv.port, timeout=5.0)
        conn.connect()
        conn.get_config()
        deadline = time.time() + 5
        while not srv._handlers and time.time() < deadline:
            time.sleep(0.02)
        handler = srv._handlers[0]
        srv.end_of_search = True
        handler.join(timeout=5)
        assert not handler.is_alive()
        conn.close()


def test_handler_waits_for_a_slow_client_after_the_end():
    """A client whose commands come 1 s apart (long ticks) still hears
    SERVER_END 1.5 s after the end, three times the server's 0.5 s
    timeout: the handler waits twice the client's longest gap more."""
    srv = port_server(timeout=0.5)
    with serving(srv):
        conn = ServerConnection("127.0.0.1", srv.port, timeout=5.0)
        conn.connect()
        conn.get_config()
        time.sleep(1.0)
        assert conn.get_status() == proto.SERVER_OK
        srv.end_of_search = True
        time.sleep(1.5)
        assert conn.get_status() == proto.SERVER_END
        conn.close()


def test_wait_for_server_gives_up_within_its_bound():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conn = ServerConnection("127.0.0.1", port, timeout=1.0)
    t0 = time.time()
    with pytest.raises(ServerUnreachable):
        conn.wait_for_server(t0 + 1.5)
    assert time.time() - t0 < 1.5 + conn.timeout + 1.0
    assert conn.sock is None


# -- cross-runs against the JAX package --------------------------------------

def test_port_client_solves_against_jax_server():
    with serving(jax_server()) as srv:
        try:
            run_client("127.0.0.1", srv.port, port_opts(), max_ticks=4000,
                       reconnect_timeout=3.0, **NET)
        except ServerUnreachable:
            # the JAX server may close a client's connection mid-exchange
            # at the end of the search (ROADMAP, queue 3)
            pass
        deadline = time.time() + 10
        while srv.result is None and time.time() < deadline:
            time.sleep(0.02)
    assert srv.result is not None and srv.result.private_key == K_NARROW


def test_jax_client_solves_against_port_server(monkeypatch):
    """The JAX client in a daemon thread, its unbounded wait_for_server
    replaced by one that gives up after 3 s."""
    def bounded_wait(self):
        deadline = time.time() + 3
        while time.time() < deadline:
            try:
                if self.sock is None:
                    self.connect()
                    self.set_kangaroo_number(self.nb_kangaroo)
                status = self.get_status()
                if status == jproto.SERVER_OK:
                    return
                if status == jproto.SERVER_END:
                    raise jclient.EndOfSearch()
            except OSError:
                self.close()
            time.sleep(0.2)
        raise OSError("server gone")

    monkeypatch.setattr(jclient.ServerConnection, "wait_for_server",
                        bounded_wait)
    with serving(port_server()) as srv:
        t, box = in_thread(jclient.run_client, "127.0.0.1", srv.port,
                           jax_opts(), max_ticks=4000, **NET)
        t.join(timeout=60)
        assert not t.is_alive(), "the JAX client did not end"
    assert "error" not in box, box.get("error")
    assert srv.result is not None and srv.result.private_key == K_NARROW


# -- the CLI ---------------------------------------------------------------

def test_cli_server_resume_from_workfile(tmp_path, monkeypatch):
    """-s -i workfile: the server adopts the file's table, range, key,
    dp and -sym (reference: LoadWork before RunServer,
    main.cpp:338-352); -s without -d or a work file is refused."""
    s = KangarooSolver(cfg(), port_opts(dp_size=1, symmetry=True))
    s.solve(0, max_ticks=2)
    n_saved = s.hash_table.n_items()
    assert n_saved > 0
    wf = str(tmp_path / "srv.work")
    backup.save_work(wf, s, None, None, None, s.stats.count, 1.0)
    captured = {}

    def fake_run(self, *a, **kw):
        captured["srv"] = self
        return None

    monkeypatch.setattr(DPServer, "run", fake_run)
    assert cli.main(["-s", "-i", wf, "-device", "cpu"]) == 1
    srv = captured["srv"]
    assert (srv.dp_size, srv.symmetry, srv.device) == (1, True, "cpu")
    assert srv.hash_table.n_items() == n_saved
    assert srv.hash_table.export() == s.hash_table.export()
    assert (srv.range_start, srv.range_end) == (s.range_start, s.range_end)
    assert srv.cfg.keys[0] == s.cfg.keys[0]
    fx = os.path.join(ROOT, "fixtures", "in32.txt")
    assert cli.main(["-s", fx]) == -1


def test_cli_server_and_client_loopback(tmp_path):
    """The CLI server in a process of its own on a free port, a CLI
    client in this one on the CPU: the server prints the key, and a
    client without -device cpu on a host without a card fails."""
    fx = str(tmp_path / "in20.txt")
    with open(fx, "w") as f:
        f.write(f"{START:X}\n{START + (1 << 20) - 1:X}\n"
                f"{curve.get_public_key_hex(curve.mul(START + 0x9A5C3))}\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "kangaroo_torch.cli", "-s", "-d", "2",
         "-sp", "0", "-device", "cpu", fx],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.time() + 60
        while "listening on port" not in line and time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        assert "listening on port" in line, line
        port = line.split("listening on port")[1].split()[0]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(["-c", "127.0.0.1", "-sp", port])
        assert cli.main(["-c", "127.0.0.1", "-sp", port, "-device", "cpu",
                         "-nk", "64", "-nt", "5000"]) == 0
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, out
    assert f"Priv: 0x{START + 0x9A5C3:X}" in out


def test_cli_lists_devices(capsys):
    assert cli.main(["-l"]) == 0
    out = capsys.readouterr().out
    n = torch.cuda.device_count()
    assert f"CUDA devices: {n}" in out and "cpu (-device cpu)" in out


# -- ingest ----------------------------------------------------------------

def test_multi_client_ingest():
    """Concurrent clients stream DP batches; the drain thread takes them
    all without loss (reference: ProcessServer, Thread.cpp:165-234)."""
    srv = port_server((1 << 30) - 1, START + 0x12345)
    n_clients, per_client = 4, 20000

    def client(cid):
        rng = np.random.RandomState(cid)
        conn = ServerConnection("127.0.0.1", srv.port, timeout=10.0)
        conn.connect()
        conn.get_config()
        conn.set_kangaroo_number(64)
        recs = [
            proto.DPRecord(
                i & 0xFFFF, int(rng.randint(0, 1 << 18)),
                (int(rng.randint(0, 1 << 62)) << 64)
                | (cid * per_client + i),
                int(rng.randint(0, 1 << 61)),
            )
            for i in range(per_client)
        ]
        for off in range(0, per_client, 5000):
            assert conn.send_dps(recs[off:off + 5000]) == proto.SERVER_OK
        conn.close()

    with serving(srv):
        ths = [in_thread(client, c) for c in range(n_clients)]
        for t, box in ths:
            t.join(timeout=60)
            assert not t.is_alive() and "error" not in box, box
        total = n_clients * per_client
        deadline = time.time() + 60
        while (srv.hash_table.n_items() + srv.dead < total
               and time.time() < deadline):
            time.sleep(0.1)
        assert srv.hash_table.n_items() + srv.dead == total


def test_ingest_drain_rate_vectorized():
    """The SENDDP drain stays a batch/numpy path: 200k raw records
    through _process_once well over a per-record loop's ~50 K/s (the
    floor, 100 K/s on a shared core, catches reintroduced per-record
    parsing; it is not a benchmark)."""
    srv = port_server((1 << 30) - 1, START + 0x777)
    n = 200_000
    rng = np.random.RandomState(7)
    rec = rng.randint(0, 256, size=(n, proto.DP_SIZE)).astype(np.uint8)
    # bucket ids must be < 2^18: bytes 4:8 hold u32 h
    rec[:, 6] &= 0x03
    rec[:, 7] = 0
    # unique x128: the record index in its low 8 bytes
    rec[:, 8:16] = (np.arange(n, dtype=np.uint64).astype("<u8")
                    .view(np.uint8).reshape(n, 8))
    srv.recv_dp = [rec.tobytes()]
    t0 = time.time()
    srv._process_once()
    rate = n / (time.time() - t0)
    assert srv.hash_table.n_items() + srv.dead == n
    assert rate > 100_000, f"drain rate regressed: {rate:.0f} DPs/s"


def test_pending_dp_persistence_and_resend(tmp_path, monkeypatch):
    """DPs captured but never acknowledged survive a client that gives
    up (its bounded reconnect meets a server that never takes a DP) on
    disk, and the next client run re-sends them and removes the file."""
    monkeypatch.chdir(tmp_path)
    with serving(port_server()) as srv:
        real_send = ServerConnection.send_dps_raw

        def broken_send(self, payload, nb, thread_id=0, gpu_id=0):
            raise OSError("simulated mid-send connection loss")

        monkeypatch.setattr(ServerConnection, "send_dps_raw", broken_send)
        t0 = time.time()
        with pytest.raises(ServerUnreachable):
            run_client("127.0.0.1", srv.port, port_opts(
                work_file="kang.work"), max_ticks=60, timeout=5.0,
                quiet=True, send_period=0.0, reconnect_timeout=1.0)
        assert time.time() - t0 < 30
        pend = client_mod.pending_dp_path("kang.work")
        saved = client_mod.load_pending_dps(pend)
        assert saved and len(saved) % proto.DP_SIZE == 0
        monkeypatch.setattr(ServerConnection, "send_dps_raw", real_send)
        rep = run_client("127.0.0.1", srv.port, port_opts(
            seed=6, work_file="kang.work"), max_ticks=4000,
            reconnect_timeout=5.0, **NET)
        assert rep.dps_sent >= len(saved) // proto.DP_SIZE
        deadline = time.time() + 10
        while srv.result is None and time.time() < deadline:
            time.sleep(0.02)
    assert srv.result is not None and srv.result.private_key == K_NARROW
    assert not os.path.exists(pend)
