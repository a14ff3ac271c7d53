"""Solver client: walk on the card, stream DPs to a server.

Counterpart of kangaroo_tpu/net/client.py.  Reference: ConnectToServer/
GetConfigFromServer/SendToServer/WaitForServer (Network.cpp:768-1254)
and the client branches of SolveKeyGPU (Kangaroo.cpp:577-612).  The byte
protocol is the reference's, so this client feeds a stock C++ server or
a kangaroo_tpu server as well as the port's.

The walk runs through KangarooSolver.solve(dp_sink=...): each window's
DPs arrive as 40-byte wire records, wait in a pending buffer and go to
the server every send period on the solver thread.  Unlike
kangaroo_tpu's client, a lost server is waited for only so long: the
reconnect gives up `reconnect_timeout` seconds (default CLIENT_TIMEOUT,
the server's own idle limit for a client) after the send failed, saves
the unsent DPs beside the work file (.penddp) and raises
ServerUnreachable.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..constants import CLIENT_TIMEOUT, DEFAULT_PORT, SEND_PERIOD
from ..core import curve
from ..core.config import ProblemConfig
from ..io import backup
from ..utils import packing
from . import protocol as proto


class EndOfSearch(Exception):
    """The server reported the end of the search."""


class ServerUnreachable(ConnectionError):
    """No server answered within the reconnect bound."""


class ServerConnection:
    """Blocking client connection with bounded reconnect semantics."""

    def __init__(self, ip: str, port: int = DEFAULT_PORT, timeout: float = 3.0):
        self.ip = ip
        self.port = port
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self.nb_kangaroo = 0

    # -- low-level ---------------------------------------------------------
    def connect(self) -> None:
        sock = socket.create_connection(
            (self.ip, self.port), timeout=self.timeout
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    def _conn(self) -> socket.socket:
        if self.sock is None:
            raise ConnectionError("not connected to the server")
        return self.sock

    def _send(self, data: bytes) -> None:
        proto.send_all(self._conn(), data, self.timeout)

    def _recv(self, n: int) -> bytes:
        return proto.recv_exact(self._conn(), n, self.timeout)

    # -- protocol ------------------------------------------------------------
    def get_config(self) -> Tuple[ProblemConfig, int]:
        """GETCONFIG: returns (problem config, dp_size)."""
        self._send(bytes([proto.SERVER_GETCONFIG]))
        version, rs, re, kx, ky, dp = proto.unpack_config(
            self._recv(proto.CONFIG_SIZE))
        if version < 3:
            raise proto.ProtocolError(
                f"server version must be >= 3 (got {version})"
            )
        key = curve.PointA(kx, ky)
        if not curve.on_curve(key):
            raise proto.ProtocolError("server key does not lie on curve")
        return ProblemConfig(rs, re, [key]), dp

    def set_kangaroo_number(self, nb: int) -> None:
        self.nb_kangaroo = nb
        self._send(bytes([proto.SERVER_SETKNB]) + struct.pack("<Q", nb))

    def get_status(self) -> int:
        self._send(bytes([proto.SERVER_STATUS]))
        return struct.unpack("<i", self._recv(4))[0]

    def send_dps(self, records: List[proto.DPRecord],
                 thread_id: int = 0, gpu_id: int = 0) -> int:
        """SENDDP: returns server status."""
        payload = b"".join(r.pack() for r in records)
        return self.send_dps_raw(
            payload, len(records), thread_id=thread_id, gpu_id=gpu_id
        )

    def send_dps_raw(self, payload: bytes, nb: int,
                     thread_id: int = 0, gpu_id: int = 0) -> int:
        """SENDDP with a pre-packed nb * 40-byte wire payload."""
        self._send(bytes([proto.SERVER_SENDDP]) + proto.pack_dp_header(
            nb, thread_id, os.getpid(), gpu_id))
        self._send(payload)
        return struct.unpack("<i", self._recv(4))[0]

    def _send_name(self, cmd: int, name: str) -> None:
        nm = name.encode()
        self._send(bytes([cmd]) + struct.pack("<I", len(nm)) + nm)

    def save_kangaroos_via_server(self, name: str, records) -> None:
        """SAVEKANG: ship the kangaroos' 16-byte D-encoded distances,
        (N, 16) uint8 or their bytes, for a server-side backup, then
        their 256-bit sum (no reply)."""
        data = (records.tobytes() if isinstance(records, np.ndarray)
                else bytes(records))
        self._send_name(proto.SERVER_SAVEKANG, name)
        self._send(struct.pack("<Q", len(data) // 16))
        self._send(data)
        self._send(proto.kangaroo_checksum(data).to_bytes(32, "little"))

    def load_kangaroos_via_server(self, name: str) -> bytes:
        """LOADKANG: the 16-byte D-encoded distances of a server-side
        backup, concatenated (b"" when the server has none)."""
        self._send_name(proto.SERVER_LOADKANG, name)
        nb = struct.unpack("<Q", self._recv(8))[0]
        if not nb:
            return b""
        data = self._recv(16 * nb)
        want = int.from_bytes(self._recv(32), "little")
        if proto.kangaroo_checksum(data) != want:
            raise proto.ProtocolError("kangaroo download checksum mismatch")
        return data

    # -- reconnect (reference: WaitForServer, Network.cpp:889-980) ---------
    def wait_for_server(self, deadline: float) -> None:
        """Reconnect until the server answers SERVER_OK, once a second;
        raises EndOfSearch on SERVER_END, and ServerUnreachable once
        time.time() passes `deadline` (a connect attempt in flight may
        take `timeout` seconds more)."""
        while True:
            if time.time() >= deadline:
                self.close()
                raise ServerUnreachable(
                    f"no answer from {self.ip}:{self.port} within the "
                    f"reconnect bound")
            try:
                if self.sock is None:
                    self.connect()
                    self.set_kangaroo_number(self.nb_kangaroo)
                status = self.get_status()
            except (OSError, proto.ProtocolError):
                self.close()
                status = None
            if status == proto.SERVER_OK:
                return
            if status == proto.SERVER_END:
                raise EndOfSearch()
            time.sleep(max(0.0, min(1.0, deadline - time.time())))


# -- pending-DP persistence ------------------------------------------------
# The reference's crash answer is duplicate-resend from the kangaroo
# backup (README.md:232: a restarted client re-walks and re-sends, the
# duplicates count as dead kangaroos).  DPs that were captured but never
# acknowledged by the server are also kept, so a client restart re-sends
# them verbatim: duplicates are cheap, losses cost expected ops.
# Sidecar format: u32 magic, u32 count, count * 40 B DP.

_PENDING_MAGIC = 0xFA6A9001


def pending_dp_path(work_file: str) -> str:
    return work_file + ".penddp"


def save_pending_dps(path: str, raw: bytes) -> None:
    """raw: concatenated 40-byte wire records."""
    tmp = path + ".tmp"
    nb = len(raw) // proto.DP_SIZE
    with open(tmp, "wb") as f:
        f.write(struct.pack("<II", _PENDING_MAGIC, nb))
        f.write(raw[:nb * proto.DP_SIZE])
    os.replace(tmp, path)


def load_pending_dps(path: str) -> bytes:
    """Raw concatenated 40-byte wire records (b"" when absent)."""
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        magic, nb = struct.unpack("<II", f.read(8))
        if magic != _PENDING_MAGIC:
            raise ValueError(f"{path}: not a pending-DP file")
        return f.read(proto.DP_SIZE * nb)


@dataclass
class ClientReport:
    """What a run_client call did: its solver (stats, last_state), the
    DPs it delivered, the solver thread's seconds in the sink per call,
    and the (pack, send) seconds of each -wss backup."""
    solver: object
    ended: bool = False          # the server reported the end
    restored: int = 0            # kangaroos restored from the server
    dps_sent: int = 0
    sends: int = 0
    sink_stalls: List[float] = field(default_factory=list)
    wss: List[Tuple[float, float]] = field(default_factory=list)


def run_client(
    server_ip: str,
    port: int,
    opts,
    timeout: float = 3.0,
    save_kangaroo_server: bool = False,
    load_file: str = "",
    max_ticks: Optional[int] = None,
    quiet: bool = False,
    send_period: float = SEND_PERIOD,
    reconnect_timeout: float = CLIENT_TIMEOUT,
) -> ClientReport:
    """Client mode main loop (reference: clientMode branches of Run).

    The server's range, key and DP size replace opts'; the walk runs on
    opts.device, in opts.n_devices shards.  -i (load_file) restores the
    herd from a local HEADK or HEADKS file; -wss (save_kangaroo_server
    with opts.work_file) saves the herd through the server every save
    period and restores it from there at start.  Raises
    ServerUnreachable when a lost server does not come back within
    reconnect_timeout seconds; the unsent DPs are then in the .penddp
    file beside opts.work_file."""
    from ..core.solver import KangarooSolver

    conn = ServerConnection(server_ip, port, timeout)
    conn.connect()
    try:
        cfg, dp = conn.get_config()
        if not quiet:
            print(f"Successfully connected to server: {server_ip}")
        opts.dp_size = dp
        solver = KangarooSolver(cfg, opts)
        conn.set_kangaroo_number(opts.nb_kangaroo)
        solver.init_search_key(0)
        report = ClientReport(solver)
        wss = save_kangaroo_server and bool(opts.work_file)
        rebuild = dict(symmetry=opts.symmetry, device=solver.device)
        if load_file:
            solver.loaded_kangaroos = backup.load_kangaroo_file(
                load_file, cfg.range_start, cfg.range_end,
                solver.key_to_search, **rebuild)
        elif wss:
            try:
                raw = conn.load_kangaroos_via_server(opts.work_file)
            except (OSError, proto.ProtocolError):
                conn.close()
                raw = b""
            if raw:
                d128 = packing.le_bytes_to_limbs(
                    np.frombuffer(raw, dtype=np.uint8).reshape(-1, 16), 8)
                solver.loaded_kangaroos = backup.rebuild_from_d128(
                    d128, cfg.range_start, cfg.range_end,
                    solver.key_to_search, **rebuild)
                report.restored = d128.shape[1]
                if not quiet:
                    print(f"Restored {report.restored} kangaroos from "
                          f"server backup")
    except BaseException:
        conn.close()
        raise

    # -wss: the backup shares the connection with the sink, so it runs
    # on the solver thread, between two sends
    def save_hook(s, px, py, d, elapsed):
        t0 = time.perf_counter()
        recs = backup.d128_records(d, s.width_div2, opts.symmetry)
        t1 = time.perf_counter()
        try:
            conn.save_kangaroos_via_server(opts.work_file, recs)
        except (OSError, proto.ProtocolError):
            conn.close()  # the next send reconnects
        report.wss.append((t1 - t0, time.perf_counter() - t1))

    pending = bytearray()  # concatenated 40-byte wire records
    pend_path = pending_dp_path(opts.work_file) if opts.work_file else None
    if pend_path:
        try:
            restored_dps = load_pending_dps(pend_path)
        except (OSError, ValueError):
            restored_dps = b""
        if restored_dps:
            pending.extend(restored_dps)
            if not quiet:
                print(f"Re-sending {len(restored_dps) // proto.DP_SIZE} "
                      f"pending DPs from {pend_path}")
    last_send = time.time()

    def send_pending() -> bool:
        """Send the pending DPs, reconnecting as long as the bound lets
        it; True when the server reports the end of the search."""
        deadline = None
        while True:
            nb = len(pending) // proto.DP_SIZE
            try:
                status = conn.send_dps_raw(bytes(pending), nb)
            except (OSError, proto.ProtocolError):
                conn.close()
                if deadline is None:
                    deadline = time.time() + reconnect_timeout
                else:  # failed again after a reconnect: back off
                    time.sleep(max(0.0, min(1.0, deadline - time.time())))
                try:
                    conn.wait_for_server(deadline)
                except EndOfSearch:
                    return True
                continue
            pending.clear()
            report.dps_sent += nb
            report.sends += 1
            return status == proto.SERVER_END

    def dp_sink(raw: bytes, nb: int) -> bool:
        nonlocal last_send
        t0 = time.perf_counter()
        pending.extend(raw)
        now = time.time()
        if now - last_send >= send_period:
            last_send = now
            report.ended = send_pending()
        report.sink_stalls.append(time.perf_counter() - t0)
        return report.ended

    try:
        solver.solve(0, dp_sink=dp_sink, max_ticks=max_ticks,
                     save_hook=save_hook if wss else None)
        if pending and not report.ended:
            report.ended = send_pending()
    finally:
        # unacknowledged DPs survive crashes and aborts on disk; a
        # restart re-sends them (duplicates are cheap, losses are not)
        if pend_path:
            if pending and not report.ended:
                save_pending_dps(pend_path, bytes(pending))
                if not quiet:
                    print(f"Saved {len(pending) // proto.DP_SIZE} unsent "
                          f"DPs to {pend_path}")
            elif os.path.exists(pend_path):
                os.remove(pend_path)
        conn.close()
    return report
