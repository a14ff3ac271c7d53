"""DP aggregation server, wire-compatible with the reference.

Counterpart of kangaroo_tpu/net/server.py on the port's native table,
work files and -wcheck re-derivation.  Reference: RunServer
(Network.cpp:642-766), HandleRequest (Network.cpp:280-610),
ProcessServer (Thread.cpp:165-234).

Clients compute random walks and stream distinguished points here; this
process owns the only hash table, resolves collisions, and periodically
checkpoints.  The byte protocol is the reference's, so a stock C++
client, a kangaroo_tpu client and a kangaroo_torch client all connect.

Two differences from kangaroo_tpu's server, by design:
  * a client that is connected when the search ends is not dropped
    mid-exchange: its handler waits for the client's next command (at
    most `timeout` seconds plus twice the longest gap between the
    client's earlier commands, so that a client whose ticks are long
    hears it too) and answers a STATUS or SENDDP with SERVER_END, so
    that the client hears the end instead of finding the server gone and
    reconnecting;
  * -wss backups and point validation are whole-array numpy and device
    work: the kangaroo checksum is summed column by column, and the
    points of a batch are re-derived in one `_check_batch` call on
    `device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
import os
import socket
import struct
import threading
import time
from typing import List, Optional

import numpy as np

from ..constants import (CLIENT_TIMEOUT, DEFAULT_PORT, HEADKS, MAX_CLIENT,
                         N_ORDER, SEND_PERIOD, SERVER_VERSION)
from ..core import curve
from ..core.check import WCHECK_BATCH, _check_batch
from ..core.collision import SolveResult, collision_check
from ..core.config import ProblemConfig
from ..core.hashtable import calc_dist_and_type, make_hash_table
from ..io import backup
from ..io.merge import WorkHeader, write_work_header
from . import protocol as proto

# Seconds between checks of end_of_search while a handler waits for its
# client's next command.
POLL = 0.25
# 16-byte records per read of a kangaroo backup (1 MiB).
KANG_CHUNK = 1 << 16


class DPServer:
    def __init__(
        self,
        cfg: ProblemConfig,
        dp_size: int,
        port: int = DEFAULT_PORT,
        work_file: str = "",
        save_period: float = 60.0,
        split_work_file: bool = False,
        out_file: str = "",
        timeout: float = 3.0,
        validate_points: bool = False,
        symmetry: bool = False,
        device: str = "cuda",
    ):
        self.cfg = cfg
        self.dp_size = dp_size
        self.port = port
        self.work_file = work_file
        self.save_period = save_period
        self.split_work_file = split_work_file
        self.out_file = out_file
        self.timeout = timeout
        self.process_period = SEND_PERIOD  # DP drain tick
        # re-derive every received DP before accepting it (reference:
        # VALIDITY_POINT_CHECK, Network.cpp:547-586) on `device`
        self.validate_points = validate_points
        self.device = device
        self.rejected = 0
        self.quiet = False

        self.hash_table = make_hash_table()
        self.lock = threading.Lock()
        # raw SENDDP payloads (nb * 40 bytes each), parsed only by the
        # drain thread, as numpy views
        self.recv_dp: List[bytes] = []
        self.connected_clients = 0
        self.total_rw = 0
        self.dead = 0
        self.end_of_search = False
        self.result: Optional[SolveResult] = None
        self.key_idx = 0
        # clients see SERVER_BACKUP while a save is in flight (reference
        # saveRequest, Network.cpp:267)
        self.saving = False
        self._save_thread: Optional[threading.Thread] = None
        self._handlers: List[threading.Thread] = []
        # the longest gap between two commands of one client (seconds)
        self._max_gap = 0.0
        # (file, kangaroos, receive s, checksum s, write s) of the last
        # kangaroo backup a client sent
        self.last_backup = None

        # Equivalence-class mode: every client must also walk with -sym
        # (the wire has no marker for it: only the distance convention
        # and the collision's key translation shift)
        self.symmetry = symmetry

        self.range_start = cfg.range_start
        self.range_end = cfg.range_end
        self.width_div2 = (cfg.range_end - cfg.range_start) >> 1
        key = cfg.keys[0]
        sp = self.range_start % N_ORDER
        if symmetry:
            # recenter on the range midpoint so wild distances straddle
            # zero (same translation as KangarooSolver.init_search_key)
            sp = (sp + self.width_div2) % N_ORDER
        if sp != 0:
            self.key_to_search = curve.add(key, curve.mul(sp).neg())
        else:
            self.key_to_search = key
        self.key_to_search_neg = self.key_to_search.neg()

    # -- status ----------------------------------------------------------
    def status(self) -> int:
        """GetServerStatus semantics (Network.cpp:260-272)."""
        if self.end_of_search:
            return proto.SERVER_END
        if self.saving:
            return proto.SERVER_BACKUP
        return proto.SERVER_OK

    # -- client handler (one thread per connection) -----------------------
    def _next_command(self, conn: socket.socket,
                      gap: float = 0.0) -> Optional[int]:
        """The client's next command byte, or None when it closed the
        connection, sent nothing for CLIENT_TIMEOUT seconds, or sent
        nothing within `timeout` + 2 * gap seconds of the end of the
        search (gap: the longest it took between two earlier commands)."""
        now = time.time()
        idle_limit = now + CLIENT_TIMEOUT
        end_limit = None
        while True:
            if self.end_of_search and end_limit is None:
                end_limit = time.time() + self.timeout + 2 * gap
            left = min(idle_limit, end_limit or idle_limit) - time.time()
            if left <= 0:
                return None
            conn.settimeout(min(left, POLL))
            try:
                cmd = conn.recv(1)
            except socket.timeout:
                continue
            return cmd[0] if cmd else None

    def _handle_client(self, conn: socket.socket, addr) -> None:
        nb_kangaroo = 0
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            gap, last = 0.0, None
            while True:
                c = self._next_command(conn, gap)
                if c is None:
                    break
                # a client's ticks set its pace: the end of the search
                # waits for the slowest one's next command
                now = time.time()
                if last is not None and now - last > gap:
                    gap = now - last
                    with self.lock:
                        self._max_gap = max(self._max_gap, gap)
                last = now
                if c == proto.SERVER_GETCONFIG:
                    key = self.cfg.keys[self.key_idx]
                    proto.send_all(conn, proto.pack_config(
                        SERVER_VERSION, self.range_start, self.range_end,
                        key.x, key.y, self.dp_size,
                    ), self.timeout)
                elif c == proto.SERVER_SETKNB:
                    data = proto.recv_exact(conn, 8, self.timeout)
                    delta = struct.unpack("<Q", data)[0]
                    with self.lock:
                        self.total_rw += delta - nb_kangaroo
                        nb_kangaroo = delta
                elif c == proto.SERVER_STATUS:
                    status = self.status()
                    proto.send_all(conn, struct.pack("<i", status),
                                   self.timeout)
                    if status == proto.SERVER_END:
                        break
                elif c == proto.SERVER_SENDDP:
                    head = proto.recv_exact(
                        conn, proto.DPHEADER_SIZE, self.timeout
                    )
                    nb, tid, pid, gid = proto.unpack_dp_header(head)
                    if nb == 0:
                        break
                    # the whole payload is read before the status goes
                    # back, also after the end: the client then reads
                    # SERVER_END, not a reset connection
                    data = proto.recv_exact(
                        conn, nb * proto.DP_SIZE, self.timeout
                    )
                    status = self.status()
                    proto.send_all(conn, struct.pack("<i", status),
                                   self.timeout)
                    if status == proto.SERVER_END:
                        break
                    # raw bytes go to the receive cache: the drain strips
                    # the 4-byte kIdx column with one numpy view
                    with self.lock:
                        self.recv_dp.append(data)
                elif c == proto.SERVER_RESETDEAD:
                    proto.recv_exact(conn, 2, self.timeout)
                    self.dead = 0
                    proto.send_all(conn, b"OK\n", self.timeout)
                elif c == proto.SERVER_SAVEKANG:
                    self._handle_savekang(conn)
                elif c == proto.SERVER_LOADKANG:
                    self._handle_loadkang(conn)
                else:
                    break
        except (ConnectionError, OSError, proto.ProtocolError):
            pass
        finally:
            with self.lock:
                self.total_rw -= nb_kangaroo
                self.connected_clients -= 1
            conn.close()

    def _recv_filename(self, conn) -> str:
        size = struct.unpack(
            "<I", proto.recv_exact(conn, 4, self.timeout)
        )[0]
        if size >= 256:
            raise proto.ProtocolError("FileName too long (MAX=256)")
        name = proto.recv_exact(conn, size, self.timeout).decode(
            "utf-8", "replace"
        )
        # confine server-side kangaroo backups to the working directory
        base = os.path.basename(name)
        return base if base else "kangaroo.bak"

    def _handle_savekang(self, conn) -> None:
        """Server-side kangaroo backup (Network.cpp:417-500): a HEADKS
        file of 16 B distance records, kept when the 256-bit sum
        checksum the client sends matches (no reply either way).  The
        records stream to the file in 1 MiB reads, each summed as numpy
        columns."""
        name = self._recv_filename(conn)
        nb = struct.unpack("<Q", proto.recv_exact(conn, 8, self.timeout))[0]
        tmp = name + ".tmp"
        checksum = 0
        t_recv = t_sum = t_write = 0.0
        with open(tmp, "wb") as f:
            f.write(struct.pack("<II", HEADKS, 0))
            f.write(struct.pack("<Q", nb))
            left = nb
            while left > 0:
                chunk = min(left, KANG_CHUNK)
                t0 = time.perf_counter()
                data = proto.recv_exact(conn, chunk * 16, self.timeout)
                t1 = time.perf_counter()
                checksum += proto.kangaroo_checksum(data)
                t2 = time.perf_counter()
                f.write(data)
                t_recv += t1 - t0
                t_sum += t2 - t1
                t_write += time.perf_counter() - t2
                left -= chunk
        want = int.from_bytes(
            proto.recv_exact(conn, 32, self.timeout), "little"
        )
        if (checksum & ((1 << 256) - 1)) != want:
            print(f"\nWarning, Kangaroo backup wrong checksum {name}")
            os.remove(tmp)
            return
        t0 = time.perf_counter()
        os.replace(tmp, name)
        t_write += time.perf_counter() - t0
        self.last_backup = (name, nb, t_recv, t_sum, t_write)
        if not self.quiet:
            print(f"\nKangaroo backup {name}: {nb} kangaroos, receive "
                  f"{t_recv:.4f} s, checksum {t_sum:.4f} s, write "
                  f"{t_write:.4f} s", flush=True)

    def _handle_loadkang(self, conn) -> None:
        """Send a server-side kangaroo backup back (Network.cpp:502-545):
        u64 count (0 when there is no such file), the records, then the
        checksum when the count is not 0."""
        name = self._recv_filename(conn)
        if not os.path.exists(name):
            proto.send_all(conn, struct.pack("<Q", 0), self.timeout)
            return
        with open(name, "rb") as f:
            head, _ = struct.unpack("<II", f.read(8))
            if head != HEADKS:
                proto.send_all(conn, struct.pack("<Q", 0), self.timeout)
                return
            nb = struct.unpack("<Q", f.read(8))[0]
            proto.send_all(conn, struct.pack("<Q", nb), self.timeout)
            checksum = 0
            left = nb
            while left > 0:
                chunk = min(left, KANG_CHUNK)
                data = f.read(chunk * 16)
                if len(data) != chunk * 16:
                    raise proto.ProtocolError(f"{name}: file ends early")
                proto.send_all(conn, data, self.timeout)
                checksum += proto.kangaroo_checksum(data)
                left -= chunk
        if nb:
            proto.send_all(
                conn,
                (checksum & ((1 << 256) - 1)).to_bytes(32, "little"),
                self.timeout,
            )

    def _validate(self, arr: np.ndarray) -> Optional[np.ndarray]:
        """Keep-mask over (n, 40) uint8 wire records whose x and bucket
        re-derive from their distance (dist*G, plus the key when wild;
        -sym: either sign of the key); None means keep all.  The
        records' columns go to _check_batch on self.device, 2^20 at a
        time; `rejected` counts the rest."""
        h = np.ascontiguousarray(arr[:, 4:8]).view("<u4").ravel()
        xw = np.ascontiguousarray(arr[:, 8:24]).view("<u8")
        dw = np.ascontiguousarray(arr[:, 24:40]).view("<u8")
        wrong = np.concatenate([
            _check_batch(h[o:o + WCHECK_BATCH], xw[o:o + WCHECK_BATCH],
                         dw[o:o + WCHECK_BATCH], self.key_to_search,
                         self.symmetry, self.device)
            for o in range(0, len(h), WCHECK_BATCH)
        ])
        n_wrong = int(wrong.sum())
        if not n_wrong:
            return None
        self.rejected += n_wrong
        return ~wrong

    def _resolve_collision(self, d_new: int, d_old: int) -> None:
        d1, t1 = calc_dist_and_type(d_old)
        d2, t2 = calc_dist_and_type(d_new)
        dead, res = collision_check(
            d1, t1, d2, t2,
            self.key_to_search, self.key_to_search_neg,
            self.range_start,
            width_div2_sym=(self.width_div2 if self.symmetry else None),
        )
        if res is not None:
            self.result = res
            self.end_of_search = True
        elif dead:
            self.dead += 1

    # -- DP drain loop (reference: ProcessServer, Thread.cpp:165) ---------
    def _process_once(self) -> None:
        with self.lock:
            blobs = self.recv_dp
            self.recv_dp = []
        if not blobs:
            return
        raw = blobs[0] if len(blobs) == 1 else b"".join(blobs)
        n = len(raw) // proto.DP_SIZE
        arr = np.frombuffer(raw, dtype=np.uint8).reshape(n, proto.DP_SIZE)
        if self.validate_points and n:
            keep = self._validate(arr)
            if keep is not None:
                arr = arr[keep]
                n = arr.shape[0]
        if not n:
            return
        # strip the 4-byte kIdx column with one numpy view and hand
        # whole chunks to the native table
        recs = np.ascontiguousarray(arr[:, 4:]).tobytes()
        chunk = 32768
        for off in range(0, n, chunk):
            part = min(chunk, n - off)
            _, _, dup_total, colls = self.hash_table.add_batch_raw(
                recs[36 * off:36 * (off + part)], part
            )
            self.dead += dup_total
            for _, d_new, d_old, _ in colls:
                self._resolve_collision(d_new, d_old)
                if self.end_of_search:
                    return

    def _save_work(self) -> None:
        """Background checkpoint (reference: SaveServerWork): a HEADW
        file of the table, with no kangaroos.

        The write runs on its own thread so the accept/process loop
        keeps serving; clients polling STATUS see SERVER_BACKUP while
        the save is in flight (Network.cpp:267).  -wsplit swaps in a
        fresh table synchronously (an exact snapshot); plain saves write
        a fuzzy snapshot, span by span (backup.write_hash_table).
        """
        if self._save_thread is not None and self._save_thread.is_alive():
            return  # previous save still running; try next interval
        name = self.work_file
        table = self.hash_table
        if self.split_work_file:
            name = backup.split_file_name(self.work_file)
            self.hash_table = make_hash_table()
        hdr = WorkHeader(
            self.dp_size, self.range_start, self.range_end,
            self.cfg.keys[self.key_idx], 0, 0.0,
            version=backup.SYM_VERSION if self.symmetry else 0,
        )

        def write():
            try:
                tmp = name + ".tmpsave"
                with open(tmp, "wb") as f:
                    write_work_header(f, hdr)
                    backup.write_hash_table(f, table)
                    f.write(struct.pack("<Q", 0))
                os.replace(tmp, name)
            finally:
                self.saving = False

        self.saving = True
        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._save_thread = t

    def finish_save(self) -> None:
        t = self._save_thread
        if t is not None and t.is_alive():
            t.join()

    def _print_status(self, elapsed: float) -> None:
        n_items = self.hash_table.n_items()
        print(
            f"\r[Client {self.connected_clients}]"
            f"[Kang 2^{math.log2(self.total_rw) if self.total_rw else 0:.2f}]"
            f"[DP Count 2^{math.log2(n_items) if n_items else 0:.2f}]"
            f"[Dead {self.dead}][{elapsed:.0f}s]  ",
            end="",
        )

    # -- main loop ---------------------------------------------------------
    def run(
        self, max_seconds: Optional[float] = None, quiet: bool = False
    ) -> Optional[SolveResult]:
        """Serve until the key is found (or max_seconds pass); returns
        the result.  Before it returns it gives each connected client
        up to `timeout` seconds plus twice its longest gap between
        commands to send its next command and read SERVER_END."""
        self.quiet = quiet
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", self.port))
        self.port = srv.getsockname()[1]  # resolve port 0 -> ephemeral
        srv.listen(MAX_CLIENT)
        srv.settimeout(0.5)
        if not quiet:
            print(f"Kangaroo server listening on port {self.port} "
                  f"(DP{self.dp_size})", flush=True)

        t0 = time.time()

        # Dedicated DP-processing thread (reference: ProcessServer runs
        # on its own thread, Thread.cpp:165-234): drains the receive
        # cache into the hash table, resolves collisions, prints status
        # and triggers periodic saves; the accept loop below never
        # blocks on table work.
        def process_loop():
            last_save = t0
            last_proc = t0
            while not self.end_of_search:
                if max_seconds is not None and time.time() - t0 > max_seconds:
                    break
                time.sleep(
                    max(0.0, self.process_period - (time.time() - last_proc))
                )
                # a processing error must not silently kill DP draining
                # while the accept loop keeps looking alive
                try:
                    self._process_once()
                    now = time.time()
                    if not quiet:
                        self._print_status(now - t0)
                    last_proc = now
                    if (
                        self.work_file
                        and now - last_save > self.save_period
                        and not self.end_of_search
                    ):
                        self._save_work()
                        last_save = now
                except Exception:
                    import traceback

                    print("\nServer DP-processing error (continuing):")
                    traceback.print_exc()
                    last_proc = time.time()

        proc_t = threading.Thread(target=process_loop, daemon=True)
        proc_t.start()
        try:
            while not self.end_of_search:
                if max_seconds is not None and time.time() - t0 > max_seconds:
                    break
                try:
                    conn, addr = srv.accept()
                except socket.timeout:
                    continue
                with self.lock:
                    self.connected_clients += 1
                t = threading.Thread(
                    target=self._handle_client, args=(conn, addr),
                    daemon=True,
                )
                t.start()
                self._handlers = [h for h in self._handlers if h.is_alive()]
                self._handlers.append(t)
            self.end_of_search = True  # stop the process thread on timeout
            proc_t.join(timeout=2 * self.process_period + 5)
            self._process_once()
        finally:
            srv.close()
        limit = time.time() + self.timeout + 2 * self._max_gap + 2 * POLL
        for h in self._handlers:
            h.join(timeout=max(0.0, limit - time.time()))
        if self.result is not None and not quiet:
            pub = curve.get_public_key_hex(self.cfg.keys[self.key_idx], True)
            print(f"\nKey# 0 Pub:  0x{pub}")
            print(f"       Priv: 0x{self.result.private_key:X}", flush=True)
            if self.out_file:
                with open(self.out_file, "a") as f:
                    f.write(f"Pub:  0x{pub}\n")
                    f.write(f"Priv: 0x{self.result.private_key:X}\n")
        return self.result
