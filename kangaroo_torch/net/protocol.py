"""Wire protocol, byte-identical to the reference TCP protocol.

The port's copy of kangaroo_tpu/net/protocol.py (framework-free), plus
the vectorized checksum of the kangaroo backup exchange.

Reference: Network.cpp:40-70 (commands/status), Kangaroo.h:94-111
(structs).  All values little-endian, raw struct layout:

  DP record (40 B):   u32 kIdx, u32 h, 16 B x (low 128 bits of X),
                      16 B d (sign/type-encoded distance)
  DPHEADER (20 B):    u32 header=0x67DEDDC1, u32 nbDP, u32 threadId,
                      u32 processId, u32 gpuId
  GETCONFIG reply:    u32 version, 32 B rangeStart, 32 B rangeEnd,
                      32 B keyX, 32 B keyY, i32 dpSize

A host speaking this protocol interoperates with stock C++ clients and
servers and with kangaroo_tpu's.
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

SERVER_HEADER = 0x67DEDDC1
KANG_PER_BLOCK = 2048

# Commands (Network.cpp:52-58).
SERVER_GETCONFIG = 0
SERVER_STATUS = 1
SERVER_SENDDP = 2
SERVER_SETKNB = 3
SERVER_SAVEKANG = 4
SERVER_LOADKANG = 5
SERVER_RESETDEAD = ord("R")

# Status (Network.cpp:60-63).
SERVER_OK = 0
SERVER_END = 1
SERVER_BACKUP = 2

DP_SIZE = 40
DPHEADER_SIZE = 20

_MASK128 = (1 << 128) - 1
_MASK256 = (1 << 256) - 1


@dataclass
class DPRecord:
    k_idx: int
    h: int
    x128: int
    d128: int

    def pack(self) -> bytes:
        return (
            struct.pack("<II", self.k_idx & 0xFFFFFFFF, self.h)
            + (self.x128 & _MASK128).to_bytes(16, "little")
            + (self.d128 & _MASK128).to_bytes(16, "little")
        )

    @classmethod
    def unpack(cls, data: bytes) -> "DPRecord":
        k_idx, h = struct.unpack_from("<II", data, 0)
        x = int.from_bytes(data[8:24], "little")
        d = int.from_bytes(data[24:40], "little")
        return cls(k_idx, h, x, d)


def pack_dp_header(
    nb_dp: int, thread_id: int = 0, process_id: int = 0, gpu_id: int = 0
) -> bytes:
    return struct.pack(
        "<IIIII", SERVER_HEADER, nb_dp, thread_id, process_id, gpu_id
    )


def unpack_dp_header(data: bytes) -> Tuple[int, int, int, int]:
    hdr, nb, tid, pid, gid = struct.unpack("<IIIII", data)
    if hdr != SERVER_HEADER:
        raise ProtocolError(f"unexpected DP header 0x{hdr:08X}")
    return nb, tid, pid, gid


class ProtocolError(Exception):
    pass


def recv_exact(sock: socket.socket, n: int, timeout: Optional[float] = None) -> bytes:
    """Read exactly n bytes (reference: Read, Network.cpp:120-180), into
    one buffer (a kangaroo backup is 64 MiB at 2^22 lanes)."""
    if timeout is not None:
        sock.settimeout(timeout)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed connection")
        got += k
    return bytes(buf)


def send_all(sock: socket.socket, data: bytes, timeout: Optional[float] = None) -> None:
    if timeout is not None:
        sock.settimeout(timeout)
    sock.sendall(data)


def pack_config(
    version: int, range_start: int, range_end: int,
    key_x: int, key_y: int, dp_size: int,
) -> bytes:
    return (
        struct.pack("<I", version)
        + range_start.to_bytes(32, "little")
        + range_end.to_bytes(32, "little")
        + key_x.to_bytes(32, "little")
        + key_y.to_bytes(32, "little")
        + struct.pack("<i", dp_size)
    )


def unpack_config(data: bytes):
    version = struct.unpack_from("<I", data, 0)[0]
    rs = int.from_bytes(data[4:36], "little")
    re = int.from_bytes(data[36:68], "little")
    kx = int.from_bytes(data[68:100], "little")
    ky = int.from_bytes(data[100:132], "little")
    dp = struct.unpack_from("<i", data, 132)[0]
    return version, rs, re, kx, ky, dp


CONFIG_SIZE = 4 + 32 * 4 + 4


def kangaroo_checksum(data: bytes) -> int:
    """Checksum of a SAVEKANG/LOADKANG payload of 16-byte records: the
    sum of the records as 128-bit integers, kept to 256 bits (reference:
    a 320-bit Int sum serialized as its low 256 bits,
    Network.cpp:460-498).

    Sums each 32-bit word column as uint64 (exact below 2^32 records),
    then combines the four column sums as Python ints."""
    words = np.frombuffer(data, dtype="<u4").reshape(-1, 4)
    cols = words.sum(axis=0, dtype=np.uint64)
    return sum(int(c) << (32 * i) for i, c in enumerate(cols)) & _MASK256
