"""Replication wire protocol: framing + message types.

Counterpart of the reference's replication RPCs
(memgraph/src/storage/v2/replication/rpc.hpp:59-239 —
PrepareCommit/FinalizeCommit/Heartbeat/Snapshot/CurrentWal) over the
reference's SLK-style length-prefixed binary framing (src/rpc, src/slk):
here the payloads reuse the WAL frame encoding (storage/durability/wal.py)
so the replica applies exactly what durability writes.

Frame: [u32 length][u8 type][payload]

Copy of memgraph_tpu/replication/protocol.py for the port: the same
frames, so either package's MAIN feeds the other's replica.
"""

from __future__ import annotations

import json
import socket
import struct

MSG_REGISTER = 0x01       # json: {name, epoch, start_ts}
MSG_REGISTER_OK = 0x02    # json: {last_commit_ts, epoch}
MSG_SNAPSHOT = 0x03       # raw snapshot bytes (full state transfer)
MSG_WAL_FRAME = 0x04      # raw wal txn frame (commit application)
MSG_HEARTBEAT = 0x05      # json: {main_commit_ts}
MSG_ACK = 0x06            # json: {last_commit_ts}
MSG_PREPARE = 0x07        # 2PC phase 1: wal frame held pending a decision
MSG_FINALIZE = 0x08       # 2PC phase 2: json {commit_ts, decision}
MSG_SYSTEM = 0x09         # json: ordered system txn (auth / multi-db DDL)
MSG_FENCED = 0x0A         # json: {fencing_epoch} — registration refused,
                          # the sender's epoch is stale (a deposed MAIN)
MSG_ERROR = 0x7F          # json: {message}


def send_frame(sock: socket.socket, msg_type: int, payload: bytes) -> None:
    sock.sendall(struct.pack(">IB", len(payload) + 1, msg_type) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("replication connection closed")
        out += chunk
    return out


def recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    header = recv_exact(sock, 5)
    length, msg_type = struct.unpack(">IB", header)
    payload = recv_exact(sock, length - 1) if length > 1 else b""
    return msg_type, payload


def send_json(sock, msg_type: int, obj) -> None:
    send_frame(sock, msg_type, json.dumps(obj).encode("utf-8"))


def parse_json(payload: bytes):
    return json.loads(payload.decode("utf-8"))
