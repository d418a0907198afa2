"""The client half of the serving wire protocol, the benchmark's own
copy: each message a 4-byte big-endian length and the ``np.save`` bytes
of one array."""

from __future__ import annotations

import io
import socket
from typing import List

import numpy as np


def encode(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    payload = buf.getvalue()
    return len(payload).to_bytes(4, "big") + payload


def decode(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload), allow_pickle=False)


class Decoder:
    """Cuts a byte stream into its messages' arrays."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[np.ndarray]:
        self._buf += data
        out = []
        while len(self._buf) >= 4:
            n = int.from_bytes(self._buf[:4], "big")
            if len(self._buf) < 4 + n:
                break
            out.append(decode(bytes(self._buf[4:4 + n])))
            del self._buf[:4 + n]
        return out


def recv_one(conn: socket.socket) -> np.ndarray:
    """One whole message from a blocking socket."""
    dec = Decoder()
    while True:
        data = conn.recv(1 << 20)
        if not data:
            raise ConnectionError("the server closed the connection")
        got = dec.feed(data)
        if got:
            return got[0]

