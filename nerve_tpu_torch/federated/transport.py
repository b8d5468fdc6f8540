"""Socket transport for truly-external federated clients (the port's own
copy of ``nerve_tpu/federated/transport.py``: the same protocol, so either
package's client can answer either package's server).

A dependency-free framed-numpy protocol over TCP:

  frame   := u64_le(header_len) header json_bytes payload*
  header  := {"op": str, "meta": {...}, "arrays": [{"dtype", "shape"}, ...]}
  payload := raw little-endian array bytes, in header order

Ops: "fit" / "evaluate" (server → client requests), "result" (client →
server), "join", "close". The server keeps one thread accepting client
connections and runs synchronous rounds over them. A client retries its
connection until ``connect_timeout`` so that it may start before its
server listens.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- #
# Framing
# --------------------------------------------------------------------------- #


def _send_msg(sock: socket.socket, op: str, meta: Dict[str, Any],
              arrays: Sequence[np.ndarray]) -> None:
    arrays = [np.ascontiguousarray(a) for a in arrays]
    header = json.dumps({
        "op": op,
        "meta": meta,
        "arrays": [{"dtype": str(a.dtype), "shape": list(a.shape)} for a in arrays],
    }).encode()
    sock.sendall(struct.pack("<Q", len(header)))
    sock.sendall(header)
    for a in arrays:
        sock.sendall(a.tobytes())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[str, Dict[str, Any], List[np.ndarray]]:
    (hlen,) = struct.unpack("<Q", _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen))
    arrays = []
    for spec in header["arrays"]:
        dtype = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        nbytes = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
        raw = _recv_exact(sock, nbytes)
        arrays.append(np.frombuffer(raw, dtype=dtype).reshape(shape).copy())
    return header["op"], header.get("meta", {}), arrays


def parse_address(address: str) -> Tuple[str, int]:
    """'[::]:8080' / 'host:port' → (host, port)."""
    host, _, port = address.rpartition(":")
    host = host.strip("[]") or "::"
    return host, int(port)


def _family(host: str) -> int:
    return socket.AF_INET6 if ":" in host else socket.AF_INET


# --------------------------------------------------------------------------- #
# Server
# --------------------------------------------------------------------------- #


class FLServerTransport:
    """Accepts client connections; lets a strategy loop send them fit/evaluate requests."""

    def __init__(self, address: str = "[::]:8080"):
        host, port = parse_address(address)
        self._listener = socket.socket(_family(host), socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen()
        self.port = self._listener.getsockname()[1]
        self._clients: Dict[str, socket.socket] = {}
        self._lock = threading.Lock()
        self._accepting = True
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        cid = 0
        while self._accepting:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            try:
                op, meta, _ = _recv_msg(sock)
            except (ConnectionError, OSError, ValueError):
                sock.close()  # a connection that closed or spoke no frame
                continue
            if op != "join":
                sock.close()
                continue
            name = meta.get("client_id") or f"client-{cid}"
            cid += 1
            with self._lock:
                self._clients[name] = sock

    def wait_for_clients(self, n: int, timeout: float = 60.0) -> List[str]:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if len(self._clients) >= n:
                    return list(self._clients)
            time.sleep(0.05)
        with self._lock:
            return list(self._clients)

    def available_clients(self) -> List[str]:
        with self._lock:
            return list(self._clients)

    def request(self, client_id: str, op: str, meta: Dict[str, Any],
                arrays: Sequence[np.ndarray]) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        with self._lock:
            sock = self._clients[client_id]
        _send_msg(sock, op, meta, arrays)
        rop, rmeta, rarrays = _recv_msg(sock)
        if rop != "result":
            raise RuntimeError(f"unexpected reply op {rop!r}")
        return rmeta, rarrays

    def close(self) -> None:
        self._accepting = False
        with self._lock:
            for sock in self._clients.values():
                try:
                    _send_msg(sock, "close", {}, [])
                    sock.close()
                except OSError:
                    pass
            self._clients.clear()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept
        except OSError:
            pass
        self._listener.close()
        self._accept_thread.join(timeout=5.0)


# --------------------------------------------------------------------------- #
# Client side
# --------------------------------------------------------------------------- #


def connect(address: str, timeout: float = 30.0) -> socket.socket:
    """A connected socket, retrying a refused connection until ``timeout``."""
    host, port = parse_address(address)
    deadline = time.time() + timeout
    while True:
        sock = socket.socket(_family(host), socket.SOCK_STREAM)
        try:
            sock.connect((host, port))
            return sock
        except ConnectionRefusedError:
            sock.close()
            if time.time() >= deadline:
                raise
            time.sleep(0.2)


def run_client(client, address: str, client_id: Optional[str] = None,
               connect_timeout: float = 30.0) -> None:
    """Connect a ``VideoEnhancementClient``-like object and serve fit and
    evaluate requests until the server closes (parity:
    ``fl.client.start_numpy_client``)."""
    sock = connect(address, connect_timeout)
    _send_msg(sock, "join", {"client_id": client_id or ""}, [])
    try:
        while True:
            op, meta, arrays = _recv_msg(sock)
            if op == "fit":
                new_params, n, metrics = client.fit(arrays, meta)
                _send_msg(sock, "result", {"num_samples": int(n), "metrics": metrics},
                          new_params)
            elif op == "evaluate":
                loss, n, metrics = client.evaluate(arrays, meta)
                _send_msg(sock, "result",
                          {"loss": loss, "num_samples": int(n), "metrics": metrics}, [])
            elif op == "close":
                return
            else:
                raise RuntimeError(f"unknown op {op!r}")
    finally:
        sock.close()
