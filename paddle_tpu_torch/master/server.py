"""TCP front-end for the master Service.

Wire protocol (shared with the C++ server in native/master): each message
is a 4-byte little-endian u32 length followed by a UTF-8 JSON object.
Request:  {"method": str, "params": {...}}
Response: {"ok": bool, "result": ...} or {"ok": false, "error": str}

This is the ProtoServer/LightNetwork analog (reference:
paddle/pserver/ProtoServer.h:36-111, LightNetwork.h:40-175) with JSON in
place of protobuf — the payloads here are tiny control messages, not
tensors; tensor traffic in this framework rides XLA collectives instead.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Optional

from .service import Service, dispatch

_LEN = struct.Struct("<I")


def send_msg(sock: socket.socket, obj) -> None:
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket):
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        svc: Service = self.server.service  # type: ignore[attr-defined]
        while True:
            try:
                req = recv_msg(self.request)
            except (ConnectionError, OSError):
                return
            if req is None:
                return
            try:
                result = self._dispatch(svc, req)
                resp = {"ok": True, "result": result}
            except Exception as e:  # surfaced to the client, not fatal
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                send_msg(self.request, resp)
            except (ConnectionError, OSError):
                return

    @staticmethod
    def _dispatch(svc: Service, req):
        return dispatch(svc, req.get("method"), req.get("params"))


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class MasterServer:
    """Threaded TCP server wrapping a Service; start()/stop() lifecycle."""

    def __init__(self, service: Optional[Service] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service or Service()
        # the ThreadingTCPServer does its own internal locking; the
        # REFERENCE to it (and to the acceptor thread below) is only
        # rebound by the owner thread that calls start()/stop() —
        # handler threads reach the server through their own argument,
        # never through these fields
        # guarded_by(serialized: owner thread drives start()/stop())
        self._srv = _Server((host, port), _Handler)
        self._srv.service = self.service  # type: ignore[attr-defined]
        # guarded_by(serialized: owner thread drives start()/stop())
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "MasterServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=5)
