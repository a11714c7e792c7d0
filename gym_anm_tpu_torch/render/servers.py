"""Rendering servers: a WebSocket broadcast server and an HTTP file server.

Same architecture as the reference (``rendering/py/servers.py:14-209``): each
server runs in its own ``multiprocessing.Process``; the WS server caches the
``init`` message and replays it to newly-connected browsers, and broadcasts
``update`` messages to all listeners.  The reference depends on the
third-party ``websocket_server`` package; here the server side is a
self-contained RFC 6455 implementation on the stdlib socket module
(text frames only, which is all the protocol uses).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
from contextlib import closing
from http.server import HTTPServer, SimpleHTTPRequestHandler
from multiprocessing import Process

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _free_port() -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_is_free(port: int) -> bool:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        return s.connect_ex(("127.0.0.1", port)) != 0


# ---------------------------------------------------------------------------
# Minimal RFC 6455 server internals.
# ---------------------------------------------------------------------------
def _ws_handshake(conn) -> bool:
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = conn.recv(4096)
        if not chunk:
            return False
        data += chunk
    headers = {}
    for line in data.decode("latin-1").split("\r\n")[1:]:
        if ": " in line:
            k, v = line.split(": ", 1)
            headers[k.lower()] = v
    key = headers.get("sec-websocket-key")
    if key is None:
        return False
    accept = base64.b64encode(hashlib.sha1((key + WS_GUID).encode()).digest()).decode()
    resp = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
    )
    conn.sendall(resp.encode("latin-1"))
    return True


def _ws_recv_text(conn):
    """Receive one text frame; returns str, or None on close/error."""

    def recv_exact(n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    hdr = recv_exact(2)
    if hdr is None:
        return None
    opcode = hdr[0] & 0x0F
    masked = hdr[1] & 0x80
    length = hdr[1] & 0x7F
    if length == 126:
        ext = recv_exact(2)
        if ext is None:
            return None
        length = struct.unpack(">H", ext)[0]
    elif length == 127:
        ext = recv_exact(8)
        if ext is None:
            return None
        length = struct.unpack(">Q", ext)[0]
    mask = recv_exact(4) if masked else b"\x00" * 4
    if mask is None:
        return None
    payload = recv_exact(length) if length else b""
    if payload is None:
        return None
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    if opcode == 0x8:  # close
        return None
    if opcode != 0x1:  # only text frames carry protocol messages
        return ""
    return payload.decode("utf-8", errors="replace")


def _ws_send_text(conn, text: str):
    payload = text.encode("utf-8")
    n = len(payload)
    if n < 126:
        hdr = struct.pack(">BB", 0x81, n)
    elif n < (1 << 16):
        hdr = struct.pack(">BBH", 0x81, 126, n)
    else:
        hdr = struct.pack(">BBQ", 0x81, 127, n)
    conn.sendall(hdr + payload)


def _ws_server_main(host: str, port: int):
    """Accept loop: cache 'init', broadcast everything to listeners."""
    clients = []  # sockets of connected listeners
    lock = threading.Lock()
    cached_init = [None]

    def handle(conn):
        try:
            if not _ws_handshake(conn):
                conn.close()
                return
            with lock:
                clients.append(conn)
                if cached_init[0] is not None:
                    try:
                        _ws_send_text(conn, cached_init[0])
                    except OSError:
                        pass
            while True:
                msg = _ws_recv_text(conn)
                if msg is None:
                    break
                if not msg:
                    continue
                try:
                    label = json.loads(msg).get("messageLabel")
                except (ValueError, AttributeError):
                    label = None
                if label == "init":
                    cached_init[0] = msg
                with lock:
                    # Broadcast to every other connection; drop the dead ones
                    # (tolerating client-removal races like the reference,
                    # servers.py:137-141).
                    for c in list(clients):
                        if c is conn:
                            continue
                        try:
                            _ws_send_text(c, msg)
                        except OSError:
                            try:
                                clients.remove(c)
                            except ValueError:
                                pass
        finally:
            with lock:
                if conn in clients:
                    clients.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    while True:
        conn, _ = srv.accept()
        threading.Thread(target=handle, args=(conn,), daemon=True).start()


class WsServer:
    """WebSocket broadcast server on 127.0.0.1 in a separate process
    (default port 9001, else a random free port; servers.py:14-141)."""

    DEFAULT_PORT = 9001

    def __init__(self):
        self.host = "127.0.0.1"
        self.port = self.DEFAULT_PORT if _port_is_free(self.DEFAULT_PORT) else _free_port()
        self.address = f"ws://{self.host}:{self.port}"
        self.process = Process(target=_ws_server_main, args=(self.host, self.port), daemon=True)
        self.process.start()


class _QuietHandler(SimpleHTTPRequestHandler):
    def log_message(self, fmt, *args):  # pragma: no cover
        pass


def _http_server_main(port: int, root: str):
    os.chdir(root)
    HTTPServer(("127.0.0.1", port), _QuietHandler).serve_forever()


class HttpServer:
    """HTTP server for the browser client files (servers.py:144-197)."""

    DEFAULT_PORT = 8000

    def __init__(self, root: str):
        self.port = self.DEFAULT_PORT if _port_is_free(self.DEFAULT_PORT) else _free_port()
        self.address = f"http://127.0.0.1:{self.port}"
        self.process = Process(target=_http_server_main, args=(self.port, root), daemon=True)
        self.process.start()
