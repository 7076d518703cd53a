"""Wire protocol for the serving front door — framing + a socket endpoint
(``repro/serving/protocol.py``).

The deployment shape the paper implies is a service fielding individual
single-image requests from interactive apps. This module puts a socket in
front of ``Server``: a length-prefixed binary framing that any client can
speak, and ``ServerEndpoint``, the threaded acceptor that decodes request
frames into ``Server.submit`` calls and turns settled ``Ticket``s back
into response frames.

Frame layout (network byte order, stdlib ``struct`` + JSON)::

    !I  body_length                  (bounded by MAX_FRAME_BYTES)
    body:
      !H  header_length
      header_length bytes of UTF-8 JSON   (the metadata header)
      remaining bytes: raw payload        (float32 image / logits data)

Request headers carry ``{v, type: "classify", id, network, shape,
image_dtype, dtype, deadline_ms, priority}``; response headers carry
``{v, type: "result", id, status, shape | message}``. Images and logits
travel as contiguous float32 numpy bytes: bf16/fp16 values widen to fp32
exactly, and logits on the card come to the host through
``.cpu().numpy()``, so the wire never perturbs the bitwise-equal-to-
``engine.run`` contract. A frame is byte for byte the one the JAX
package's protocol writes for the same message, so either package's
client talks to either package's endpoint.

Typed rejections from the resilience layer cross the wire as **status
codes** (``overloaded`` / ``deadline_exceeded`` / ``circuit_open``), and
``serving/client.py`` re-raises them as the same exception types — a
remote caller sees exactly the errors an in-process one does. Malformed
frames are a ``bad_request`` response when the stream is still parseable
and a closed connection when it is not; either way the client never
hangs.
"""
from __future__ import annotations

import json
import socket
import struct
import threading

import numpy as np
import torch

from repro_torch.serving.resilience import (
    CircuitOpen,
    DeadlineExceeded,
    Overloaded,
    Rejected,
)

PROTOCOL_VERSION = 1
# hard ceiling on one frame's body: a corrupt or hostile length prefix
# must never make a reader allocate gigabytes. 64 MiB >> any (H, W, C)
# float32 image this repo serves.
MAX_FRAME_BYTES = 64 << 20

_LEN = struct.Struct("!I")    # body length prefix
_HLEN = struct.Struct("!H")   # JSON header length inside the body

# status codes a response frame can carry, and the exception each one
# re-raises client-side. ``ok`` is the success status; ``bad_request``
# and ``internal_error`` map to wire-tier types below.
STATUS_OK = "ok"
STATUS_OVERLOADED = "overloaded"
STATUS_DEADLINE = "deadline_exceeded"
STATUS_CIRCUIT = "circuit_open"
STATUS_BAD_REQUEST = "bad_request"
STATUS_INTERNAL = "internal_error"


class ProtocolError(RuntimeError):
    """The byte stream violated the framing (truncated frame, oversized
    length prefix, malformed header). The connection is unrecoverable —
    readers close it rather than resynchronize."""


class BadRequest(ProtocolError):
    """A well-framed request the server cannot serve (unknown network,
    bad shape, wrong payload size). Travels as ``bad_request`` status —
    the connection itself stays usable."""


class RemoteError(RuntimeError):
    """The server failed internally on this request (``internal_error``
    status): the dispatch raised something that is not a typed
    rejection. The message carries the server-side exception text."""


def status_for(exc: BaseException) -> str:
    """Map a server-side exception to its wire status code."""
    if isinstance(exc, Overloaded):
        return STATUS_OVERLOADED
    if isinstance(exc, DeadlineExceeded):
        return STATUS_DEADLINE
    if isinstance(exc, CircuitOpen):
        return STATUS_CIRCUIT
    if isinstance(exc, (BadRequest, Rejected)):
        return STATUS_BAD_REQUEST
    return STATUS_INTERNAL


def error_for(status: str, message: str) -> BaseException:
    """Re-raise side: the client-side exception for a non-ok status."""
    if status == STATUS_OVERLOADED:
        return Overloaded(message)
    if status == STATUS_DEADLINE:
        return DeadlineExceeded(message)
    if status == STATUS_CIRCUIT:
        return CircuitOpen(message)
    if status == STATUS_BAD_REQUEST:
        return BadRequest(message)
    return RemoteError(message)


def _float32(a) -> np.ndarray:
    """``a`` (a numpy array, a tensor on any device, a nested list) as a
    contiguous float32 numpy array; a tensor comes to the host through
    ``.cpu().numpy()`` (bf16 first widens to fp32 on its device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype not in (torch.float32, torch.float64, torch.float16):
            a = a.float()
        a = a.cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


# ---------------------------------------------------------------------------
# framing


def pack_frame(header: dict, payload: bytes = b"") -> bytes:
    """One wire frame: length prefix + (header-length, JSON header,
    payload)."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body_len = _HLEN.size + len(hdr) + len(payload)
    if body_len > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame body of {body_len} bytes exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES})")
    return _LEN.pack(body_len) + _HLEN.pack(len(hdr)) + hdr + payload


def unpack_body(body: bytes) -> tuple[dict, bytes]:
    """Split a frame body into (header dict, payload bytes)."""
    if len(body) < _HLEN.size:
        raise ProtocolError(f"frame body too short ({len(body)} bytes)")
    (hlen,) = _HLEN.unpack_from(body)
    if _HLEN.size + hlen > len(body):
        raise ProtocolError(
            f"header length {hlen} overruns frame body of {len(body)} bytes")
    try:
        header = json.loads(body[_HLEN.size:_HLEN.size + hlen])
    except ValueError as e:
        raise ProtocolError(f"frame header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError("frame header must be a JSON object")
    return header, body[_HLEN.size + hlen:]


def read_frame(recv_exactly) -> tuple[dict, bytes] | None:
    """Read one frame via ``recv_exactly(n) -> bytes`` (returns short or
    empty bytes at EOF). Returns None on clean EOF at a frame boundary;
    raises ``ProtocolError`` on truncation mid-frame or an oversized
    length prefix."""
    prefix = recv_exactly(_LEN.size)
    if not prefix:
        return None  # clean EOF between frames
    if len(prefix) < _LEN.size:
        raise ProtocolError("connection truncated inside a length prefix")
    (body_len,) = _LEN.unpack(prefix)
    if body_len > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"length prefix {body_len} exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES}); refusing to allocate")
    body = recv_exactly(body_len)
    if len(body) < body_len:
        raise ProtocolError(
            f"connection truncated inside a frame body "
            f"({len(body)}/{body_len} bytes)")
    return unpack_body(body)


def _sock_recv_exactly(sock: socket.socket):
    """A ``recv_exactly`` over a blocking socket (short read on EOF)."""

    def recv_exactly(n: int) -> bytes:
        chunks = []
        remaining = n
        while remaining:
            try:
                chunk = sock.recv(min(remaining, 1 << 20))
            except OSError:
                break  # peer reset / socket closed: surfaces as short read
            if not chunk:
                break
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    return recv_exactly


# ---------------------------------------------------------------------------
# message encoding


def encode_request(req_id: int, network: str, image, *, dtype=None,
                   deadline_ms=None, priority: int = 0) -> bytes:
    """A classify-request frame: the image travels as contiguous float32
    (exact for fp32/bf16/fp16 sources), options in the header."""
    arr = _float32(image)
    header = {
        "v": PROTOCOL_VERSION,
        "type": "classify",
        "id": int(req_id),
        "network": network,
        "shape": list(arr.shape),
        "image_dtype": "float32",
        "dtype": dtype,
        "deadline_ms": deadline_ms,
        "priority": int(priority),
    }
    return pack_frame(header, arr.tobytes())


def decode_request(header: dict, payload: bytes):
    """Validate a classify frame -> (network, image ndarray,
    RequestOptions). Raises ``BadRequest`` on anything malformed —
    the endpoint answers with a ``bad_request`` status, it never drops
    the connection for a well-framed bad request."""
    from repro_torch.serving.request import RequestOptions

    if header.get("v") != PROTOCOL_VERSION:
        raise BadRequest(
            f"unsupported protocol version {header.get('v')!r} "
            f"(this server speaks v{PROTOCOL_VERSION})")
    if header.get("type") != "classify":
        raise BadRequest(f"unknown frame type {header.get('type')!r}")
    network = header.get("network")
    if not isinstance(network, str) or not network:
        raise BadRequest(f"missing or invalid network: {network!r}")
    if header.get("image_dtype") != "float32":
        raise BadRequest(
            f"image payload must be float32, got "
            f"{header.get('image_dtype')!r}")
    shape = header.get("shape")
    if (not isinstance(shape, list) or not shape
            or not all(isinstance(d, int) and d > 0 for d in shape)):
        raise BadRequest(f"invalid image shape: {shape!r}")
    expected = int(np.prod(shape)) * 4
    if expected != len(payload):
        raise BadRequest(
            f"payload is {len(payload)} bytes but shape {shape} needs "
            f"{expected}")
    # a writable copy: torch.as_tensor warns on a read-only buffer
    image = np.frombuffer(payload, dtype=np.float32).reshape(shape).copy()
    dtype = header.get("dtype")
    if dtype is not None and not isinstance(dtype, str):
        raise BadRequest(f"invalid dtype: {dtype!r}")
    deadline_ms = header.get("deadline_ms")
    if deadline_ms is not None and not isinstance(deadline_ms, (int, float)):
        raise BadRequest(f"invalid deadline_ms: {deadline_ms!r}")
    opts = RequestOptions(dtype=dtype, deadline_ms=deadline_ms,
                          priority=int(header.get("priority") or 0))
    return network, image, opts


def encode_response(req_id, *, logits=None, status: str = STATUS_OK,
                    message: str | None = None) -> bytes:
    """A result frame: logits as float32 payload on ok, a status code +
    message on error."""
    header = {
        "v": PROTOCOL_VERSION,
        "type": "result",
        "id": None if req_id is None else int(req_id),
        "status": status,
    }
    payload = b""
    if status == STATUS_OK:
        arr = _float32(logits)
        header["shape"] = list(arr.shape)
        payload = arr.tobytes()
    else:
        header["message"] = message or status
    return pack_frame(header, payload)


def decode_response(header: dict, payload: bytes):
    """-> (id, status, message, logits-or-None)."""
    if header.get("type") != "result":
        raise ProtocolError(f"expected a result frame, got "
                            f"{header.get('type')!r}")
    status = header.get("status", STATUS_INTERNAL)
    if status == STATUS_OK:
        shape = header.get("shape") or []
        logits = np.frombuffer(payload, dtype=np.float32).reshape(shape)
        return header.get("id"), status, None, logits
    return header.get("id"), status, header.get("message", status), None


# ---------------------------------------------------------------------------
# the server endpoint


class ServerEndpoint:
    """A threaded socket front door around one ``Server``.

    Listens on ``(host, port)`` (port 0 = ephemeral; read ``.address``),
    accepts any number of connections, and per connection runs a reader
    thread: each classify frame becomes ``server.submit(...)`` and the
    resulting ``Ticket``'s done-callback writes the response frame — so a
    slow dispatch never blocks the reader, and responses interleave in
    completion order (the ``id`` field is how clients match them up).

    Typed rejections (``Overloaded``/``DeadlineExceeded``/``CircuitOpen``)
    and ``BadRequest`` decode errors become status responses on a live
    connection. A framing violation or client disconnect closes the
    connection and **cancels every in-flight ticket** for it — a vanished
    client's queued requests shed at dequeue instead of computing logits
    nobody will read.
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)  # so the accept loop sees close()
        self.address = self._sock.getsockname()[:2]
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._closed = False
        self._served = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"endpoint-accept-{self.address[1]}")
        self._accept_thread.start()

    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="endpoint-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(None)
        recv_exactly = _sock_recv_exactly(conn)
        write_lock = threading.Lock()  # done-callbacks fire concurrently
        inflight: dict[int, object] = {}  # req id -> Ticket
        alive = [True]

        def send(frame: bytes) -> None:
            with write_lock:
                if not alive[0]:
                    return  # connection torn down: drop the response
                try:
                    conn.sendall(frame)
                except OSError:
                    alive[0] = False

        def on_done(req_id):
            def callback(ticket):
                with self._lock:
                    self._served += 1
                inflight.pop(req_id, None)
                exc = ticket.exception()
                if exc is None:
                    send(encode_response(req_id,
                                         logits=ticket.result()))
                else:
                    send(encode_response(req_id, status=status_for(exc),
                                         message=str(exc)))
            return callback

        try:
            while True:
                try:
                    frame = read_frame(recv_exactly)
                except ProtocolError:
                    break  # unrecoverable stream: tear down
                if frame is None:
                    break  # clean EOF
                header, payload = frame
                req_id = header.get("id")
                try:
                    network, image, opts = decode_request(header, payload)
                    ticket = self.server.submit(network, image, options=opts)
                except (BadRequest, KeyError, ValueError) as e:
                    # unknown network raises KeyError from configs.get;
                    # both are the client's fault: answer, keep the conn
                    send(encode_response(req_id, status=STATUS_BAD_REQUEST,
                                         message=str(e)))
                    continue
                except Rejected as e:  # typed shed at admission
                    send(encode_response(req_id, status=status_for(e),
                                         message=str(e)))
                    continue
                except Exception as e:  # noqa: BLE001 - reported, not eaten
                    send(encode_response(req_id, status=STATUS_INTERNAL,
                                         message=str(e)))
                    continue
                inflight[req_id] = ticket
                ticket.add_done_callback(on_done(req_id))
        finally:
            with write_lock:
                alive[0] = False
            # a vanished client's queued work sheds at dequeue: cancel
            # every ticket still in flight for this connection
            for ticket in list(inflight.values()):
                ticket.cancel()
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    # ------------------------------------------------------------------

    def close(self) -> None:
        """Stop accepting, close every live connection. Idempotent. The
        wrapped ``Server`` is NOT closed — the endpoint is a view onto
        it, not its owner."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        self._sock.close()
        self._accept_thread.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        with self._lock:
            return {"address": list(self.address),
                    "connections": len(self._conns),
                    "served": self._served,
                    "closed": self._closed}
