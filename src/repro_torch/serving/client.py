"""Asyncio client for the serving wire protocol
(``repro/serving/client.py``).

``AsyncClient`` speaks the length-prefixed framing from
``serving/protocol.py`` over one socket connection and multiplexes any
number of concurrent ``classify`` awaits onto it: each request carries a
client-assigned id, a background reader task matches result frames back
to their waiting futures, so responses can (and do) arrive in completion
order rather than submit order — the whole point of the server's
continuous batching.

Typed rejections travel as status codes and re-raise client-side as the
same exceptions an in-process caller sees (``Overloaded``,
``DeadlineExceeded``, ``CircuitOpen``; malformed requests raise
``BadRequest``, server-side dispatch failures ``RemoteError``). A dropped
connection fails every pending await with ``ConnectionError`` — a client
coroutine never hangs on a dead socket.

    client = await AsyncClient.connect(*endpoint.address)
    logits = await client.classify("resnet18", image,
                                   options=RequestOptions(deadline_ms=50))
    await client.close()

Logits come back as float32 numpy arrays, bitwise equal to ``engine.run``
on the same image: the wire carries float32 both ways and the server's
batcher keeps the sequential contract (``tests/test_torch_wire.py``
asserts it end to end). The frames are the JAX package's byte for byte,
so this client also talks to its endpoint, and its client to ours.
"""
from __future__ import annotations

import asyncio
import itertools

from repro_torch.serving.protocol import (
    MAX_FRAME_BYTES,
    ProtocolError,
    decode_response,
    encode_request,
    error_for,
    unpack_body,
)


class AsyncClient:
    """One connection to a ``ServerEndpoint``; safe for concurrent
    ``classify`` awaits from one event loop."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._ids = itertools.count()
        self._pending: dict[int, asyncio.Future] = {}
        self._closed = False
        self._read_task = asyncio.get_running_loop().create_task(
            self._read_loop())

    @classmethod
    async def connect(cls, host: str, port: int) -> "AsyncClient":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    # ------------------------------------------------------------------

    async def classify(self, network: str, image, *, options=None):
        """Submit one (H, W, C) image; returns the (classes,) float32
        logits. ``options`` is a ``RequestOptions`` (dtype variant,
        deadline override, scheduler priority). Raises the same typed
        rejections an in-process ``Server.submit`` caller would see."""
        if self._closed:
            raise ConnectionError("client is closed")
        req_id = next(self._ids)
        dtype = deadline_ms = None
        priority = 0
        if options is not None:
            dtype = options.dtype
            deadline_ms = options.deadline_ms
            priority = options.priority
        future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = future
        try:
            self._writer.write(encode_request(
                req_id, network, image, dtype=dtype,
                deadline_ms=deadline_ms, priority=priority))
            await self._writer.drain()
        except (OSError, ConnectionError):
            self._pending.pop(req_id, None)
            raise ConnectionError("connection to server lost") from None
        try:
            return await future
        finally:
            self._pending.pop(req_id, None)

    async def _read_loop(self) -> None:
        error: BaseException = ConnectionError(
            "connection closed by server")
        try:
            while True:
                try:
                    prefix = await self._reader.readexactly(4)
                except asyncio.IncompleteReadError as e:
                    if e.partial:
                        error = ProtocolError(
                            "connection truncated inside a length prefix")
                    break
                body_len = int.from_bytes(prefix, "big")
                if body_len > MAX_FRAME_BYTES:
                    error = ProtocolError(
                        f"length prefix {body_len} exceeds MAX_FRAME_BYTES")
                    break
                try:
                    body = await self._reader.readexactly(body_len)
                except asyncio.IncompleteReadError:
                    error = ProtocolError(
                        "connection truncated inside a frame body")
                    break
                req_id, status, message, logits = decode_response(
                    *unpack_body(body))
                future = self._pending.pop(req_id, None)
                if future is None or future.done():
                    continue  # response for a cancelled/unknown await
                if status == "ok":
                    future.set_result(logits)
                else:
                    future.set_exception(error_for(status, message))
        except (OSError, ProtocolError) as e:
            error = e
        finally:
            # never leave a coroutine hanging on a dead socket
            for future in self._pending.values():
                if not future.done():
                    future.set_exception(
                        error if isinstance(error, ProtocolError)
                        else ConnectionError(str(error)))
            self._pending.clear()

    # ------------------------------------------------------------------

    async def close(self) -> None:
        """Close the connection; pending awaits fail with
        ``ConnectionError``. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._read_task.cancel()
        try:
            await self._read_task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
        for future in self._pending.values():
            if not future.done():
                future.set_exception(ConnectionError("client closed"))
        self._pending.clear()
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except (OSError, ConnectionError):
            pass
