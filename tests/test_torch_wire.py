"""The port's wire tier on the CPU (ported from ``tests/test_protocol.py``):
framing round-trips, protocol fuzzing (a malformed or hostile byte stream
gives a typed error, never a hung client or a giant allocation), the
asyncio client end to end over a real socket (logits bitwise equal to
``engine.run``), typed rejections across the wire, and a client that
vanishes mid-request. Then the two packages against each other: the same
request, response and error give the same bytes, and the JAX package's
``AsyncClient`` gets answers from a torch ``ServerEndpoint`` bitwise
equal to the torch ``engine.run``.

Every wait is bounded (at most 60 s); everything imports from
``repro_torch.serving``, whose public surface carries the protocol."""
import asyncio
import socket
import threading
import time

import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as serving
from repro_torch.configs import get, tiny_variant
from repro_torch.core import InferenceEngine
from repro_torch.serving import (
    MAX_FRAME_BYTES,
    AsyncClient,
    BadRequest,
    DeadlineExceeded,
    FaultInjector,
    ProtocolError,
    RequestOptions,
    Server,
    ServerEndpoint,
    ServingOptions,
    decode_request,
    decode_response,
    encode_request,
    encode_response,
    pack_frame,
    read_frame,
    unpack_body,
)

WAIT = 60
RESNET = tiny_variant(get("resnet18"))


def _reader(data: bytes):
    """A recv_exactly over an in-memory byte string (short read at end)."""
    view = memoryview(data)
    pos = [0]

    def recv_exactly(n):
        chunk = view[pos[0]:pos[0] + n]
        pos[0] += len(chunk)
        return bytes(chunk)

    return recv_exactly


def _image(seed):
    return np.random.default_rng(seed).standard_normal(
        (32, 32, 3)).astype(np.float32)


def _server(**options):
    return Server(tiny=True, device="cpu", options=ServingOptions(**options))


# ---------------------------------------------------------------------------
# framing round-trips


def test_request_frame_round_trip():
    img = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    frame = encode_request(7, "resnet18", img, dtype="bfloat16",
                           deadline_ms=50.0, priority=2)
    header, payload = read_frame(_reader(frame))
    network, image, opts = decode_request(header, payload)
    assert network == "resnet18"
    np.testing.assert_array_equal(image, img)
    assert image.flags.writeable
    assert opts == RequestOptions(dtype="bfloat16", deadline_ms=50.0,
                                  priority=2)
    assert header["id"] == 7


def test_response_frame_round_trip():
    logits = np.linspace(-1, 1, 10, dtype=np.float32)
    ok = encode_response(3, logits=logits)
    rid, status, message, out = decode_response(*read_frame(_reader(ok)))
    assert (rid, status, message) == (3, "ok", None)
    np.testing.assert_array_equal(out, logits)

    err = encode_response(4, status="overloaded", message="queue full")
    rid, status, message, out = decode_response(*read_frame(_reader(err)))
    assert (rid, status, message, out) == (4, "overloaded", "queue full",
                                           None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_tensor_logits_travel_as_their_float32_values(dtype):
    """A tensor's logits widen to fp32 exactly on their way to the wire:
    the frame is the one of the same values as a float32 numpy array."""
    logits = torch.linspace(-3, 3, 10).to(dtype)
    frame = encode_response(1, logits=logits)
    assert frame == encode_response(1, logits=logits.float().numpy())
    _, _, _, out = decode_response(*read_frame(_reader(frame)))
    assert torch.equal(torch.from_numpy(out.copy()), logits.float())


def test_multiple_frames_stream_and_clean_eof():
    a = pack_frame({"v": 1, "type": "x", "n": 1})
    b = pack_frame({"v": 1, "type": "x", "n": 2}, b"payload")
    recv = _reader(a + b)
    h1, p1 = read_frame(recv)
    h2, p2 = read_frame(recv)
    assert (h1["n"], p1) == (1, b"")
    assert (h2["n"], p2) == (2, b"payload")
    assert read_frame(recv) is None  # clean EOF at a frame boundary


# ---------------------------------------------------------------------------
# fuzz: malformed byte streams -> typed errors, bounded allocations


def test_truncated_length_prefix_is_protocol_error():
    with pytest.raises(ProtocolError, match="length prefix"):
        read_frame(_reader(b"\x00\x00"))


def test_truncated_body_is_protocol_error():
    frame = pack_frame({"v": 1, "type": "x"}, b"0123456789")
    with pytest.raises(ProtocolError, match="truncated"):
        read_frame(_reader(frame[:-4]))


def test_oversized_length_prefix_refused_without_allocating():
    hostile = (MAX_FRAME_BYTES + 1).to_bytes(4, "big")
    with pytest.raises(ProtocolError, match="MAX_FRAME_BYTES"):
        read_frame(_reader(hostile))
    with pytest.raises(ProtocolError, match="MAX_FRAME_BYTES"):
        pack_frame({"v": 1}, bytes(MAX_FRAME_BYTES))


def test_header_overrun_and_bad_json_are_protocol_errors():
    with pytest.raises(ProtocolError, match="overruns"):
        unpack_body(b"\xff\xff")  # header length > body
    with pytest.raises(ProtocolError, match="JSON"):
        unpack_body(b"\x00\x03not-json")
    with pytest.raises(ProtocolError, match="object"):
        unpack_body(b"\x00\x02[]")


@pytest.mark.parametrize("mutate, match", [
    (lambda h: h.update(v=99), "version"),
    (lambda h: h.update(type="mystery"), "frame type"),
    (lambda h: h.update(network=""), "network"),
    (lambda h: h.update(network=None), "network"),
    (lambda h: h.update(image_dtype="float64"), "float32"),
    (lambda h: h.update(shape=[0, 3, 3]), "shape"),
    (lambda h: h.update(shape="nope"), "shape"),
    (lambda h: h.update(shape=[4, 4, 3]), "payload"),  # size mismatch
    (lambda h: h.update(dtype=7), "dtype"),
    (lambda h: h.update(deadline_ms="soon"), "deadline_ms"),
])
def test_malformed_request_headers_are_bad_request(mutate, match):
    img = np.ones((2, 3, 3), dtype=np.float32)
    header, payload = read_frame(_reader(encode_request(1, "net", img)))
    mutate(header)
    with pytest.raises(BadRequest, match=match):
        decode_request(header, payload)


# ---------------------------------------------------------------------------
# end-to-end over a real socket


@pytest.fixture(scope="module")
def endpoint():
    server = _server(max_batch=4, window_ms=2.0)
    server.warm("resnet18")  # build outside every test's clock
    with server, ServerEndpoint(server) as ep:
        yield ep


@pytest.fixture(scope="module")
def truth():
    """Four images and their logits through a CPU engine's ``run``."""
    engine = InferenceEngine(RESNET, device="cpu")
    imgs = [_image(i) for i in range(4)]
    return imgs, [engine.run(im).numpy() for im in imgs]


def test_async_client_bitwise_equal_to_engine_run(endpoint, truth):
    imgs, want = truth

    async def go():
        async with await AsyncClient.connect(*endpoint.address) as client:
            return await asyncio.wait_for(asyncio.gather(
                *(client.classify("resnet18", im) for im in imgs)), WAIT)

    outs = asyncio.run(go())
    for got, ref in zip(outs, want):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_unknown_network_is_typed_error_not_a_hang(endpoint):
    async def go():
        async with await AsyncClient.connect(*endpoint.address) as client:
            with pytest.raises(BadRequest):
                await asyncio.wait_for(
                    client.classify("not-a-network",
                                    np.ones((32, 32, 3), np.float32)),
                    timeout=WAIT)
            # the connection survives a bad request: reuse it
            out = await asyncio.wait_for(
                client.classify("resnet18",
                                np.zeros((32, 32, 3), np.float32)),
                timeout=WAIT)
            assert out.ndim == 1

    asyncio.run(go())


def test_bad_dtype_is_typed_error_not_a_hang(endpoint):
    async def go():
        async with await AsyncClient.connect(*endpoint.address) as client:
            with pytest.raises(BadRequest):
                await asyncio.wait_for(
                    client.classify(
                        "resnet18", np.ones((32, 32, 3), np.float32),
                        options=RequestOptions(dtype="float7")),
                    timeout=WAIT)

    asyncio.run(go())


def test_deadline_exceeded_travels_as_typed_status():
    """A request shed at dequeue server-side re-raises as the SAME typed
    exception in the async client."""
    faults = FaultInjector().delay_from("dispatch", 0, seconds=0.15)
    server = _server(max_batch=1, window_ms=0.0, faults=faults)
    server.warm("resnet18")

    async def go(address):
        async with await AsyncClient.connect(*address) as client:
            img = np.ones((32, 32, 3), np.float32)
            first = asyncio.create_task(client.classify("resnet18", img))
            await asyncio.sleep(0.05)  # first is mid-dispatch
            # queued behind a 0.15s dispatch with a 1ms budget: must shed
            with pytest.raises(DeadlineExceeded):
                await asyncio.wait_for(
                    client.classify("resnet18", img,
                                    options=RequestOptions(deadline_ms=1.0)),
                    timeout=WAIT)
            out = await asyncio.wait_for(first, timeout=WAIT)
            assert out.ndim == 1

    with server, ServerEndpoint(server) as ep:
        asyncio.run(go(ep.address))


def test_client_disconnect_mid_request_sheds_cleanly():
    """A client that vanishes with requests in flight leaves no
    unresolved futures: queued work sheds at dequeue, the dispatch in
    flight completes into the void, and the server keeps serving."""
    faults = FaultInjector().delay_from("dispatch", 0, seconds=0.2)
    server = _server(max_batch=1, window_ms=0.0, faults=faults)
    server.warm("resnet18")
    with server, ServerEndpoint(server) as ep:
        img = np.ones((32, 32, 3), np.float32)
        sock = socket.create_connection(ep.address)
        sock.sendall(encode_request(0, "resnet18", img))
        sock.sendall(encode_request(1, "resnet18", img))
        time.sleep(0.08)  # request 0 is mid-dispatch, request 1 queued
        sock.close()      # vanish

        def batcher_stats():
            nets = server.stats()["networks"]
            return next(iter(nets.values())) if nets else None

        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline:
            b = batcher_stats()
            if b and b["shed"]["cancelled"] >= 1 and b["queue_depth"] == 0:
                break
            time.sleep(0.02)
        b = batcher_stats()
        assert b["shed"]["cancelled"] >= 1  # the queued request shed
        assert b["queue_depth"] == 0        # nothing left dangling

        # and the endpoint still serves new clients afterwards
        async def go():
            async with await AsyncClient.connect(*ep.address) as client:
                return await asyncio.wait_for(
                    client.classify("resnet18", img), timeout=WAIT)

        assert asyncio.run(go()).ndim == 1
        deadline = time.perf_counter() + 5
        while ep.stats()["connections"] and time.perf_counter() < deadline:
            time.sleep(0.02)  # server-side reader notices the EOF async
        assert ep.stats()["connections"] == 0


def test_server_close_fails_pending_awaits_not_hangs():
    """Endpoint torn down under a waiting client: the await fails with a
    connection error instead of hanging."""
    server = _server(max_batch=1, window_ms=0.0)
    server.warm("resnet18")
    ep = ServerEndpoint(server)

    async def go():
        client = await AsyncClient.connect(*ep.address)
        try:
            closer = threading.Timer(0.15, ep.close)
            closer.start()
            # the endpoint closes the conn under us mid-wait; depending
            # on timing the request may also complete first — both are
            # fine, a hang is not
            try:
                await asyncio.wait_for(
                    client.classify("resnet18",
                                    np.ones((32, 32, 3), np.float32)),
                    timeout=WAIT)
            except (ConnectionError, ProtocolError):
                pass
            closer.join()
        finally:
            await client.close()

    try:
        asyncio.run(go())
    finally:
        ep.close()
        server.close()


# ---------------------------------------------------------------------------
# the two packages on one wire


def test_public_surface_is_the_references():
    assert serving.__all__ == jserving.__all__
    assert (serving.PROTOCOL_VERSION, serving.MAX_FRAME_BYTES) \
        == (jserving.PROTOCOL_VERSION, jserving.MAX_FRAME_BYTES) == (1, 64 << 20)


def _request(pkg, kind):
    img = np.random.default_rng(5).standard_normal((4, 5, 3)).astype(
        np.float32)
    if kind == "plain":
        return pkg.encode_request(0, "resnet18", img)
    return pkg.encode_request(2 ** 31 + 3, "mobilenet_v2", img,
                              dtype="bfloat16", deadline_ms=12.5, priority=3)


@pytest.mark.parametrize("kind", ["plain", "options"])
def test_request_frames_are_byte_identical(kind):
    assert _request(serving, kind) == _request(jserving, kind)


@pytest.mark.parametrize("status, message", [
    ("ok", None), ("overloaded", "queue full"),
    ("deadline_exceeded", "late"), ("circuit_open", "open"),
    ("bad_request", "unknown arch 'x'"), ("internal_error", None)])
def test_response_frames_are_byte_identical(status, message):
    logits = np.random.default_rng(6).standard_normal(10).astype(np.float32)
    kw = {"logits": logits} if status == "ok" else {"message": message}
    ours = encode_response(9, status=status, **kw)
    assert ours == jserving.encode_response(9, status=status, **kw)
    # and each package decodes the other's frame to the same message
    mine = decode_response(*read_frame(_reader(ours)))
    theirs = jserving.decode_response(*jserving.read_frame(_reader(ours)))
    assert mine[:3] == theirs[:3]
    if status == "ok":
        np.testing.assert_array_equal(mine[3], theirs[3])


@pytest.mark.parametrize("exc", ["Overloaded", "DeadlineExceeded",
                                 "CircuitOpen", "BadRequest", "RuntimeError"])
def test_typed_errors_map_to_the_references_statuses(exc):
    from repro.serving import protocol as jprotocol
    from repro_torch.serving import protocol

    ours = getattr(serving, exc, RuntimeError)("x")
    theirs = getattr(jserving, exc, RuntimeError)("x")
    status = protocol.status_for(ours)
    assert status == jprotocol.status_for(theirs)
    assert type(protocol.error_for(status, "m")).__name__ \
        == type(jprotocol.error_for(status, "m")).__name__


def test_reference_client_against_torch_endpoint_is_bitwise(endpoint, truth):
    """The JAX package's ``AsyncClient`` over a torch ``ServerEndpoint``:
    answers bitwise equal to the torch ``engine.run``, and a typed
    rejection re-raised as the reference's own type."""
    imgs, want = truth

    async def go():
        async with await jserving.AsyncClient.connect(
                *endpoint.address) as client:
            outs = await asyncio.wait_for(asyncio.gather(
                *(client.classify("resnet18", im) for im in imgs)), WAIT)
            with pytest.raises(jserving.BadRequest):
                await asyncio.wait_for(
                    client.classify("not-a-network", imgs[0]), WAIT)
            return outs

    outs = asyncio.run(go())
    for got, ref in zip(outs, want):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
