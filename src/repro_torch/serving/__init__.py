"""Serving subsystem — the request loop above ``InferenceEngine``
(``repro/serving``).

``Server`` accepts single-image requests for many networks out of one
process; ``MicroBatcher`` coalesces concurrent requests into one
padded-batch dispatch with mid-flight admission (batch-1 traffic keeps
the paper's single-image path, ``engine.run``); a shared
``DeviceScheduler`` interleaves every network's dispatches onto the card
oldest-deadline-first. ``EngineCache`` LRU-caches built engines keyed by
(network, input_size, device, dtype, param_dtype) and reuses tuned plans
across variants; ``StreamSession`` (``Server.open_stream``) serves
fixed-rate frame streams over per-stream engine leases. On the card every
engine replays CUDA graphs, so a padded batch is bitwise equal to the
same images through ``engine.run``.

Public API: frozen ``ServingOptions`` (server-wide) and ``RequestOptions``
(per call); every submit path returns a ``Ticket``; the typed rejections
(``Rejected`` > ``Overloaded`` / ``DeadlineExceeded`` / ``CircuitOpen``)
and ``TransientFailure`` are exported here.

The wire tier puts a socket in front of the same surface:
``ServerEndpoint`` speaks a length-prefixed binary framing
(``protocol.py``, byte for byte the JAX package's), ``AsyncClient`` is
the asyncio caller — ``await client.classify(net, image)`` returns
logits bitwise equal to ``engine.run``, and typed rejections
(``ProtocolError`` / ``BadRequest`` / ``RemoteError`` besides the
resilience layer's) re-raise client-side.
"""
from repro_torch.serving.batcher import MicroBatcher, bucket  # noqa: F401
from repro_torch.serving.client import AsyncClient  # noqa: F401
from repro_torch.serving.engine_cache import (  # noqa: F401
    EngineCache,
    EngineLease,
    engine_key,
    plan_key,
    xla_fallback_plan,
)
from repro_torch.serving.faults import Fault, FaultInjector  # noqa: F401
from repro_torch.serving.protocol import (  # noqa: F401
    MAX_FRAME_BYTES,
    PROTOCOL_VERSION,
    BadRequest,
    ProtocolError,
    RemoteError,
    ServerEndpoint,
    decode_request,
    decode_response,
    encode_request,
    encode_response,
    pack_frame,
    read_frame,
    unpack_body,
)
from repro_torch.serving.request import (  # noqa: F401
    Request,
    RequestOptions,
    Ticket,
)
from repro_torch.serving.resilience import (  # noqa: F401
    CircuitBreaker,
    CircuitOpen,
    DeadlineExceeded,
    Overloaded,
    Rejected,
    RetryPolicy,
    TransientFailure,
)
from repro_torch.serving.scheduler import DeviceScheduler  # noqa: F401
from repro_torch.serving.server import Server, ServingOptions  # noqa: F401
from repro_torch.serving.streaming import (  # noqa: F401
    Frame,
    FrameDropped,
    StreamScheduler,
    StreamSession,
)

__all__ = [
    "AsyncClient",
    "BadRequest",
    "CircuitBreaker",
    "CircuitOpen",
    "DeadlineExceeded",
    "DeviceScheduler",
    "EngineCache",
    "EngineLease",
    "Fault",
    "FaultInjector",
    "Frame",
    "FrameDropped",
    "MAX_FRAME_BYTES",
    "MicroBatcher",
    "Overloaded",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "Rejected",
    "RemoteError",
    "Request",
    "RequestOptions",
    "RetryPolicy",
    "Server",
    "ServerEndpoint",
    "ServingOptions",
    "StreamScheduler",
    "StreamSession",
    "Ticket",
    "TransientFailure",
    "bucket",
    "decode_request",
    "decode_response",
    "encode_request",
    "encode_response",
    "engine_key",
    "pack_frame",
    "plan_key",
    "read_frame",
    "unpack_body",
    "xla_fallback_plan",
]
