"""The port's ``EngineCache`` on the CPU (``device="cpu"``, tiny configs):
identical engines on a hit, LRU eviction, plan reuse across storage-only
variants, leases that pin an entry, and the device in the key (ported
from ``tests/test_serving.py`` and ``tests/test_streaming.py``)."""
import pytest
import torch

from repro_torch.configs import get, tiny_variant
from repro_torch.core import with_precision
from repro_torch.serving import EngineCache, Server, engine_key

RESNET = tiny_variant(get("resnet18"))
MOBILENET = tiny_variant(get("mobilenet_v2"))


def test_cache_hit_returns_identical_engine():
    cache = EngineCache(capacity=2, device="cpu")
    e1 = cache.get(RESNET)
    e2 = cache.get(RESNET)
    assert e2 is e1  # same graphs, same params, same plan
    assert (cache.hits, cache.misses) == (1, 1)
    assert e1.device == torch.device("cpu")


def test_cache_distinct_keys_miss():
    cache = EngineCache(capacity=4, device="cpu")
    e1 = cache.get(RESNET)
    e2 = cache.get(MOBILENET)
    assert e1 is not e2
    assert cache.misses == 2 and cache.hits == 0
    assert cache.key(RESNET) != cache.key(MOBILENET)
    assert len(cache) == 2


def test_cache_lru_evicts_beyond_capacity():
    cache = EngineCache(capacity=1, device="cpu")
    e1 = cache.get(RESNET)
    cache.get(MOBILENET)  # evicts the resnet engine
    assert cache.evictions == 1
    assert MOBILENET in cache and RESNET not in cache
    e3 = cache.get(RESNET)  # rebuilt: a fresh object...
    assert e3 is not e1
    assert e3.plan is e1.plan  # ...on the cached plan, not re-tuned


def test_cache_plan_reuse_across_dtype_variants():
    """(network, input_size, compute_dtype) keys the plan: a storage-only
    variant shares it, another compute dtype gets its own."""
    cache = EngineCache(capacity=4, device="cpu")
    e32 = cache.get(RESNET)
    e_store16 = cache.get(RESNET.replace(param_dtype="bfloat16"))
    assert e_store16 is not e32
    assert e_store16.plan is e32.plan
    e_bf16 = cache.get(with_precision(RESNET, "bfloat16"))
    assert e_bf16 is not e32 and e_bf16.plan is not e32.plan
    assert {s.dtype for s in e_bf16.plan.specs.values()} == {"bfloat16"}
    assert {s.dtype for s in e32.plan.specs.values()} == {"float32"}
    assert cache.misses == 3


def test_engine_key_names_the_device():
    assert engine_key(RESNET, "cpu") == (
        "resnet18-tiny", 32, "cpu", "float32", "float32")
    assert engine_key(RESNET, "cuda")[2] == "cuda"
    assert EngineCache(device="cpu").key(RESNET) == engine_key(RESNET, "cpu")


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (EngineCache, Server, lambda: engine_key(RESNET)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


def test_server_device_must_match_its_cache():
    cache = EngineCache(device="cpu")
    with Server(cache=cache, device="cpu") as server:
        assert server.engines is cache
    with pytest.raises(ValueError, match="differs"):
        Server(cache=cache, device="meta")


def test_lease_pins_entry_against_eviction():
    """A leased engine rides outside the capacity count: LRU pressure
    evicts around it, never through it; release rejoins LRU order as MRU."""
    cache = EngineCache(capacity=1, device="cpu")
    lease = cache.lease(RESNET)
    cache.get(MOBILENET)  # would evict the resnet engine without the pin
    assert RESNET in cache and MOBILENET in cache
    assert cache.evictions == 0
    assert cache.get(RESNET) is lease.engine
    bf16 = RESNET.replace(param_dtype="bfloat16")
    cache.get(bf16)  # second *unpinned* entry: evicts mobilenet, not resnet
    assert cache.evictions == 1
    assert MOBILENET not in cache and RESNET in cache and bf16 in cache
    assert cache.stats()["pinned"] == [cache.key(RESNET)]
    lease.release()
    assert cache.stats()["pinned"] == []
    assert RESNET in cache and bf16 not in cache  # bf16 was oldest
    cache.get(MOBILENET)
    assert RESNET not in cache
    assert lease.released


def test_lease_stacks_and_context_manager():
    cache = EngineCache(capacity=1, device="cpu")
    with cache.lease(RESNET) as l1:
        with cache.lease(RESNET) as l2:
            assert l2.engine is l1.engine
            assert cache.leases == 2
        assert cache.stats()["pinned"] == [cache.key(RESNET)]
    assert cache.stats()["pinned"] == []


def test_degrade_rebuilds_on_xla_with_the_stored_weights():
    cache = EngineCache(capacity=2, device="cpu")
    tuned = cache.get(RESNET)
    degraded = cache.degrade(RESNET)
    assert cache.get(RESNET) is degraded and degraded is not tuned
    assert set(degraded.plan.algorithms().values()) == {"xla"}
    assert all(torch.equal(a, b) for a, b in zip(
        tuned.model.state_dict().values(),
        degraded.model.state_dict().values()))
    st = cache.stats()
    assert st["degraded"] == 1
    assert st["degraded_keys"] == [list(cache.key(RESNET))]
