"""Port vector store vs the JAX store on the same texts, on the CPU.

Counterparts of ``tests/test_retrieval.py``: exact search equal to brute
force and to the JAX store (ids exactly, scores to 1e-4), the spill/load
round trip, a sweep that loads and releases spilled partitions with the
same ``SearchStats``, the hash embedder equal to the JAX one, and the
partition cache's target as a hard cap (a hypothesis property, run side
by side with the JAX ``PartitionCache``).  Nothing here is held by another
``test_torch_*`` file.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jax_ref
from repro.retrieval import HashEmbedder as JaxHashEmbedder
from repro.retrieval import PartitionCache as JaxPartitionCache
from repro.retrieval import SearchStats as JaxSearchStats
from repro.retrieval import VectorStore as JaxVectorStore

from repro_torch.retrieval import (HashEmbedder, PartitionCache, SearchStats,
                                   VectorStore)

TEXTS = [f"chunk {i} topic{i % 11} word{i % 7}" for i in range(300)]


@pytest.fixture
def stores(tmp_path):
    store = VectorStore.build(TEXTS, HashEmbedder(dim=48), num_partitions=6,
                              root=str(tmp_path / "torch"), device="cpu")
    jstore = JaxVectorStore.build(TEXTS, JaxHashEmbedder(dim=48),
                                  num_partitions=6,
                                  root=str(tmp_path / "jax"))
    return store, jstore, HashEmbedder(dim=48)


def test_search_equals_bruteforce_and_jax(stores):
    store, jstore, emb = stores
    q = emb.embed(["chunk 42 topic9", "topic3 word2"])
    s, ids = store.search(q, top_k=7)
    ws, wi = jax_ref.topk_reference(jnp.asarray(q),
                                    jnp.asarray(emb.embed(TEXTS)), 7)
    np.testing.assert_array_equal(ids, np.asarray(wi))
    np.testing.assert_allclose(s, np.asarray(ws), atol=1e-4)
    js, ji = jstore.search(q, top_k=7)
    np.testing.assert_array_equal(ids, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-4)


def test_spill_load_roundtrip(stores):
    store, _, _ = stores
    before = store.partitions[3].embeddings.copy()
    store.spill(3)
    assert not store.partitions[3].resident
    assert os.path.exists(store.partitions[3].path)
    assert store.load(3) >= 0
    np.testing.assert_array_equal(store.partitions[3].embeddings, before)


def test_search_loads_and_releases_spilled_as_jax(stores):
    store, jstore, emb = stores
    for pid in range(3, 6):
        store.spill(pid)
        jstore.spill(pid)
    q = emb.embed(["whatever"])
    stats, jstats = SearchStats(), JaxSearchStats()
    s, i = store.search(q, top_k=3, stats=stats)
    js, ji = jstore.search(q, top_k=3, stats=jstats)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-4)
    assert stats.partitions_loaded == jstats.partitions_loaded == 3
    assert stats.partitions_searched == jstats.partitions_searched == 6
    assert sorted(store.resident_set()) == sorted(jstore.resident_set()) \
        == [0, 1, 2]


def test_embedder_deterministic_similar_and_equal_to_jax():
    emb, jemb = HashEmbedder(dim=64), JaxHashEmbedder(dim=64)
    a1 = emb.embed_one("the cat sat on the mat")
    np.testing.assert_array_equal(a1, emb.embed_one("the cat sat on the mat"))
    np.testing.assert_array_equal(a1, jemb.embed_one("the cat sat on the mat"))
    b = emb.embed_one("completely unrelated text about protons")
    assert a1 @ emb.embed_one("the cat sat on a mat") > a1 @ b


@settings(max_examples=15, deadline=None)
@given(target=st.integers(0, 6),
       touches=st.lists(st.integers(0, 5), max_size=20))
def test_partition_cache_respects_target_as_jax(tmp_path_factory, target,
                                                touches):
    root = tmp_path_factory.mktemp("cache")
    texts = [f"t{i}" for i in range(60)]
    store = VectorStore.build(texts, HashEmbedder(dim=16), num_partitions=6,
                              root=str(root / "torch"), device="cpu")
    jstore = JaxVectorStore.build(texts, JaxHashEmbedder(dim=16),
                                  num_partitions=6, root=str(root / "jax"))
    cache = PartitionCache(store, target=target)
    jcache = JaxPartitionCache(jstore, target=target)
    for pid in touches:
        cache.touch(pid)
        jcache.touch(pid)
        assert len(cache.resident()) <= target
        assert cache.resident() == jcache.resident()
        assert sorted(store.resident_set()) == sorted(jstore.resident_set())
    cache.set_target(0)
    assert cache.resident() == []
