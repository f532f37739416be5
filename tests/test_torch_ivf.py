"""Port IVF retrieval vs the JAX store on the same corpus, on the CPU.

Counterparts of ``tests/test_ivf.py``, each case run side by side with
the JAX ``VectorStore`` on ``blob_corpus(1200, 32)`` in 8 k-means
partitions: the partitions and centroids equal, searches give the same
ids exactly and scores to 1e-4 (exact, pruned, streamed, under tight
budgets, beyond the candidates), the same ``SearchStats``, and the same
streamer depths.  Then ``recluster``, the hash partitioner and
``resident_bytes``: after a recluster the two stores still agree, no
spill file of the old layout survives or is read, the streamer's size
estimate and the hot set's device copies of the old layout are dropped,
and the host partition cache behaves as the reference's.

Left out, because another file holds them already: the masked merge and
its sentinels (``test_torch_kernels.py``), the probe and search at each
probe width with and without a streamer and a hot set
(``test_torch_policy.py::test_ivf_probe_matches_jax_store``), and nprobe
as a placement dimension (``test_torch_placement.py``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core.prefetch import PrefetchPolicy as JaxPolicy
from repro.kernels import ref as jax_ref
from repro.retrieval import PartitionCache as JaxPartitionCache
from repro.retrieval import PartitionStreamer as JaxStreamer
from repro.retrieval import SearchStats as JaxSearchStats
from repro.retrieval import VectorStore as JaxVectorStore
from repro.retrieval.cache import HotPartitionSet as JaxHotPartitionSet
from repro.retrieval.synthetic import ArrayEmbedder as JaxArrayEmbedder
from repro.retrieval.vectorstore import kmeans_centroids as jax_kmeans

from repro_torch.core.prefetch import PrefetchPolicy
from repro_torch.kernels import ops
from repro_torch.retrieval import (HotPartitionSet, PartitionCache,
                                   PartitionStreamer, SearchStats,
                                   VectorStore)
from repro_torch.retrieval.synthetic import ArrayEmbedder, blob_corpus
from repro_torch.retrieval.vectorstore import kmeans_centroids

N, DIM, PARTS = 1200, 32, 8
SCORE_TOL = 1e-4


def _build(vecs, root, partitioner="kmeans", parts=PARTS, seed=3):
    texts = [str(i) for i in range(len(vecs))]
    store = VectorStore.build(texts, ArrayEmbedder(vecs), num_partitions=parts,
                              root=str(root / "torch"),
                              partitioner=partitioner, seed=seed, device="cpu")
    jstore = JaxVectorStore.build(texts, JaxArrayEmbedder(vecs),
                                  num_partitions=parts, root=str(root / "jax"),
                                  partitioner=partitioner, seed=seed)
    return store, jstore


@pytest.fixture
def stores(tmp_path):
    vecs = blob_corpus(n=N, dim=DIM, clusters=8, seed=3)
    store, jstore = _build(vecs, tmp_path)
    return store, jstore, vecs


def _same_layout(store, jstore):
    assert store.num_partitions == jstore.num_partitions
    assert store.layout_version == jstore.layout_version
    np.testing.assert_array_equal(store.centroids, jstore.centroids)
    for pid in range(store.num_partitions):
        np.testing.assert_array_equal(store.partitions[pid].doc_ids,
                                      jstore.partitions[pid].doc_ids)


def _same_search(store, jstore, q, k, jkw=None, **kw):
    """Both stores' search on ``q``; ``jkw`` replaces ``kw`` on the JAX
    side (its own streamer)."""
    stats, jstats = SearchStats(), JaxSearchStats()
    jkw = dict(kw) if jkw is None else jkw
    s, i = store.search(q, k, stats=stats, **kw)
    js, ji = jstore.search(q, k, stats=jstats, **jkw)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), atol=SCORE_TOL, rtol=0)
    for name in ("partitions_searched", "partitions_loaded",
                 "partitions_pruned"):
        assert getattr(stats, name) == getattr(jstats, name), name
    return s, i, stats


def _spill_all(*stores):
    for st in stores:
        for pid in range(st.num_partitions):
            st.spill(pid)


def _queries(vecs, rows, noise=0.0, seed=7):
    rng = np.random.default_rng(seed)
    q = vecs[rows] + (noise / np.sqrt(DIM)) * rng.normal(
        size=(len(rows), DIM))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- clustering
def test_kmeans_partitions_cover_corpus_and_match_jax(stores):
    store, jstore, vecs = stores
    _same_layout(store, jstore)
    all_ids = np.concatenate([store.partitions[p].doc_ids
                              for p in range(store.num_partitions)])
    assert sorted(all_ids) == list(range(len(vecs)))
    assert all(len(store.partitions[p].doc_ids) > 0
               for p in range(store.num_partitions))
    np.testing.assert_allclose(np.linalg.norm(store.centroids, axis=1),
                               1.0, atol=1e-5)


def test_kmeans_reseeds_empty_clusters_as_jax():
    vecs = blob_corpus(n=64, dim=16, clusters=2, seed=0)
    cent, assign = kmeans_centroids(vecs, k=8, iters=5, seed=0)
    jcent, jassign = jax_kmeans(vecs, k=8, iters=5, seed=0)
    np.testing.assert_array_equal(cent, jcent)
    np.testing.assert_array_equal(assign, jassign)
    assert set(range(8)) == set(np.unique(assign))


# ------------------------------------------------------------------ search
def test_probe_is_per_query_as_jax(stores):
    store, jstore, vecs = stores
    q = vecs[[0, 500, 900]]
    pids, qmask = store.probe(q, nprobe=2)
    jpids, jqmask = jstore.probe(q, nprobe=2)
    assert list(pids) == list(jpids)
    np.testing.assert_array_equal(qmask, jqmask)
    assert (qmask.sum(axis=1) == 2).all()
    assert set(pids) == set(np.nonzero(qmask.any(axis=0))[0])


def test_pruned_search_recall_and_loads_as_jax(stores):
    store, jstore, vecs = stores
    q = _queries(vecs, np.random.default_rng(7).integers(0, N, size=6),
                 noise=0.2)
    _, exact, _ = _same_search(store, jstore, q, 10)
    _, pruned, stats = _same_search(store, jstore, q, 10, nprobe=2)
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(pruned, exact)])
    assert recall >= 0.9, recall
    assert stats.partitions_pruned > 0
    _spill_all(store, jstore)
    _, _, stats = _same_search(store, jstore, vecs[[17]], 5)
    assert stats.partitions_loaded == PARTS
    _, _, stats = _same_search(store, jstore, vecs[[17]], 5, nprobe=2)
    assert stats.partitions_loaded == stats.partitions_searched == 2


def test_exact_search_equals_brute_force(stores):
    store, _, vecs = stores
    q = vecs[[3, 77]]
    s, ids = store.search(q, top_k=9)
    ws, wi = jax_ref.topk_reference(jnp.asarray(q), jnp.asarray(vecs), 9)
    np.testing.assert_array_equal(ids, np.asarray(wi))
    np.testing.assert_allclose(s, np.asarray(ws), atol=SCORE_TOL)


def test_topk_beyond_candidates_returns_sentinels_as_jax(tmp_path):
    vecs = blob_corpus(n=12, dim=16, clusters=4, seed=0)
    store, jstore = _build(vecs, tmp_path, parts=4, seed=0)
    q = vecs[[5]]
    _, qmask = store.probe(q, nprobe=1)
    candidates = sum(len(store.partitions[p].doc_ids)
                     for p in np.nonzero(qmask[0])[0])
    assert candidates < 10
    scores, ids, _ = _same_search(store, jstore, q, 10, nprobe=1)
    real = ids[0] >= 0
    assert real.sum() == candidates
    assert (ids[0][~real] == -1).all()
    assert (scores[0][~real] == np.float32(-1e30)).all()
    assert len(store.get_chunks(ids)[0]) == candidates


# ---------------------------------------------------------------- streamer
def test_streamer_results_identical_to_sync_and_jax(stores):
    store, jstore, vecs = stores
    _spill_all(store, jstore)
    q = vecs[[10, 400, 800]]
    for nprobe in (None, 3):
        s_sync, i_sync = store.search(q, 8, nprobe=nprobe)
        streamer = PartitionStreamer(store)
        jstreamer = JaxStreamer(jstore)
        try:
            s, i, stats = _same_search(
                store, jstore, q, 8, nprobe=nprobe, streamer=streamer,
                jkw=dict(nprobe=nprobe, streamer=jstreamer))
        finally:
            streamer.close()
            jstreamer.close()
        np.testing.assert_array_equal(i_sync, i)
        np.testing.assert_allclose(s_sync, s)
        assert stats.partitions_loaded > 0
        assert stats.prefetched == stats.partitions_loaded - 1
        assert store.resident_set() == []


def test_streamer_depth_follows_budget_as_jax(stores):
    store, jstore, _ = stores
    part = store.partition_bytes()
    assert part == jstore.partition_bytes()
    for free in (part * 1.5, part * 3.0, float("inf")):
        s = PartitionStreamer(store, PrefetchPolicy(max_depth=8),
                              free_bytes=free)
        js = JaxStreamer(jstore, JaxPolicy(max_depth=8), free_bytes=free)
        assert s.depth() == js.depth()
        s.close()
        js.close()
    _spill_all(store)
    streamer = PartitionStreamer(store, PrefetchPolicy(max_depth=8))
    it = streamer.stream(list(range(PARTS)))
    pid, loaded = next(it)
    assert streamer.last_depth == 8
    streamer.set_budget(part * 1.5)          # shrinks within the sweep
    if loaded:
        store.release(pid)
    pid, loaded = next(it)
    assert streamer.last_depth == 1
    for pid, loaded in [(pid, loaded)] + list(it):
        if loaded:
            store.release(pid)
    streamer.close()
    assert store.resident_set() == []


def test_streamer_tight_budget_sweep_matches_jax(stores):
    store, jstore, vecs = stores
    _spill_all(store, jstore)
    q = vecs[[5, 250, 990]]
    part = store.partition_bytes()
    streamer = PartitionStreamer(store, PrefetchPolicy(max_depth=8),
                                 free_bytes=part * 1.5)
    jstreamer = JaxStreamer(jstore, JaxPolicy(max_depth=8),
                            free_bytes=part * 1.5)
    try:
        stats = SearchStats()
        s, i = store.search(q, 8, nprobe=3, streamer=streamer, stats=stats)
        js, ji = jstore.search(q, 8, nprobe=3, streamer=jstreamer)
    finally:
        streamer.close()
        jstreamer.close()
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), atol=SCORE_TOL)
    assert streamer.last_depth == jstreamer.last_depth == 1
    assert stats.prefetched == stats.partitions_loaded - 1
    assert store.resident_set() == []


def test_streamer_overlapped_load_charges_nothing(stores):
    store, _, _ = stores
    _spill_all(store)
    streamer = PartitionStreamer(store)
    stats = SearchStats()
    it = streamer.stream([0, 1], stats=stats)
    assert next(it) == (0, True)
    store.load(1)                  # a concurrent load wins the race
    assert next(it) == (1, False)
    assert list(it) == []
    streamer.close()
    assert stats.partitions_loaded == 1 and stats.prefetched == 0
    store.release(0)
    store.release(1)
    assert store.resident_set() == []


def test_closed_streamer_degrades_to_sync(stores):
    store, _, vecs = stores
    _spill_all(store)
    q = vecs[[42]]
    s_sync, i_sync = store.search(q, 6)
    streamer = PartitionStreamer(store)
    streamer.close()
    s, i = store.search(q, 6, streamer=streamer)
    np.testing.assert_array_equal(i_sync, i)
    np.testing.assert_allclose(s_sync, s)
    assert store.resident_set() == []


def test_cache_target_zero_holds_nothing_and_records_stats(stores):
    store, _, _ = stores
    _spill_all(store)
    cache = PartitionCache(store, target=0)
    stats = SearchStats()
    cache.touch(2, stats=stats)
    assert (stats.cache_misses, stats.cache_hits) == (1, 0)
    assert cache.resident() == [] and store.resident_set() == []
    cache.set_target(2)
    cache.touch(2, stats=stats)
    cache.touch(2, stats=stats)
    assert (stats.cache_hits, stats.cache_misses) == (1, 2)
    assert cache.resident() == [2]
    cache.set_target(0)
    assert store.resident_set() == []


def test_aborted_sweep_releases_loaded_partitions(stores, monkeypatch):
    store, _, vecs = stores
    _spill_all(store)
    real = ops.retrieval_topk
    calls = {"n": 0}

    def explode_on_third(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("injected kernel failure")
        return real(*a, **kw)

    monkeypatch.setattr(ops, "retrieval_topk", explode_on_third)
    with pytest.raises(RuntimeError):
        store.search(vecs[[10]], 5, nprobe=6)
    assert store.resident_set() == []
    calls["n"] = 0
    streamer = PartitionStreamer(store)
    with pytest.raises(RuntimeError):
        store.search(vecs[[10]], 5, nprobe=6, streamer=streamer)
    streamer.close()
    assert store.resident_set() == []


# --------------------------------------------------------------- recluster
def test_streamer_part_bytes_cache_invalidated_on_recluster(stores):
    """``test_ivf.py:389``: a recluster to bigger partitions re-derives the
    streamer's size estimate."""
    store, jstore, _ = stores
    streamer = PartitionStreamer(store, PrefetchPolicy(max_depth=8),
                                 free_bytes=3.0 * store.partition_bytes())
    depth = streamer.depth()
    before = streamer._part_bytes
    assert before == store.partition_bytes()
    store.recluster(num_partitions=2)
    jstore.recluster(num_partitions=2)
    assert streamer.depth() < depth
    assert streamer._part_bytes == store.partition_bytes() != before
    streamer.close()
    _same_layout(store, jstore)


def test_recluster_spill_never_reuses_stale_files(stores):
    """``test_ivf.py:406``: the old layout's spill files are removed, a
    spill writes the new layout's, and the recluster equals the JAX one's
    (partitions, centroids, searches)."""
    store, jstore, vecs = stores
    for st in (store, jstore):
        for pid in range(PARTS):
            st.spill(pid)
            st.load(pid)
        for pid in range(2):          # two stay spilled through the pass
            st.spill(pid)
    old = [store.partitions[pid].path for pid in range(PARTS)]
    assert all(os.path.exists(p) for p in old)
    store.recluster(num_partitions=4, seed=9)
    jstore.recluster(num_partitions=4, seed=9)
    assert store.num_partitions == 4
    assert not any(os.path.exists(p) for p in old)
    _same_layout(store, jstore)
    want = {pid: store.partitions[pid].embeddings.copy() for pid in range(4)}
    for pid in range(4):
        assert store.partitions[pid].path is None
        store.spill(pid)
        assert store.partitions[pid].path not in old
        store.load(pid)
        np.testing.assert_array_equal(store.partitions[pid].embeddings,
                                      want[pid])
    q = _queries(vecs, [3, 700, 1100], noise=0.2)
    for nprobe in (None, 1, 2):
        _same_search(store, jstore, q, 9, nprobe=nprobe)
    s, ids = store.search(vecs[[3, 700]], top_k=9)
    ws, wi = jax_ref.topk_reference(jnp.asarray(vecs[[3, 700]]),
                                    jnp.asarray(vecs), 9)
    np.testing.assert_array_equal(ids, np.asarray(wi))


def test_recluster_drops_device_copies_of_the_old_layout(stores):
    """The hot set's device partitions are keyed by the layout: after a
    recluster none survives, and a promotion under the new layout is
    bit-equal to a cold sweep; the host partition cache follows the
    reference's through the recluster."""
    store, jstore, vecs = stores
    hot, jhot = HotPartitionSet(store, device="cpu"), JaxHotPartitionSet(
        jstore)
    grant = store.partitions[0].nbytes + store.partitions[3].nbytes
    hot.retarget(grant, [3, 0])
    jhot.retarget(grant, [3, 0])
    assert hot.pids() == jhot.pids() == [0, 3]
    cache = PartitionCache(store, target=2)
    jcache = JaxPartitionCache(jstore, target=2)
    for pid in (5, 6):
        store.spill(pid)
        jstore.spill(pid)
        cache.touch(pid)
        jcache.touch(pid)
    store.recluster(num_partitions=PARTS, seed=1)
    jstore.recluster(num_partitions=PARTS, seed=1)
    assert hot.pids() == jhot.pids() == []
    assert len(hot) == 0 and hot.device_bytes() == 0
    assert hot.lookup(0) is None
    assert hot.demotions == 2
    for c in (cache, jcache):
        c.set_target(1)
        c.touch(4)
    assert cache.resident() == jcache.resident()
    assert store.resident_set() == jstore.resident_set()
    q = _queries(vecs, [1, 600], noise=0.2)
    cold = _same_search(store, jstore, q, 5)
    hot.retarget(store.partitions[2].nbytes, [2])
    s, i = store.search(q, 5, hot=hot)
    np.testing.assert_array_equal(i, cold[1])
    np.testing.assert_array_equal(s, cold[0])


# ------------------------------------------------- hash partitioner, bytes
def test_hash_partitioner_matches_jax(tmp_path):
    vecs = blob_corpus(n=N, dim=DIM, clusters=8, seed=3)
    store, jstore = _build(vecs, tmp_path, partitioner="hash")
    assert store.num_partitions == PARTS
    for pid in range(PARTS):
        np.testing.assert_array_equal(store.partitions[pid].doc_ids,
                                      np.arange(pid, N, PARTS))
    np.testing.assert_allclose(store.centroids, jstore.centroids, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(store.centroids, axis=1), 1.0,
                               atol=1e-5)
    store.spill(1)
    jstore.spill(1)
    q = _queries(vecs, [2, 333, 999], noise=0.2)
    for nprobe in (None, 4):
        _same_search(store, jstore, q, 7, nprobe=nprobe)


def test_unknown_partitioner_raises(tmp_path):
    vecs = blob_corpus(n=40, dim=8, clusters=2, seed=0)
    with pytest.raises(ValueError, match="partitioner"):
        VectorStore.build([str(i) for i in range(40)], ArrayEmbedder(vecs),
                          num_partitions=2, partitioner="ring",
                          device="cpu")


def test_resident_bytes_counts_resident_partitions(stores):
    store, jstore, _ = stores
    full = sum(p.embeddings.nbytes for p in store.partitions.values())
    assert store.resident_bytes() == jstore.resident_bytes() == full
    for pid in (1, 4, 6):
        store.spill(pid)
        jstore.spill(pid)
    want = sum(store.partitions[p].nbytes for p in store.resident_set())
    assert store.resident_bytes() == jstore.resident_bytes() == want
    assert store.resident_bytes() == full - sum(
        store.partitions[p].nbytes for p in (1, 4, 6))
    store.load(4)
    assert store.resident_bytes() == want + store.partitions[4].nbytes
