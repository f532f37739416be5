"""The port's collectives: gloo process groups of 2 and 4 ranks on the CPU,
and (``cuda`` marker, on a host with 4 cards) an NCCL group of 4 ranks, a
card each.

Each world size is one spawn: ``world`` fresh Python processes, each with
its rank, a free TCP port on 127.0.0.1 and a time limit of 120 s (past it
every child is killed, so the suite cannot hang).  Each rank runs the
same program on the same seeded numpy inputs and saves what it got; the
tests below hold every rank's answer against the port's local paths and
plain versions, and against the JAX package's
(``kernels/ref.topk_reference`` over the whole database, the reference
``ShardedIVFStore``) wherever JAX is installed.  The JAX side runs on its
CPU device whatever JAX's default platform is: on a GPU its fp32 products
run in TF32.

* ``distributed_topk``, each rank holding only its own row shard, on an
  even corpus, an uneven one with negative scores, one with ``k`` above
  the local (and global) rows and one of 3 rows (on 4 ranks the last
  holds none): ids exact, scores within 1e-4, ``(NEG_INF, -1)``
  sentinels for missing rows;
* ``sharded_topk_merge`` of 4 shards' boards equal to the local merge;
* ``ShardedIVFStore(ctx=...)`` (each rank sweeps its own shard, the boards
  all-gathered) equal to the rank's own single-host search bit for bit,
  in RAM and spilled;
* with 4 ranks, the batch group of a ``(data, model)`` mesh (2 of the 4
  ranks) and of a ``(pod, data)`` mesh (both axes, one group);
* on 4 cards, the all-gather of the S = 4 engine's ``(Q, k)`` boards
  timed with CUDA events beside the cost model's price.
"""
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.retrieval.synthetic import blob_corpus, perturb_queries

SRC = Path(__file__).resolve().parent.parent / "src"
LIMIT_S = 120.0
NEG_INF = -1e30

CHILD = textwrap.dedent("""
    import sys
    import time
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, out, device = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.retrieval.distributed import (
        ShardedIVFStore, _all_gather, distributed_topk, row_shard,
        sharded_topk_merge)
    from repro_torch.retrieval.synthetic import (ArrayEmbedder, blob_corpus,
                                                 perturb_queries)
    from repro_torch.retrieval.vectorstore import VectorStore
    from repro_torch.sharding import from_mesh

    res = {}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device)
    host = lambda pair: tuple(x.cpu().numpy() for x in pair)

    def dtopk(q, db, k, c):
        lo, hi = row_shard(db.shape[0], c)
        return host(distributed_topk(t(q), t(db[lo:hi]), k, c, db.shape[0]))

    r = np.random.default_rng(0)
    cases = {
        "even": (r.normal(size=(8, 32)), r.normal(size=(1024, 32)), 5),
        "uneven": (np.abs(r.normal(size=(8, 32))),
                   -np.abs(r.normal(size=(1021, 32))), 7),
        "tiny": (np.abs(r.normal(size=(8, 32))),
                 -np.abs(r.normal(size=(10, 32))), 12),
        "three": (np.abs(r.normal(size=(8, 32))),
                  -np.abs(r.normal(size=(3, 32))), 5),
    }
    ctx = from_mesh(make_mesh((world,), ("data",), device_type=device))
    res["dp_size"], res["batch_rank"] = ctx.dp_size, ctx.batch_rank
    for name, (q, db, k) in cases.items():
        res[name] = (q, db, k) + dtopk(q, db, k, ctx)
    # 4 shards' boards, score-sorted, some short of k
    bs = np.sort(r.normal(size=(6, 4, 5)), axis=-1)[..., ::-1].copy()
    bi = r.integers(0, 10_000, size=(6, 4, 5)).astype(np.int32)
    bs[2, 1, 3:], bi[2, 1, 3:] = -1e30, -1
    res["merge"] = (bs.astype(np.float32), bi) + host(sharded_topk_merge(
        t(bs), torch.from_numpy(bi).to(device), 5, ctx))
    vecs = blob_corpus(n=900, dim=24, clusters=8, seed=1)
    qs = perturb_queries(vecs, 6, seed=2)
    store = VectorStore.build([str(j) for j in range(900)],
                              ArrayEmbedder(vecs), num_partitions=8, seed=1,
                              root=f"{out}/store{rank}", device=device)
    for spill in (False, True):
        if spill:
            for pid in range(store.num_partitions):
                store.spill(pid)
        for nprobe in (None, 2):
            res["ivf_single", spill, nprobe] = store.search(qs, 9,
                                                            nprobe=nprobe)
            sharded = ShardedIVFStore(store, world, ctx=ctx,
                                      use_streamers=spill)
            assert sharded.gathers
            s, i = sharded.search(qs, 9, nprobe=nprobe)
            sharded.close()
            res["ivf", spill, nprobe] = (s, i)
    res["ivf_queries"] = qs
    if world == 4:
        q, db, k = cases["even"][:3]
        for shape, axes in (((2, 2), ("data", "model")),
                            ((2, 2), ("pod", "data"))):
            c = from_mesh(make_mesh(shape, axes, device_type=device))
            res["mesh", axes] = (c.batch_axes, c.dp_size, c.batch_rank,
                                 dist.get_world_size(c.batch_group)) \
                + dtopk(q, db, k, c)
    if device == "cuda":
        # the S = 4 engine's all-gather: a (1, 2, Q, k) int32 board a rank
        pair = torch.zeros((1, 2, 8, 5), dtype=torch.int32, device=device)
        gathered = torch.empty((world,) + tuple(pair.shape[1:]),
                               dtype=torch.int32, device=device)
        group = ctx.batch_group
        for _ in range(5):
            _all_gather(gathered, pair, group)
        torch.cuda.synchronize()
        dist.barrier()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            _all_gather(gathered, pair, group)
        end.record()
        end.synchronize()
        res["allgather_ms"] = (start.elapsed_time(end) / 20,
                               (time.perf_counter() - t0) * 1e3 / 20,
                               pair.numel() * 4 * world)
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, device: str, out: Path):
    """Run ``CHILD`` on ``world`` ranks (gloo on the CPU, or NCCL with a
    card each); kill them all past ``LIMIT_S``.  Returns each rank's saved
    results."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(world), port, str(out),
         device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + LIMIT_S
    logs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{world} ranks ({device}) still running after "
                    f"{LIMIT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


_RUNS = {}
CARDS = pytest.mark.cuda


def _results(device, world, tmp_path_factory):
    """One spawn per device and world size for the whole module; NCCL
    needs a card a rank."""
    if device == "cuda" and torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA GPUs (run on the cards)")
    if (device, world) not in _RUNS:
        _RUNS[device, world] = _spawn(
            world, device, tmp_path_factory.mktemp(f"{device}{world}"))
    return world, _RUNS[device, world]


@pytest.fixture(params=[("cpu", 2), ("cpu", 4),
                        pytest.param(("cuda", 4), marks=CARDS)],
                ids=["2ranks", "4ranks", "4cards"])
def ranks(request, tmp_path_factory):
    return _results(*request.param, tmp_path_factory) + (request.param[0],)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=CARDS)],
                ids=["gloo", "nccl"])
def four_ranks(request, tmp_path_factory):
    return _results(request.param, 4, tmp_path_factory) + (request.param,)


def _jax(device):
    """The JAX package's modules the tests compare with.  The gloo runs
    always have them; on a cards' machine without JAX the ranks are held
    to the port's plain versions alone (None)."""
    try:
        import jax.numpy as jnp
    except ImportError:
        if device == "cpu":
            raise
        return None
    from repro.kernels import ref
    from repro.retrieval import distributed
    from repro.retrieval.synthetic import ArrayEmbedder
    from repro.retrieval.vectorstore import VectorStore
    import jax
    return dict(jnp=jnp, ref=ref, distributed=distributed,
                ArrayEmbedder=ArrayEmbedder, VectorStore=VectorStore,
                on_cpu=lambda: jax.default_device(jax.devices("cpu")[0]))


def _topk_refs(device, q, db, k):
    """(scores, ids) of one top-k over the whole database: the port's
    plain version, and JAX's ``kernels/ref.topk_reference`` where JAX is
    installed (its ``top_k`` takes no k above the rows: there the first
    ``min(k, N)`` columns)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    s, i = ops.retrieval_topk(t(q), t(db), k, impl="ref")
    refs = [(s.numpy(), i.numpy())]
    jax = _jax(device)
    if jax is not None:
        jnp = jax["jnp"]
        n = min(k, db.shape[0])
        with jax["on_cpu"]():
            js, ji = jax["ref"].topk_reference(
                jnp.asarray(q, jnp.float32), jnp.asarray(db, jnp.float32), n)
        refs.append((np.asarray(js), np.asarray(ji)))
    return refs


def _assert_topk(s, i, refs):
    for ws, wi in refs:
        n = wi.shape[1]
        np.testing.assert_array_equal(i[:, :n], wi)
        np.testing.assert_allclose(s[:, :n], ws, atol=1e-4, rtol=0)


def test_mesh_context_ranks(ranks):
    world, res, _ = ranks
    assert [r["dp_size"] for r in res] == [world] * world
    assert [r["batch_rank"] for r in res] == list(range(world))


@pytest.mark.parametrize("case", ["even", "uneven", "three"])
def test_distributed_topk_matches_jax_reference(ranks, case):
    world, res, device = ranks
    q, db, k, _, _ = res[0][case]
    refs = _topk_refs(device, q, db, k)
    for r in res:
        _, _, _, s, i = r[case]
        _assert_topk(s, i, refs)
        assert (i < db.shape[0]).all()
    # every rank holds the same answer, bit for bit
    for r in res[1:]:
        assert np.array_equal(r[case][3].view(np.int32),
                              res[0][case][3].view(np.int32))


def test_distributed_topk_tiny_corpus_sentinels(ranks):
    """k = 12 above the 10 rows (and above every rank's local rows): the
    tail is ``(NEG_INF, -1)``, never a local -1 aliased into a global id
    or a padded row."""
    world, res, device = ranks
    q, db, k, _, _ = res[0]["tiny"]
    refs = _topk_refs(device, q, db, k)
    for r in res:
        s, i = r["tiny"][3:]
        assert s.shape == i.shape == (q.shape[0], k)
        _assert_topk(s, i, refs)
        for row_s, row_i in zip(s, i):
            real = row_i >= 0
            assert sorted(row_i[real]) == list(range(10)), row_i
            assert (row_i[~real] == -1).all() and (row_s[~real] == NEG_INF).all()


def test_sharded_topk_merge_equals_local_merge(ranks):
    world, res, device = ranks
    bs, bi = res[0]["merge"][:2]
    s, i = torch.from_numpy(bs), torch.from_numpy(bi)
    want_s, want_i = ops.retrieval_topk_merge(
        s, i, torch.ones(s.shape[:2], dtype=torch.bool), 5)
    jax = _jax(device)
    for r in res:
        got_s, got_i = r["merge"][2:]
        assert np.array_equal(got_i, want_i.numpy())
        assert np.array_equal(got_s.view(np.int32),
                              want_s.numpy().view(np.int32))
        if jax is not None:
            # the JAX merge over the same boards: a top-k over the
            # shard-major flattening, as the reference's ends
            jnp = jax["jnp"]
            with jax["on_cpu"]():
                _, ji = jax["ref"].topk_merge_reference(
                    jnp.asarray(bs), jnp.asarray(bi),
                    jnp.ones(bs.shape[:2], bool), 5)
            np.testing.assert_array_equal(got_i, np.asarray(ji))


@pytest.mark.parametrize("nprobe", [None, 2], ids=["exact", "nprobe2"])
@pytest.mark.parametrize("spill", [False, True], ids=["ram", "disk"])
def test_sharded_ivf_store_gathers_to_single_host(ranks, spill, nprobe):
    """Every rank's gathered answer equals its own single-host search bit
    for bit, and the JAX ``ShardedIVFStore``'s (ids exact, scores to
    1e-4)."""
    world, res, device = ranks
    vecs = blob_corpus(n=900, dim=24, clusters=8, seed=1)
    q = res[0]["ivf_queries"]
    assert np.array_equal(q, perturb_queries(vecs, 6, seed=2))
    jax = _jax(device)
    if jax is not None:
        with jax["on_cpu"]():
            jstore = jax["VectorStore"].build(
                [str(j) for j in range(900)], jax["ArrayEmbedder"](vecs),
                num_partitions=8, seed=1)
            js, ji = jax["distributed"].ShardedIVFStore(
                jstore, world, use_streamers=False).search(q, 9,
                                                           nprobe=nprobe)
    for r in res:
        s, i = r["ivf", spill, nprobe]
        s1, i1 = r["ivf_single", spill, nprobe]
        np.testing.assert_array_equal(i, i1)
        assert np.array_equal(s.view(np.int32), s1.view(np.int32))
        if jax is not None:
            np.testing.assert_array_equal(i, np.asarray(ji))
            np.testing.assert_allclose(s, np.asarray(js), atol=1e-4, rtol=0)


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data")],
                         ids=["data-model", "pod-data"])
def test_batch_group_of_a_two_axis_mesh(four_ranks, axes):
    _, res, device = four_ranks
    q, db, k, _, _ = res[0]["even"]
    refs = _topk_refs(device, q, db, k)
    dp = 2 if axes == ("data", "model") else 4
    for rank, r in enumerate(res):
        batch_axes, dp_size, batch_rank, group_size, s, i = r["mesh", axes]
        assert batch_axes == tuple(a for a in axes if a in ("pod", "data"))
        assert dp_size == group_size == dp
        # ranks are row-major over the mesh: (data, model) keeps rank // 2
        assert batch_rank == (rank // 2 if dp == 2 else rank)
        _assert_topk(s, i, refs)


@CARDS
def test_allgather_time_on_four_cards(tmp_path_factory):
    """The S = 4 engine's cross-shard all-gather over NCCL on 4 cards,
    timed with CUDA events on every rank, printed beside the cost
    model's price for it on ``H100_HOST`` (``pytest -s`` shows it)."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import H100_HOST, CostModel, ModelProfile
    world, res = _results("cuda", 4, tmp_path_factory)
    cost = CostModel(H100_HOST, ModelProfile.from_config(
        get_config("llama3-8b"), kv_format="bf16"), partition_bytes=1.0,
        num_partitions=64)
    price = cost.topk_allgather_time(8, 5, shards=world) * 1e3
    for rank, r in enumerate(res):
        dev_ms, host_ms, nbytes = r["allgather_ms"]
        assert 0 < dev_ms < 1e3 and 0 < host_ms < 1e3
        print(f"[allgather] rank {rank} of {world} cards: {nbytes} B in "
              f"{dev_ms:.4f} ms device, {host_ms:.4f} ms host a call; the "
              f"cost model prices {world} shards at {price:.4f} ms")
