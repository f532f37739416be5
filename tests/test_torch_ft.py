"""The port's fault tolerance (paper §5) against ``tests/test_ft.py``.

Checkpointed retrieval resumes without redoing finished partitions; the
OOM ladder demotes on ``torch.OutOfMemoryError`` (what a CUDA allocation
the card cannot hold raises) and on ``MemoryError``, and lets every other
``RuntimeError`` through; a demoted placement pushed into a live paged
generator funds swap-to-host, with the same capacities as the JAX
generator's under the JAX ladder, so a page-starved join preempts instead
of starving.  ``ElasticMesh`` and ``StragglerMonitor`` wait for the
sharding slice of the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.costmodel import CostModel as JaxCostModel
from repro.core.costmodel import ModelProfile as JaxModelProfile
from repro.core.costmodel import PF_HIGH as JAX_PF_HIGH
from repro.core.placement import PlacementOptimizer as JaxOptimizer
from repro.ft import OOMRecovery as JaxOOMRecovery
from repro.models.model import Model as JaxModel
from repro.serving.generator import ContinuousGenerator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.costmodel import GB, PF_HIGH, CostModel, ModelProfile
from repro_torch.core.placement import Placement, PlacementOptimizer
from repro_torch.ft import (CheckpointedRetrieval, OOMRecovery,
                            retry_with_backoff)
from repro_torch.retrieval import HashEmbedder, VectorStore
from repro_torch.serving import (ContinuousGenerator, Generator,
                                 GeneratorConfig)


def _store(tmp_path):
    emb = HashEmbedder(dim=32)
    texts = [f"doc {i} t{i % 9}" for i in range(200)]
    return VectorStore.build(texts, emb, num_partitions=5,
                             root=str(tmp_path), device="cpu"), emb


def _optimizer():
    mp = ModelProfile.from_config(get_config("llama3-70b"))
    cost = CostModel(PF_HIGH, mp, partition_bytes=8 * GB, num_partitions=32)
    return PlacementOptimizer(cost, 512, 32)


def test_checkpointed_retrieval_resumes(tmp_path):
    store, emb = _store(tmp_path)
    q = emb.embed(["doc 17", "t3"])
    want_s, want_i = store.search(q, top_k=5)
    fails = {"budget": 3}

    def fault_hook(pid):
        if pid == 3 and fails["budget"] > 0:
            fails["budget"] -= 1
            raise RuntimeError("injected retrieval failure")

    cr = CheckpointedRetrieval(store, fault_hook=fault_hook)
    got_s, got_i = cr.search(q, top_k=5)
    assert (got_i == want_i).all()
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    assert cr.partitions_resumed >= 3      # partitions 0..2 never redone


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 64 GiB"),
    MemoryError("host allocation failed")])
def test_oom_recovery_ladder_demotes_then_succeeds(error):
    opt = _optimizer()
    rec = OOMRecovery(opt)
    start = opt.solve(32)
    attempts = {"n": 0}

    def gen(p):
        attempts["n"] += 1
        if attempts["n"] <= 2:
            raise error
        return "ok"

    out, final = rec.run(gen, start)
    assert out == "ok"
    assert len(rec.history) == 2
    # the ladder moved memory DOWN the hierarchy
    assert final.c_gpu <= start.c_gpu and final.w_gpu <= start.w_gpu


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    ValueError("not an allocation")])
def test_unrelated_errors_propagate(error):
    """Only an out-of-memory error takes the ladder: XLA's text in a plain
    ``RuntimeError`` is no OOM to the port."""
    rec = OOMRecovery(_optimizer())

    def gen(p):
        raise error

    with pytest.raises(type(error)):
        rec.run(gen, rec.opt.solve(8))
    assert rec.history == []


def test_retry_with_backoff():
    calls = {"n": 0}

    @retry_with_backoff(retries=3, base_delay=0.001)
    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return 42

    assert flaky() == 42
    assert calls["n"] == 3


def test_degraded_placement_triggers_swap_not_starvation():
    """The ladder's c_gpu -> c_cpu shift funds the host pool of a live
    paged generator: a page-starved join preempts the lowest-priority
    slot instead of starving, every request completes with the
    uninterrupted tokens, and each pool's capacity after the demotion
    equals the JAX generator's under the JAX ladder."""
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1),
                                               jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    ctx, new, page = 16, 4, 4
    worst = -(-(ctx + new) // page)                  # 5 pages a request
    prompts = ["alpha one", "beta two", "gamma three"]
    gens = {
        "port": ContinuousGenerator(
            cfg, params, GeneratorConfig(ctx_len=ctx, max_new_tokens=new),
            num_slots=3, paged=True, page_size=page,
            page_budget=2 * worst, host_page_budget=0, device="cpu"),
        "jax": JaxGenerator(
            jcfg, jparams, JaxGeneratorConfig(ctx_len=ctx, max_new_tokens=new),
            num_slots=3, streamed=False, paged=True, page_size=page,
            page_budget=2 * worst, host_page_budget=0)}
    recs = {
        "port": OOMRecovery(PlacementOptimizer(
            CostModel(PF_HIGH, ModelProfile.from_config(cfg),
                      partition_bytes=8 * GB, num_partitions=8),
            avg_ctx_len=ctx, avg_out_len=new, kv_page_size=page)),
        "jax": JaxOOMRecovery(JaxOptimizer(
            JaxCostModel(JAX_PF_HIGH, JaxModelProfile.from_config(jcfg),
                         partition_bytes=8 * GB, num_partitions=8),
            avg_ctx_len=ctx, avg_out_len=new, kv_page_size=page))}
    oom = {"port": torch.OutOfMemoryError("CUDA out of memory"),
           "jax": RuntimeError("RESOURCE_EXHAUSTED: out of memory")}
    caps = {}
    for name, gen in gens.items():
        assert gen.join("a", prompts[0]) is not None
        assert gen.join("b", prompts[1]) is not None
        assert gen.join("c", prompts[2]) is None        # page backpressure
        assert gen.preempt(gen.swap_victim()) is None   # host pool: 0 pages
        p0 = Placement(w_gpu=0.25, w_cpu=0.75, c_gpu=2 / 3, c_cpu=0.1,
                       resident_partitions=0, gen_batch=3)
        calls = {"n": 0}

        def flaky_gen(p):
            calls["n"] += 1
            if calls["n"] == 1:
                raise oom[name]
            return "ok"

        out, p1 = recs[name].run(flaky_gen, p0, generator=gen)
        assert out == "ok" and p1.c_cpu > p0.c_cpu     # KV demoted to host
        caps[name] = (p1.c_gpu, p1.c_cpu, gen.kv.pool.capacity,
                      gen.kv.host.capacity,
                      recs[name].apply_placement(gen, p1))
    assert caps["port"] == caps["jax"]
    gen = gens["port"]
    assert gen.kv.host.capacity >= worst              # swap tier funded
    # the previously starving join now rides a preemption
    assert gen.preempt(gen.swap_victim()) is not None
    assert gen.join("c", prompts[2]) is not None
    assert gen.swap_outs == 1
    results, guard = {}, 0
    while gen.active_slots or gen.parked_slots:
        for key in gen.parked_keys():
            gen.resume(key)          # None until pages free up
        gen.step()
        for key, text, _ in gen.harvest():
            results[key] = text
        guard += 1
        assert guard < 100, "swap path starved"
    # token identity survives the degradation cycle
    dense = Generator(cfg, params, GeneratorConfig(
        ctx_len=ctx, max_new_tokens=new), device="cpu").generate(prompts)
    assert [results["a"], results["b"], results["c"]] == dense
