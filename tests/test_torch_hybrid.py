"""jamba-1.5-large-398b (Mamba and attention mixers over dense and MoE
FFNs in one 8-layer pattern) in the port against the JAX package, on the
CPU.

``.reduced()`` keeps the whole pattern (8 layers: Mamba2 mixers but at
index 3, an attention mixer with RoPE; dense FFNs at even indices, MoE
FFNs of 4 experts top 2 at odd ones), d_model 64, 4/2 heads x 16, SSD
heads of 16 with chunks of 8, in fp32 on the same converted weights
(``PRNGKey(SEED)``) and the same prompts.  A second variant sets
``num_heads=8, num_kv_heads=1``: G = 8 query heads a kv head, the decode
kernels' new grouping.

* the config copy field by field, with its bytes at full width;
* the per-layer cache spec mixes ``k``/``v`` and ``conv``/``state``
  leaves as the reference's does;
* one-shot prefill and dense decode logits (3e-4, the bar of
  ``tests/test_models.py``) and the caches;
* greedy tokens of the whole-batch ``Generator``, the dense
  ``ContinuousGenerator`` and ``streamed=True`` on both equal the JAX
  whole-batch ``Generator``'s, after asserting every greedy gap exceeds
  1e-3; a dense resize between joins;
* ``resize_cache_rows`` over the mixed leaves;
* ``paged=True`` and chunked prefill raise, in both packages;
* the capacity path's drops in a whole-batch prefill, row for row;
* the streamed executor stages and runs the uneven layers in the JAX
  executor's order, its depth from the mean layer as the reference's, its
  ring slots sized by the largest layer; ``launch/serve.py``.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.prefetch import PrefetchPolicy as JaxPolicy
from repro.core.prefetch import StreamedExecutor as JaxExecutor
from repro.models import moe as jmoe
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import make_cache_specs as jax_cache_specs
from repro.serving.generator import Generator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagedKVCache as JaxPagedKVCache
from repro.serving.kvpool import resize_cache_rows as jax_resize_rows

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.prefetch import PrefetchPolicy, StreamedExecutor
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import moe, transformer
from repro_torch.models.model import Model, init_cache, make_cache_specs
from repro_torch.serving import ContinuousGenerator, Generator
from repro_torch.serving import GeneratorConfig
from repro_torch.serving.kvpool import PagedKVCache, resize_cache_rows

ARCH = "jamba-1.5-large-398b"
CTX, MAX_NEW, STEPS = 24, 5, 6
LOGIT_TOL, MARGIN = 3e-4, 1e-3
SEED = 1
# (reduced() overrides, JAX init seed with greedy margins)
VARIANTS = [({}, SEED), ({"num_heads": 8, "num_kv_heads": 1}, SEED)]
VARIANT_IDS = ["reduced", "g8"]


def _prompts(n=6):
    return [f"query {i} topic{i % 3} alpha beta" for i in range(n)]


def _gap(logits) -> float:
    top2 = np.sort(np.asarray(logits, dtype=np.float32), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.fixture(scope="module", params=VARIANTS, ids=VARIANT_IDS)
def weights(request):
    overrides, seed = request.param
    jcfg = jax_get_config(ARCH).reduced(**overrides)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(seed),
                                               jnp.float32)
    cfg = get_config(ARCH).reduced(**overrides)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX whole-batch ``Generator``'s tokens and its least greedy
    gap."""
    jcfg, jparams, _, _ = weights
    jgen = JaxGenerator(jcfg, jparams, JaxGeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW))
    gaps = []

    def rec(fn):
        def call(*a):
            logits, cache = fn(*a)
            gaps.append(_gap(logits))
            return logits, cache
        return call

    jgen._prefill, jgen._decode = rec(jgen._prefill), rec(jgen._decode)
    return jgen.generate(_prompts()), min(gaps)


# ------------------------------------------------------------- config
def test_config_copy_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for f in cfg.__dataclass_fields__:
        want, got = getattr(jcfg, f), getattr(cfg, f)
        if f in ("moe", "ssm") and want is not None:
            assert vars(got) == vars(want), f
        else:
            assert got == want, f
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.param_count() == j.param_count()
        assert c.param_count(active_only=True) == \
            j.param_count(active_only=True)
        assert c.weight_bytes() == j.weight_bytes()
        assert c.kv_cache_bytes_per_token() == j.kv_cache_bytes_per_token()
        assert c.ssm_state_bytes() == j.ssm_state_bytes()
    assert ARCH in ASSIGNED_ARCHS
    assert cfg.family == "hybrid" and cfg.num_heads // cfg.num_kv_heads == 8
    # the card's cuts: one 8-layer block 90.26 GB, depth 4 45.95 GB (bf16)
    block = dataclasses.replace(cfg, num_layers=8)
    four = dataclasses.replace(cfg, num_layers=4)
    assert block.weight_bytes() == 90_263_380_736
    assert four.weight_bytes() == 45_951_340_288
    assert {k for k, _ in four.layer_kinds()} == {"mamba", "attn"}
    assert {f for _, f in four.layer_kinds()} == {"dense", "moe"}
    red = cfg.reduced()
    assert red.num_layers == 8 and red.layer_kinds() == cfg.layer_pattern


def test_family_check_serves_the_hybrid():
    """The hybrid is taken, as all ten reference configs are (the embed
    frontend and the encoder-decoder too); an unknown mixer beside
    jamba's Mamba, or an unknown FFN, still raises."""
    transformer._check_family(get_config(ARCH))
    transformer._check_family(jax_get_config(ARCH))
    for arch in ("seamless-m4t-medium", "chameleon-34b"):
        transformer._check_family(jax_get_config(arch))
    cfg = get_config(ARCH)
    for pattern in (cfg.layer_pattern[:3] + (("retnet", "moe"),),
                    cfg.layer_pattern[:3] + (("attn", "sparse"),)):
        with pytest.raises(NotImplementedError):
            transformer._check_family(
                dataclasses.replace(cfg, layer_pattern=pattern))


def test_cache_spec_mixes_leaves_as_the_reference(weights):
    """Per layer, the reference's leaves and shapes: ``k``/``v`` for the
    attention layer, ``conv``/``state`` (fp32) for the Mamba layers."""
    jcfg, _, cfg, _ = weights
    spec = make_cache_specs(cfg, 3, 20, torch.float32)["blocks"]
    jspec = jax_cache_specs(jcfg, 3, 20, jnp.float32)["blocks"]
    assert len(jspec) == len(cfg.layer_pattern) == len(spec)
    for (mixer, _), layer, jlayer in zip(cfg.layer_kinds(), spec, jspec):
        assert set(layer) == ({"k", "v"} if mixer == "attn"
                              else {"conv", "state"})
        for n, (shape, dt) in layer.items():
            assert (1,) + shape == tuple(jlayer[n].shape), n
            assert str(dt).replace("torch.", "") == str(jlayer[n].dtype)


# ---------------------------------------------------------------- model
def test_one_shot_prefill_and_dense_decode_logits_match_jax(weights):
    jcfg, jparams, cfg, params = weights
    jm, tm = JaxModel(jcfg, remat=False), Model(cfg, device="cpu")
    rng = np.random.default_rng(9)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32)
    total = CTX + STEPS
    jcache = jax_init_cache(jcfg, 2, total, jnp.float32)
    tcache = init_cache(cfg, 2, total, torch.float32, "cpu")
    jdec = jax.jit(jm.decode)
    jl, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(prompts), jcache)
    tl = tm.prefill(params, torch.from_numpy(prompts), tcache)
    jall, tall = [np.asarray(jl)], [tl.numpy()]
    cur = np.argmax(jall[0], -1).astype(np.int32)
    for t in range(STEPS):
        pos = np.full((2,), CTX + t, np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(cur[:, None]), jcache,
                          jnp.asarray(pos))
        tl = tm.decode(params, torch.from_numpy(cur[:, None]), tcache,
                       torch.from_numpy(pos))
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
        cur = np.argmax(jall[-1], -1).astype(np.int32)
    np.testing.assert_allclose(np.stack(tall), np.stack(jall),
                               atol=LOGIT_TOL)
    # every layer's cache: the attention layer's K/V, the Mamba layers'
    # conv history and state
    for i, tc in enumerate(tcache["blocks"]):
        for n, leaf in tc.items():
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(jcache["blocks"][i][n][0]),
                atol=1e-4)


# ----------------------------------------------------------- generators
GEN_PATHS = {
    "whole_batch": dict(),
    "streamed": dict(streamed=True),
    "dense": dict(continuous=True),
    "dense_streamed": dict(continuous=True, streamed=True),
}


@pytest.mark.parametrize("path", list(GEN_PATHS))
def test_generator_paths_match_jax_tokens(weights, jax_tokens, path):
    _, _, cfg, params = weights
    want, gap = jax_tokens
    assert gap > MARGIN, "prompts lack a greedy margin"
    kw = dict(GEN_PATHS[path])
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    if kw.pop("continuous", False):
        cont = ContinuousGenerator(cfg, params, g, num_slots=3, device="cpu",
                                   **kw)
        got = cont.run(_prompts(), schedule=[2, 1, 0, 1, 3])
    else:
        got = Generator(cfg, params, g, device="cpu", **kw).generate(
            _prompts())
    assert got == want


def test_dense_resize_keeps_tokens(weights, jax_tokens):
    """The dense slot table grown and shrunk between joins: both kinds of
    leaf ride ``resize_cache_rows`` and the slot scatter."""
    _, _, cfg, params = weights
    want, _ = jax_tokens
    cont = ContinuousGenerator(cfg, params, GeneratorConfig(
        ctx_len=CTX, max_new_tokens=MAX_NEW), num_slots=2, device="cpu")
    prompts = _prompts()
    results, pending, tick = [None] * len(prompts), list(
        enumerate(prompts))[::-1], 0
    while pending or cont.active_slots:
        if tick == 2:
            assert cont.resize(4) == 4
        if tick == 5:
            cont.resize(3)
        while pending and cont.free_slots:
            key, text = pending.pop()
            assert cont.join(key, text) is not None
        cont.step()
        for key, text, _ in cont.harvest():
            results[key] = text
        tick += 1
        assert tick < 200
    assert results == want
    for layer in cont.cache["blocks"]:
        for leaf in layer.values():
            assert leaf.shape[0] == cont.num_slots


def test_resize_cache_rows_on_mixed_leaves_matches_jax(weights):
    jcfg, _, cfg, _ = weights
    rng = np.random.default_rng(7)
    tc = init_cache(cfg, 3, 10, torch.float32, "cpu")
    jc = jax_init_cache(jcfg, 3, 10, jnp.float32)
    for i, layer in enumerate(tc["blocks"]):
        for n, leaf in layer.items():
            a = rng.normal(size=leaf.shape).astype(np.float32)
            leaf.copy_(torch.from_numpy(a))
            jc["blocks"][i][n] = jnp.asarray(a)[None]
    for rows in (5, 2):
        resize_cache_rows(tc, rows)
        jc = jax_resize_rows(jc, rows)
        for i, layer in enumerate(tc["blocks"]):
            assert set(layer) == set(jc["blocks"][i])
            for n, leaf in layer.items():
                assert leaf.shape[0] == rows
                np.testing.assert_array_equal(
                    leaf.numpy(), np.asarray(jc["blocks"][i][n][0]))


# -------------------------------------------------------------- refusals
def test_paged_and_chunked_prefill_raise_as_in_jax(weights):
    jcfg, jparams, cfg, params = weights
    g = GeneratorConfig(ctx_len=CTX, max_new_tokens=MAX_NEW)
    with pytest.raises(NotImplementedError):
        JaxPagedKVCache(jcfg, 2, CTX + MAX_NEW, 8)
    with pytest.raises(NotImplementedError):
        PagedKVCache(cfg, 2, CTX + MAX_NEW, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        PagedKVCache(get_config(ARCH), 2, CTX + MAX_NEW, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                            device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousGenerator(cfg, params, g, num_slots=2, paged=True,
                            prefill_chunk=8, streamed=True, device="cpu")
    cache = init_cache(cfg, 4, 8, torch.float32, "cpu")
    tab = torch.arange(1, 4, dtype=torch.int32)[None]
    ids = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attn-family"):
        Model(cfg, device="cpu").chunk_prefill(
            params, ids, cache, torch.zeros((1,), dtype=torch.int32), tab,
            kv_span=8)
    with pytest.raises(NotImplementedError, match="attn-family"):
        JaxModel(jcfg, remat=False).chunk_prefill(
            jparams, jnp.ones((1, 8), jnp.int32),
            jax_init_cache(jcfg, 4, 8, jnp.float32),
            jnp.zeros((1,), jnp.int32), block_tab=jnp.asarray(tab.numpy()),
            kv_span=8)


# -------------------------------------------------------------- the MoE
def test_whole_batch_prefill_capacity_drops_match_jax(weights,
                                                      monkeypatch):
    """With the capacity threshold lowered in both packages, a
    whole-batch prefill of the six padded prompts (288 rows a MoE layer)
    takes the capacity path in each of the 4 MoE layers: the same rows
    come back dropped (zero) in both, as many as ``capacity_drops``
    counts, and the prefill's logits agree."""
    jcfg, jparams, cfg, params = weights
    monkeypatch.setattr(jmoe, "CAPACITY_THRESHOLD", 64)
    monkeypatch.setattr(moe, "CAPACITY_THRESHOLD", 64)
    seen = {"jax": [], "port": []}
    jgrouped, tgrouped = jmoe.grouped_ffn, moe.grouped_ffn

    def jrec(p, xs, gs, kind, impl="auto"):
        y = jgrouped(p, xs, gs, kind, impl)
        seen["jax"].append((np.asarray(gs), np.asarray(y)))
        return y

    def trec(p, xs, gs, kind, impl="auto"):
        y = tgrouped(p, xs, gs, kind, impl)
        seen["port"].append((gs.numpy(), y.numpy()))
        return y

    monkeypatch.setattr(jmoe, "grouped_ffn", jrec)
    monkeypatch.setattr(moe, "grouped_ffn", trec)
    from repro_torch.serving.generator import HashTokenizer
    tok = HashTokenizer(cfg.vocab_size)
    ids = np.stack([tok.encode(p, CTX) for p in _prompts()])
    total = CTX + 2
    with jax.disable_jit():
        jl, _ = JaxModel(jcfg, remat=False).prefill(
            jparams, jnp.asarray(ids), jax_init_cache(jcfg, 6, total,
                                                      jnp.float32))
    tl = Model(cfg, device="cpu").prefill(
        params, torch.from_numpy(ids), init_cache(cfg, 6, total,
                                                  torch.float32, "cpu"))
    n_moe = sum(f == "moe" for _, f in cfg.layer_kinds())
    assert len(seen["jax"]) == len(seen["port"]) == n_moe == 4
    total_drops = 0
    for (jgs, jy), (tgs, ty) in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(tgs, jgs)
        dropped = ~jy.any(axis=1)
        np.testing.assert_array_equal(~ty.any(axis=1), dropped)
        assert int(moe.capacity_drops(torch.from_numpy(tgs),
                                      ty.shape[0])) == int(dropped.sum())
        total_drops += int(dropped.sum())
        np.testing.assert_allclose(ty, jy, atol=2e-5)
    assert total_drops > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)


# -------------------------------------------------------------- streaming
def test_streamed_executor_order_over_uneven_layers_matches_jax(
        weights, monkeypatch):
    """Layers of three sizes (Mamba + dense, Mamba + MoE, attention + MoE):
    the port's depth comes from the mean layer, as the JAX executor's;
    it stages and runs them in the JAX executor's order, counts their
    bytes, and gives the JAX executor's logits."""
    jcfg, jparams, cfg, params = weights
    ex = StreamedExecutor(cfg, params, PrefetchPolicy(max_depth=1),
                          device="cpu")
    jex = JaxExecutor(jcfg, jparams, JaxPolicy(max_depth=1))
    per_layer = [sum(t.numel() * t.element_size()
                     for t in jax.tree.leaves(lp)) for lp in params["blocks"]]
    assert len(set(per_layer)) == 3
    assert max(per_layer) > ex.layer_bytes
    assert ex.streamed_bytes == sum(per_layer)
    assert ex.layer_bytes == jex.layer_bytes == sum(per_layer) / 8
    assert ex.ring_slots == 2
    assert ex.ring_nbytes == 0          # nothing is copied on the CPU
    assert ex.layer_kinds() == list(cfg.layer_kinds()) == \
        list(jex.layer_kinds())
    log, jlog = [], []
    stage, apply_layer = StreamedExecutor._stage, transformer.apply_layer
    monkeypatch.setattr(StreamedExecutor, "_stage",
                        lambda self, i: (log.append(i), stage(self, i))[1])

    def rec_apply(lp, *a, **kw):
        log.append(("attn" if "attn" in lp else "mamba")
                   + ("+moe" if "moe" in lp else "+dense"))
        return apply_layer(lp, *a, **kw)

    monkeypatch.setattr(transformer, "apply_layer", rec_apply)
    index = {id(lp): i for i, (_, lp) in enumerate(jex.layers)}
    put = jax.device_put
    monkeypatch.setattr(jax, "device_put", lambda x, *a, **kw: (
        jlog.append(index[id(x)]) if id(x) in index else None,
        put(x, *a, **kw))[1])
    toks = np.arange(2, 2 + 2 * CTX, dtype=np.int32).reshape(2, CTX)
    jd, td = jex.init_caches(2, CTX + 1), ex.init_caches(2, CTX + 1)
    jl = jex.prefill(jnp.asarray(toks), jd)
    tl = ex.prefill(torch.from_numpy(toks), td)
    kinds = [f"{m}+{f}" for m, f in cfg.layer_kinds()]
    # one layer ahead: stage 0, then (stage i + 1, run i), then run 7
    want = [0]
    for i in range(8):
        want += ([i + 1] if i + 1 < 8 else []) + [kinds[i]]
    assert log == want
    assert [i for i in log if isinstance(i, int)] == jlog == list(range(8))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl[0]),
                               atol=LOGIT_TOL)


# ------------------------------------------------ decode kernels at G = 8
def test_decode_shapes_take_g8_and_the_table_is_the_kernels():
    """64/8 heads x 128 (llama3-70b, jamba) passes the decode kernels'
    shape check, an unbuilt grouping raises before any build, and
    ``BUILT_SHAPES`` lists what ``kBuilt`` in the CUDA source lists."""
    pa.check_decode_shape(64, 8, 128)
    pa.check_decode_shape(8, 1, 16)
    for h, kvh, d in ((64, 8, 256), (32, 1, 128), (24, 8, 128)):
        with pytest.raises(ValueError, match="not built"):
            pa.check_decode_shape(h, kvh, d)
    src = (Path(pa.__file__).resolve().parents[1] / "csrc"
           / "decode_tiles.cuh").read_text()
    table = src[src.index("kBuilt[] = {"):].split(";")[0]
    pairs = {(int(g), int(e))
             for g, e in re.findall(r"\{(\d+), (\d+)\}", table)}
    assert pairs == {(g, b // 32) for g, bs in pa.BUILT_SHAPES.items()
                     for b in bs}


class _FakeDecodeLib:
    """Stands for a loaded decode library: reports ``pairs`` as built."""

    def __init__(self, pairs):
        def report(buf, cap):
            for i, (g, e) in enumerate(pairs[:cap]):
                buf[2 * i], buf[2 * i + 1] = g, e
            return len(pairs)
        self.decode_built_shapes = report


def test_load_check_holds_built_shapes_to_the_library():
    same = [(g, b // 32) for g, bs in pa.BUILT_SHAPES.items() for b in bs]
    pa._check_built(_FakeDecodeLib(same))
    for other in (same[:-1], same + [(32, 4)],
                  [p for p in same if p != (8, 4)] + [(8, 8)]):
        with pytest.raises(RuntimeError, match="kBuilt"):
            pa._check_built(_FakeDecodeLib(other))


def test_launch_serve_jamba_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--rate", "6000", "--chunks", "120"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu" in out
