"""Port int8 KV pages vs the JAX package, on the CPU.

* ``kernels/quant.py``: ``paged_scatter_quant`` (which requantizes only
  the pages a call can touch) and ``quantize_rows`` give the reference's
  int8 codes and fp32 scales exactly, on the same numpy inputs, over
  fresh pages, scale growth, chunk appends and dead rows on the trash
  page; the reference rebuilds the whole pool.
* The int8 paged decode's plain version stays within the 0.025 logit
  bound of ``tests/test_quant_kv.py`` of the reference's Pallas kernel in
  interpret mode and of the fp32 oracle.
* The reduced llama's int8 chunked prefill and paged decode give the JAX
  model's greedy tokens, its logits to 2e-3 and its cache to one code at
  no more than two places a leaf: K/V agree to ~1e-6 across the
  frameworks, so a value on a rounding boundary may round the other way.
* The int8 ``ContinuousGenerator`` gives the JAX one's tokens; the pool
  prices its pages as the reference does, and the int8 byte and token
  counters equal the JAX generator's.
* Under bf16 compute the int8 chunked-prefill attention layer equals the
  JAX layer bit for bit: both attend over the fp32 dequantized K/V.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.quant import paged_scatter_quant as jax_scatter_quant
from repro.kernels.quant import quantize_rows as jax_quantize_rows
from repro.models.model import Model as JaxModel
from repro.models.model import make_cache_specs as jax_cache_specs
from repro.serving.generator import ContinuousGenerator as JaxGenerator
from repro.serving.generator import GeneratorConfig as JaxGeneratorConfig
from repro.serving.kvpool import PagedKVCache as JaxPagedKVCache

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, quant
from repro_torch.models.model import Model, init_cache
from repro_torch.serving import ContinuousGenerator, GeneratorConfig
from repro_torch.serving.kvpool import PagedKVCache

LOGIT_BOUND = 0.025      # tests/test_quant_kv.py: int8 vs the fp32 oracle
MARGIN = 1e-3


def _margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


# ------------------------------------------------------ quantize on append
def _write_schedule(rng, b, nmax, page, steps):
    """Chunks then single-token appends per row, some rows dead (their
    table rows all trash), positions as a generator writes them."""
    pos = np.zeros(b, np.int64)
    out = []
    for s in steps:
        p = pos[:, None] + np.arange(s)
        out.append(p.astype(np.int32))
        pos += s
    assert pos.max() <= nmax * page
    return out


@pytest.mark.parametrize("seed,page,steps", [
    (0, 4, [3, 1, 1, 1, 1, 2]),
    (1, 8, [8, 8, 1, 1]),
    (2, 4, [5, 4, 1, 1, 1]),
    (3, 16, [16, 7, 1, 1, 1]),
])
def test_paged_scatter_quant_matches_jax_codes_and_scales(seed, page, steps):
    rng = np.random.default_rng(seed)
    b, kvh, d, nmax = 3, 2, 8, 5
    pages_n = 1 + b * nmax
    tab = np.zeros((b, nmax), np.int32)
    ids = rng.permutation(np.arange(1, pages_n))[:2 * nmax]
    tab[0], tab[2] = ids[:nmax], ids[nmax:]       # row 1: dead, all trash
    # a pool with a previous tenant's codes and scales on every page
    pool = rng.integers(-127, 128, size=(pages_n, page, kvh, d)).astype(
        np.int8)
    scale = rng.uniform(0.001, 0.05, size=(pages_n, kvh)).astype(np.float32)
    jp, js = jnp.asarray(pool), jnp.asarray(scale)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    for i, positions in enumerate(_write_schedule(rng, b, nmax, page,
                                                  steps)):
        new = (rng.normal(size=(b, positions.shape[1], kvh, d))
               * (1 + 3 * i)).astype(np.float32)
        jp, js = jax_scatter_quant(jp, js, jnp.asarray(new),
                                   jnp.asarray(tab), jnp.asarray(positions))
        out = quant.paged_scatter_quant(tp, ts, torch.from_numpy(new),
                                        torch.from_numpy(tab),
                                        torch.from_numpy(positions))
        assert out[0] is tp and out[1] is ts          # in place
        # the trash page's codes are garbage in both; every live page,
        # and every scale, must match exactly
        np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


class _LandAfter(TorchDispatchMode):
    """Runs ``land`` once, right after the ``at``-th aten op: a swap copy
    on another stream that fills pages in the middle of a call."""

    def __init__(self, at, land):
        super().__init__()
        self.at, self.land, self.ops = at, land, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if self.ops == self.at:
            self.land()
        return out


@pytest.mark.parametrize("positions", [
    [[9], [0], [3]],                                  # decode, one fresh
    [[4, 5, 6, 7, 8, 9]] * 3,                         # chunk over a page edge
])
def test_paged_scatter_quant_spares_pages_a_swap_is_filling(positions):
    """Pages outside every row's table (a swap-in's fresh lease) keep
    whatever lands on them while the call runs, at every point of it: the
    call writes back only the pages it touches."""
    rng = np.random.default_rng(0)
    b, kvh, d, nmax, page = 3, 2, 8, 4, 4
    tab = np.zeros((b, nmax), np.int32)
    tab[0], tab[2] = [1, 2, 3, 4], [5, 6, 7, 8]       # row 1: dead, trash
    leased = [9, 10]                                  # being swapped in
    pool0 = torch.from_numpy(rng.integers(
        -127, 128, size=(11, page, kvh, d)).astype(np.int8))
    scale0 = torch.from_numpy(
        rng.uniform(0.001, 0.05, size=(11, kvh)).astype(np.float32))
    pos = torch.tensor(positions, dtype=torch.int32)
    new = torch.from_numpy(rng.normal(
        size=(b, pos.shape[1], kvh, d)).astype(np.float32))
    want_p, want_s = pool0.clone(), scale0.clone()
    quant.paged_scatter_quant(want_p, want_s, new, torch.from_numpy(tab),
                              pos)
    p, s = pool0.clone(), scale0.clone()
    with _LandAfter(0, lambda: None) as count:
        quant.paged_scatter_quant(p, s, new, torch.from_numpy(tab), pos)
    assert count.ops > 10
    for at in range(1, count.ops + 1):
        p, s = pool0.clone(), scale0.clone()

        def land():
            p[leased] = 77
            s[leased] = 7.0

        with _LandAfter(at, land):
            quant.paged_scatter_quant(p, s, new, torch.from_numpy(tab), pos)
        assert (p[leased] == 77).all() and (s[leased] == 7.0).all(), at
        keep = [i for i in range(11) if i not in leased]
        assert torch.equal(p[keep], want_p[keep]), at
        assert torch.equal(s[keep], want_s[keep]), at


@pytest.mark.parametrize("seed,length", [(0, 5), (1, 16), (2, 23)])
def test_quantize_rows_matches_jax(seed, length):
    rng = np.random.default_rng(seed)
    page, kvh, d, pages_n = 8, 2, 16, 7
    pool = rng.integers(-127, 128, size=(pages_n, page, kvh, d)).astype(
        np.int8)
    scale = rng.uniform(0.001, 0.05, size=(pages_n, kvh)).astype(np.float32)
    row = rng.normal(size=(1, length, kvh, d)).astype(np.float32) * 3
    blocks = rng.permutation(np.arange(1, pages_n))
    idx = np.arange(length)
    pages = blocks[idx // page].astype(np.int32)
    offs = (idx % page).astype(np.int32)
    jp, js = jax_quantize_rows(jnp.asarray(pool), jnp.asarray(scale),
                               jnp.asarray(row), jnp.asarray(pages),
                               jnp.asarray(offs))
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    quant.quantize_rows(tp, ts, torch.from_numpy(row),
                        torch.from_numpy(pages), torch.from_numpy(offs))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------ int8 paged decode
def _quantize_pool(pool):
    amax = np.abs(pool).max(axis=(1, 3))
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(pool / np.maximum(scale, 1e-8)[:, None, :, None]),
                -127, 127).astype(np.int8)
    return q, scale


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_paged_decode_plain_matches_jax_kernel(seed):
    rng = np.random.default_rng(seed)
    b, h, kvh, d, page, nmax = 3, 8, 4, 64, 8, 5
    p = 1 + b * nmax
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(p, page, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(p, page, kvh, d)).astype(np.float32)
    tab = rng.permutation(np.arange(1, p))[:b * nmax].reshape(
        b, nmax).astype(np.int32)
    kv_len = rng.integers(1, page * nmax + 1, size=(b,)).astype(np.int32)
    kq, ks = _quantize_pool(kp)
    vq, vs = _quantize_pool(vp)
    want = np.asarray(jax_ref.paged_decode_attention_reference(
        *map(jnp.asarray, (q, kp, vp, tab, kv_len))))
    jax_int8 = np.asarray(jax_ops.paged_decode_attention(
        *map(jnp.asarray, (q, kq, vq, tab, kv_len)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), impl="pallas"))
    got = ops.paged_decode_attention(
        *map(torch.from_numpy, (q, kq, vq, tab, kv_len)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    assert np.abs(got - jax_int8).max() < LOGIT_BOUND
    assert np.abs(got - want).max() < LOGIT_BOUND
    # one dequant contract: the two int8 paths agree far tighter
    np.testing.assert_allclose(got, jax_int8, rtol=2e-5, atol=2e-5)


# -------------------------------------------------- the model, int8 pool
@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jm = JaxModel(jcfg, remat=False)
    jparams = jm.init(jax.random.PRNGKey(1), jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jm, jparams, Model(cfg, device="cpu"), params


def test_int8_chunked_prefill_and_paged_decode_match_jax(models):
    """Two slots chunk-prefill 24 tokens into a shared int8 pool, then 8
    paged decode steps, through one block table in both packages."""
    jm, jparams, tm, params = models
    cfg = tm.cfg
    ctx, chunk, page, steps = 24, 8, 8, 8
    nmax = -(-(ctx + steps) // page)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, ctx)).astype(np.int32)
    tab = np.zeros((2, nmax), np.int32)
    tab[0] = np.arange(1, nmax + 1)
    tab[1] = np.arange(nmax + 1, 2 * nmax + 1)
    pages_n = 2 * nmax + 1
    jcache = jax.tree.map(lambda sp: jnp.zeros(sp.shape, sp.dtype),
                          jax_cache_specs(jm.cfg, pages_n, page, jnp.float32,
                                          kv_format="int8"))
    tcache = init_cache(cfg, pages_n, page, torch.float32, "cpu",
                        kv_format="int8")
    jchunk = jax.jit(lambda p, x, c, off, bt: jm.chunk_prefill(
        p, x, c, off, block_tab=bt, kv_span=ctx))
    jdec = jax.jit(lambda p, x, c, pos, bt: jm.decode(
        p, x, c, pos, block_tab=bt, kv_span=ctx + steps))
    worst = 0.0
    for s in range(2):
        for off in range(0, ctx, chunk):
            x = prompts[s:s + 1, off:off + chunk]
            jl, jcache = jchunk(jparams, jnp.asarray(x), jcache,
                                jnp.asarray([off], jnp.int32),
                                jnp.asarray(tab[s:s + 1]))
            tl = tm.chunk_prefill(params, torch.from_numpy(x), tcache,
                                  torch.tensor([off], dtype=torch.int32),
                                  torch.from_numpy(tab[s:s + 1]),
                                  kv_span=ctx)
            worst = max(worst, float(np.abs(tl.numpy()
                                            - np.asarray(jl)).max()))
    cur = np.asarray(jnp.argmax(jl, -1))
    cur = np.stack([cur, cur]).reshape(2, 1).astype(np.int32)
    for t in range(steps):
        pos = np.full(2, ctx + t, np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(cur), jcache,
                          jnp.asarray(pos), jnp.asarray(tab))
        tl = tm.decode(params, torch.from_numpy(cur), tcache,
                       torch.from_numpy(pos), torch.from_numpy(tab),
                       kv_span=ctx + steps)
        jl_np = np.asarray(jl)
        worst = max(worst, float(np.abs(tl.numpy() - jl_np).max()))
        assert _margin(jl_np) > MARGIN
        assert (tl.numpy().argmax(-1) == jl_np.argmax(-1)).all()
        cur = jl_np.argmax(-1).reshape(2, 1).astype(np.int32)
    # K/V agree to ~1e-6 across the frameworks, so a value on a rounding
    # boundary can land one int8 code apart (one of the 8192 live codes
    # here: 2 layers, K and V, 2 slots x 32 tokens x 2 heads x 16); one
    # code moves a logit by up to ~1e-3
    assert worst < 2e-3, worst
    for jb, tb in zip(_layers(jcache), tcache["blocks"]):
        for name in ("k", "v"):
            diff = np.abs(tb[name].numpy().astype(np.int32)
                          - np.asarray(jb[name]).astype(np.int32))
            assert diff[1:].max() <= 1
            assert (diff[1:] > 0).sum() <= 2
            np.testing.assert_allclose(tb[name + "_scale"].numpy()[1:],
                                       np.asarray(jb[name + "_scale"])[1:],
                                       rtol=1e-5)


def _layers(jcache):
    """The JAX cache's stacked blocks as per-layer dicts."""
    blocks = jcache["blocks"]
    if isinstance(blocks, dict):
        reps = next(iter(blocks.values())).shape[0]
        return [{k: v[i] for k, v in blocks.items()} for i in range(reps)]
    out = []
    for group in blocks:
        reps = next(iter(group.values())).shape[0]
        out.extend({k: v[i] for k, v in group.items()} for i in range(reps))
    return out


def test_int8_generator_tokens_match_jax(models):
    """The int8 paged ``ContinuousGenerator`` (one-shot and chunked
    joins) gives the JAX one's tokens on the same prompts."""
    jm, jparams, tm, params = models
    prompts = [f"query {i} topic{i % 3} alpha beta" for i in range(5)]
    for chunk in (None, 8):
        jgen = JaxGenerator(jm.cfg, jparams, JaxGeneratorConfig(
            ctx_len=16, max_new_tokens=6), num_slots=3, paged=True,
            page_size=4, kv_format="int8", prefill_chunk=chunk)
        tgen = ContinuousGenerator(tm.cfg, params, GeneratorConfig(
            ctx_len=16, max_new_tokens=6), num_slots=3, paged=True,
            page_size=4, kv_format="int8", prefill_chunk=chunk,
            device="cpu")
        assert tgen.kv_format == "int8"
        assert tgen.run(prompts) == jgen.run(prompts), chunk


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_pool_bytes_priced_as_reference(fmt):
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    kv = PagedKVCache(cfg, num_slots=2, total_len=16, page_size=8,
                      kv_format=fmt, device="cpu")
    jkv = JaxPagedKVCache(jcfg, num_slots=2, total_len=16, page_size=8,
                          kv_format=fmt)
    cache = kv.init_stacked()
    assert kv.pool_nbytes(cache) == kv.page_nbytes(cache) * kv.array_pages
    assert kv.page_nbytes(cache) == jkv.page_nbytes(jkv.init_stacked())
    if fmt == "int8":
        assert kv.page_nbytes(cache) == (
            8 * cfg.kv_cache_bytes_per_token(1)
            + cfg.kv_scale_bytes_per_page())



def test_int8_chunked_prefill_attention_bf16_matches_jax():
    """The int8 chunked-prefill attention under bf16 compute, against the
    JAX layer on the same numpy inputs and weights: three chunks append to
    one int8 page run and attend over it.  The reference attends over the
    fp32 dequantized K/V with bf16 q and hands a bf16 output to ``wo``;
    the port does the same, and the outputs come out bit for bit (so
    within the 0.025 bound of ``tests/test_quant_kv.py``).  Rounding the
    dequantized view to bf16 first, as the port once did, moves about
    half the outputs by up to 0.0078.  (At the whole model the two
    frameworks' bf16 arithmetic elsewhere differs by up to about 0.03 a
    logit, with bf16 pages as with int8, so the layer is where this is
    held.)"""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    rng = np.random.default_rng(0)
    w = {n: (rng.normal(size=shape) / np.sqrt(fan)).astype(np.float32)
         for n, shape, fan in (("wq", (d, h, hd), d), ("wk", (d, kvh, hd), d),
                               ("wv", (d, kvh, hd), d),
                               ("wo", (h, hd, d), h * hd))}
    jp = {n: jnp.asarray(a, jnp.bfloat16) for n, a in w.items()}
    tp = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in w.items()}
    ctx, chunk, page = 40, 16, 8
    nmax = ctx // page + 1
    tab = np.arange(1, nmax + 1, dtype=np.int32)[None]
    spec = jax_attention.make_attn_cache_spec(jcfg, "attn", nmax + 1, page,
                                              jnp.bfloat16, kv_format="int8")
    jcache = {n: jnp.zeros(s.shape, s.dtype) for n, s in spec.items()}
    tcache = init_cache(cfg, nmax + 1, page, torch.bfloat16, "cpu",
                        kv_format="int8")["blocks"][0]
    for off in range(0, ctx, chunk):
        c = min(chunk, ctx - off)
        x = rng.normal(size=(1, c, d)).astype(np.float32)
        jout, jcache = jax_attention.attention_forward(
            jp, jnp.asarray(x, jnp.bfloat16), jcfg, mixer="attn",
            mode="prefill", cache=jcache, pos=jnp.asarray([off], jnp.int32),
            block_tab=jnp.asarray(tab), kv_span=ctx)
        out = attention.attention_forward(
            tp, torch.from_numpy(x).to(torch.bfloat16), cfg, mixer="attn",
            mode="prefill", cache=tcache,
            pos=torch.tensor([off], dtype=torch.int32),
            block_tab=torch.from_numpy(tab), kv_span=ctx)
        assert out.dtype == torch.bfloat16
        want = np.asarray(jout, np.float32)
        got = out.float().numpy()
        assert np.abs(got - want).max() < LOGIT_BOUND
        np.testing.assert_array_equal(got, want)


def test_generator_kv_format_knob_and_counters(models):
    """The knob and its counters, as ``tests/test_quant_kv.py`` states
    them: a paged generator exposes its pool format, rejects the knob
    without paging, and the registry sees the int8 byte and token
    counters (quantize-on-append at one-shot joins, dequantized reads at
    decode), each equal to the JAX generator's on the same run."""
    from repro.obs import MetricsRegistry as JaxMetricsRegistry
    from repro_torch.obs import MetricsRegistry
    jm, jparams, tm, params = models
    g = dict(ctx_len=16, max_new_tokens=4)
    with pytest.raises(ValueError):
        ContinuousGenerator(tm.cfg, params, GeneratorConfig(**g),
                            kv_format="int8", device="cpu")
    reg, jreg = MetricsRegistry(), JaxMetricsRegistry()
    gen = ContinuousGenerator(tm.cfg, params, GeneratorConfig(**g),
                              num_slots=2, paged=True, page_size=4,
                              kv_format="int8", registry=reg, device="cpu")
    jgen = JaxGenerator(jm.cfg, jparams, JaxGeneratorConfig(**g),
                        num_slots=2, paged=True, page_size=4,
                        kv_format="int8", registry=jreg)
    assert gen.kv_format == "int8"
    prompts = ["one small prompt", "another prompt"]
    assert gen.run(prompts) == jgen.run(prompts)
    names = ("kv.quant_tokens", "kv.quant_bytes", "kv.dequant_tokens",
             "kv.dequant_bytes")
    got = {n: reg.snapshot()["counters"][n] for n in names}
    want = {n: jreg.snapshot()["counters"][n] for n in names}
    assert got == want
    assert all(v > 0 for v in got.values())
    per_token = tm.cfg.kv_cache_bytes_per_token(1)
    assert got["kv.quant_bytes"] == got["kv.quant_tokens"] * per_token
    assert got["kv.dequant_bytes"] == got["kv.dequant_tokens"] * per_token
    assert gen.steps == jgen.steps > 0
    fp32 = ContinuousGenerator(tm.cfg, params, GeneratorConfig(**g),
                               num_slots=2, paged=True, page_size=4,
                               device="cpu")
    assert fp32.kv_format == "fp32"
