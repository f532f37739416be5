"""Port model vs the JAX model on the same converted weights.

``Model(get_config("llama3-8b").reduced(num_layers=2))`` in fp32 on the
CPU: chunked prefill of two slots into a shared page pool, then 8 paged
decode steps, through the same block table in both packages.  Logits
agree to 1e-4; greedy tokens are equal (after asserting that every JAX
step's top-2 logit gap exceeds 1e-3, so equal tokens are a fair demand).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model, init_cache

CTX, CHUNK, PAGE, STEPS = 24, 8, 8, 8
MARGIN = 1e-3


def _margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("llama3-8b").reduced(num_layers=2)
    jm = JaxModel(jcfg, remat=False)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.float32)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.float32)
    return jm, jparams, Model(cfg, device="cpu"), params


def test_config_copy_matches_reference():
    jcfg = jax_get_config("llama3-8b")
    cfg = get_config("llama3-8b")
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.kv_cache_bytes_per_token() == jcfg.kv_cache_bytes_per_token()


def test_chunked_prefill_and_paged_decode_match_jax(models):
    jm, jparams, tm, params = models
    cfg = tm.cfg
    total = CTX + STEPS
    nmax = -(-total // PAGE)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(2, CTX)).astype(np.int32)
    tab = np.zeros((2, nmax), np.int32)
    tab[0] = np.arange(1, nmax + 1)
    tab[1] = np.arange(nmax + 1, 2 * nmax + 1)[::-1]   # any page order
    pages = 2 * nmax + 1                              # + trash page 0

    jcache = jax_init_cache(jm.cfg, pages, PAGE, jnp.float32)
    jcache = {"blocks": [{k: v for k, v in c.items()}
                         for c in jcache["blocks"]]}
    tcache = init_cache(cfg, pages, PAGE, torch.float32, "cpu")
    jtab, ttab = jnp.asarray(tab), torch.from_numpy(tab)

    jlog, tlog = [], []
    for slot in range(2):
        for off in range(0, CTX, CHUNK):
            chunk = prompts[slot:slot + 1, off:off + CHUNK]
            jl, jcache = jm.chunk_prefill(
                jparams, jnp.asarray(chunk), jcache,
                jnp.full((1,), off, jnp.int32), block_tab=jtab[slot:slot + 1],
                kv_span=CTX)
            tl = tm.chunk_prefill(
                params, torch.from_numpy(chunk), tcache,
                torch.full((1,), off, dtype=torch.int32), ttab[slot:slot + 1],
                kv_span=CTX)
        jlog.append(np.asarray(jl)[0])
        tlog.append(tl[0].numpy())
    jlogits = [np.stack(jlog)]
    tlogits = [np.stack(tlog)]
    jcur = np.argmax(jlogits[0], -1).astype(np.int32)
    tcur = np.argmax(tlogits[0], -1).astype(np.int32)
    for t in range(STEPS - 1):
        pos = np.full((2,), CTX + t, np.int32)
        jl, jcache = jm.decode(jparams, jnp.asarray(jcur[:, None]), jcache,
                               jnp.asarray(pos), block_tab=jtab,
                               kv_span=total)
        tl = tm.decode(params, torch.from_numpy(tcur[:, None]), tcache,
                       torch.from_numpy(pos), ttab, kv_span=total)
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())
        jcur = np.argmax(jlogits[-1], -1).astype(np.int32)
        tcur = np.argmax(tlogits[-1], -1).astype(np.int32)

    jall, tall = np.stack(jlogits), np.stack(tlogits)
    assert _margin(jall) > MARGIN, "prompts lack a greedy margin"
    np.testing.assert_allclose(tall, jall, atol=1e-4)
    np.testing.assert_array_equal(tall.argmax(-1), jall.argmax(-1))
