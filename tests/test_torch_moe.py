"""The port's MoE FFN against ``repro.models.moe``, on the CPU.

The same numpy tokens and the same converted expert weights through both
packages, at granite-moe-1b-a400m's ``.reduced()`` width (4 experts, top
2, d_ff 32) and at the full expert count (32 experts, top 8) with a
narrow width:

* ``_route``: weights, ids and probabilities; equal probabilities pick
  the lower expert first, as ``jax.lax.top_k`` does;
* ``grouped_ffn`` on the exact path and on the capacity path (T*K >=
  8192 rows), including routings that overflow an expert, so that rows
  are dropped: the same rows in both packages (zero rows of the output),
  and as many as ``capacity_drops`` counts;
* ``moe_forward``: output and aux loss, below and above the threshold;
* the router stays fp32 under bf16 weights.

Routing compares ids exactly, so every case asserts a margin of 1e-5
between each token's k-th and (k+1)-th router logit first (seeds chosen
for it).  Outputs agree to 2e-5 (fp32 products summed in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.models.model import Model

ARCH = "granite-moe-1b-a400m"
TOL = 2e-5
ROUTE_MARGIN = 1e-5


def _cfgs(**overrides):
    return (jax_get_config(ARCH).reduced(**overrides),
            get_config(ARCH).reduced(**overrides))


def _wide_moe(jcfg):
    """The full expert count and top-k at the reduced width."""
    import dataclasses
    m = dataclasses.replace(jcfg.moe, num_experts=32, top_k=8)
    return dataclasses.replace(jcfg, moe=m)


def _params(jcfg, seed, skew=0.0):
    """JAX expert weights; ``skew`` adds to expert 0's router column so
    that it draws more tokens than its capacity."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if skew:
        jp["router"] = jp["router"].at[:, 0].add(skew)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _tokens(t, d, seed):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def _margin(x: np.ndarray, router, k: int) -> float:
    """Least gap between a token's k-th and (k+1)-th router logit (the
    softmax keeps their order; probabilities in the tail underflow)."""
    logits = x.astype(np.float64) @ np.asarray(router, np.float64)
    s = np.sort(logits, axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


def _routed(jp, x, m):
    w, ids, probs = jmoe._route(jp, jnp.asarray(x), m)
    assert _margin(x, jp["router"], m.top_k) > ROUTE_MARGIN, \
        "tokens lack a routing margin"
    return np.asarray(w), np.asarray(ids), np.asarray(probs)


@pytest.mark.parametrize("wide", [False, True])
def test_route_matches_jax(wide):
    jcfg, _ = _cfgs()
    if wide:
        jcfg = _wide_moe(jcfg)
    jp, tp = _params(jcfg, 1)
    x = _tokens(64, jcfg.d_model, 2)
    w, ids, probs = _routed(jp, x, jcfg.moe)
    tw, tids, tprobs = moe._route(tp, torch.from_numpy(x), jcfg.moe)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_allclose(tw.numpy(), w, atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), probs, atol=1e-6)


def test_route_ties_take_the_lower_expert_first():
    """Experts 1 and 2 have the same router column, so every token's
    probabilities for them are equal bit for bit."""
    jcfg, _ = _cfgs()
    jp, _ = _params(jcfg, 3)
    jp["router"] = jp["router"].at[:, 2].set(jp["router"][:, 1])
    jp["router"] = jp["router"].at[:, 1].add(3.0).at[:, 2].add(3.0)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.abs(_tokens(16, jcfg.d_model, 4))
    _, ids, probs = jmoe._route(jp, jnp.asarray(x), jcfg.moe)
    assert (np.asarray(probs)[:, 1] == np.asarray(probs)[:, 2]).all()
    _, tids, _ = moe._route(tp, torch.from_numpy(x), jcfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    assert (np.asarray(ids)[:, 0] == 1).any()        # a tie at the top


def _sorted_rows(jp, x, m):
    """The reference's dispatch: rows sorted by expert, group sizes."""
    _, ids, _ = _routed(jp, x, m)
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    xs = x[order // m.top_k]
    gs = np.bincount(flat, minlength=m.num_experts).astype(np.int32)
    return xs, gs


@pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu"])
@pytest.mark.parametrize("wide", [False, True])
def test_grouped_ffn_exact_matches_jax(mlp_kind, wide):
    jcfg, _ = _cfgs()
    if wide:
        jcfg = _wide_moe(jcfg)
    jp, tp = _params(jcfg, 5)
    xs, gs = _sorted_rows(jp, _tokens(40, jcfg.d_model, 6), jcfg.moe)
    want = np.asarray(jmoe.grouped_ffn(jp, jnp.asarray(xs), jnp.asarray(gs),
                                       mlp_kind, impl="ragged"))
    got = moe.grouped_ffn(tp, torch.from_numpy(xs), torch.from_numpy(gs),
                          mlp_kind, impl="ragged").numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("run", [1, 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_grouped_ffn_exact_runs_of_experts_match_one_run(monkeypatch, run,
                                                         dtype):
    """The exact path in runs of ``run`` experts (``EXACT_RUN_BYTES``
    lowered to fit that many; 32 experts top 8, an empty group) gives the
    one-run result bit for bit and JAX's to its bar."""
    jcfg, _ = _cfgs()
    jcfg = _wide_moe(jcfg)
    if dtype == "bf16":
        jp, tp = _experts_bf16(jcfg, 21)
    else:
        jp, tp = _params(jcfg, 21)
    xs, gs = _sorted_rows(jp, _tokens(5, jcfg.d_model, 22), jcfg.moe)
    gs_np = np.asarray(gs)
    assert (gs_np == 0).any()
    xt = torch.from_numpy(np.array(xs, dtype=np.float32))
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    one = moe.grouped_ffn(tp, xt, torch.from_numpy(gs_np), "swiglu",
                          impl="ragged")
    tk, f = xt.shape[0], tp["w_gate"].shape[-1]
    monkeypatch.setattr(moe, "EXACT_RUN_BYTES", run * 4 * tk * f * 4)
    assert moe.exact_run(tk, jcfg.moe.num_experts, f) == run
    got = moe.grouped_ffn(tp, xt, torch.from_numpy(gs_np), "swiglu",
                          impl="ragged")
    assert torch.equal(got, one)
    want = np.asarray(jmoe.grouped_ffn(
        jp, jnp.asarray(xt.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bf16" else jnp.float32),
        jnp.asarray(gs_np), "swiglu", impl="ragged"))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=BF16_TOL if dtype == "bf16" else TOL)


@pytest.mark.parametrize("skew", [0.0, 2.0, 6.0])
@pytest.mark.parametrize("wide", [False, True])
def test_grouped_ffn_capacity_drops_the_reference_rows(skew, wide):
    """T*K >= 8192 rows take the capacity path under ``impl="auto"`` in
    both packages.  A router skewed towards expert 0 overflows it: the
    rows past its capacity are dropped, the same rows in both."""
    jcfg, _ = _cfgs()
    if wide:
        jcfg = _wide_moe(jcfg)
    m = jcfg.moe
    t = -(-moe.CAPACITY_THRESHOLD // m.top_k)
    jp, tp = _params(jcfg, 7, skew=skew)
    # tokens of positive mean: a skewed router sends them all to expert 0
    xs, gs = _sorted_rows(jp, _tokens(t, jcfg.d_model, 9) + 0.5, m)
    assert xs.shape[0] >= moe.CAPACITY_THRESHOLD == jmoe.CAPACITY_THRESHOLD
    want = np.asarray(jmoe.grouped_ffn(jp, jnp.asarray(xs), jnp.asarray(gs),
                                       "swiglu"))
    got = moe.grouped_ffn(tp, torch.from_numpy(xs), torch.from_numpy(gs),
                          "swiglu").numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    dropped = ~want.any(axis=1)
    np.testing.assert_array_equal(~got.any(axis=1), dropped)
    drops = int(moe.capacity_drops(torch.from_numpy(gs), xs.shape[0]))
    assert drops == int(dropped.sum())
    if skew >= 2.0:
        assert drops > 0
    # the exact path drops nothing
    exact = moe.grouped_ffn(tp, torch.from_numpy(xs), torch.from_numpy(gs),
                            "swiglu", impl="ragged").numpy()
    assert exact.any(axis=1).all()


@pytest.mark.parametrize("tokens", [(2, 9), (4, 1100)])
@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_moe_forward_matches_jax(tokens, skew):
    """(2, 9) tokens take the exact path, (4, 1100) at top 2 the capacity
    path (8800 rows); output and aux loss against ``moe_forward``."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, 9, skew=skew)
    b, s = tokens
    x = _tokens(b * s, jcfg.d_model, 11)
    _routed(jp, x, jcfg.moe)
    x = x.reshape(b, s, -1)
    want, waux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_forward(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # the importance sums thousands of fp32 probabilities in another order
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-6)


def test_moe_forward_with_shared_experts_matches_jax():
    """``_moe_local``'s shared experts (deepseek's; none in granite)."""
    import dataclasses
    jcfg, cfg = _cfgs()
    jm = dataclasses.replace(jcfg.moe, num_shared_experts=1, d_ff_shared=32)
    jcfg = dataclasses.replace(jcfg, moe=jm)
    cfg = dataclasses.replace(cfg, moe=jm)
    jp = jmoe.init_moe(jax.random.PRNGKey(11), jcfg, jnp.float32)
    tp = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jp)
    x = _tokens(12, jcfg.d_model, 12)
    _routed(jp, x, jcfg.moe)
    want, waux = jmoe.moe_forward(jp, jnp.asarray(x[None]), jcfg)
    got, aux = moe.moe_forward(tp, torch.from_numpy(x[None]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_moe_forward_refuses_a_mesh():
    """The MoE runs over a mesh (``tests/test_torch_mesh.py``); expert
    parallelism refuses one whose model axis does not divide the experts,
    as the reference's asserts (a fake process group of 3 ranks in this
    process, destroyed after)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import from_mesh
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32, "cpu")
    assert cfg.moe.num_experts % 3
    dist.init_process_group("fake", store=FakeStore(), world_size=3, rank=0)
    try:
        ctx = from_mesh(make_mesh((1, 3), ("data", "model"),
                                  device_type="cpu"))
        with pytest.raises(ValueError, match="num_experts % tp"):
            moe.moe_forward_ep(p, torch.zeros(1, 2, cfg.d_model), cfg, ctx)
    finally:
        dist.destroy_process_group()


def test_router_stays_fp32_under_bf16_weights():
    from repro.models.model import Model as JaxModel
    jcfg, cfg = _cfgs()
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0),
                                               jnp.bfloat16)
    assert jparams["blocks"][0]["moe"]["router"].dtype == jnp.float32
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", dtype=torch.bfloat16)
    own = Model(cfg, device="cpu").init(seed=0, dtype=torch.bfloat16)
    for tree in (params, own):
        for lp in tree["blocks"]:
            assert lp["moe"]["router"].dtype == torch.float32
            assert lp["moe"]["w_gate"].dtype == torch.bfloat16
            assert lp["moe"]["w_gate"].shape == (
                cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
        assert tree["embed"].dtype == torch.bfloat16


# ------------------------------------------------ bf16: fp32 products
BF16_TOL = 1e-5        # fp32 rounding at |y| of about 3


def _bf16(tree):
    return jax.tree.map(lambda v: jnp.asarray(v).astype(jnp.bfloat16)
                        if jnp.asarray(v).dtype == jnp.float32 else v, tree)


def _experts_bf16(jcfg, seed):
    """The expert weights in bf16 (the router stays fp32, as the
    reference creates it), in both packages."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.bfloat16)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("groups", [
    "routed",                  # granite reduced: 12 tokens x top 2
    "empty",                   # an expert with no rows
    "wide",                    # 32 experts top 8: groups of 0-7 rows
])
def test_grouped_ffn_bf16_products_in_fp32_match_jax(groups):
    """bf16 rows and experts: the gate, up and down products in fp32 from
    bf16 operands, as ``ragged_dot(..., preferred_element_type=f32)``.
    Products rounded to bf16 (the fault this repairs) were about 0.015
    off at these shapes."""
    jcfg, _ = _cfgs()
    if groups == "wide":
        jcfg = _wide_moe(jcfg)
    jp, tp = _experts_bf16(jcfg, 13)
    m = jcfg.moe
    if groups == "empty":
        gs = np.array([10, 0, 8, 6], np.int32)
        xs = _tokens(int(gs.sum()), jcfg.d_model, 14)
    else:
        xs, gs = _sorted_rows(jp, _tokens(12, jcfg.d_model, 15), m)
    assert (gs == 0).any() == (groups == "empty")
    xb = jnp.asarray(xs).astype(jnp.bfloat16)
    want = np.asarray(jmoe.grouped_ffn(jp, xb, jnp.asarray(gs), "swiglu",
                                       impl="ragged"))
    assert want.dtype == np.float32
    got = moe.grouped_ffn(tp, torch.from_numpy(np.array(
        xb.astype(jnp.float32))).to(torch.bfloat16), torch.from_numpy(gs),
        "swiglu", impl="ragged")
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL)


def test_moe_local_bf16_matches_jax():
    """``_moe_local`` (the fp32 sum ``moe_forward`` rounds to bf16) and
    ``moe_forward`` itself on bf16 tokens and experts: the fp32 output to
    fp32 rounding, the bf16 output to one bf16 rounding of it."""
    jcfg, cfg = _cfgs()
    jp, tp = _experts_bf16(jcfg, 16)
    x = _tokens(2 * 9, jcfg.d_model, 17)
    _routed(jp, x, jcfg.moe)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    want, _, _ = jmoe._moe_local(jp, xb, jcfg)
    got, _, _ = moe._moe_local(tp, xt, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_TOL)
    jout, _ = jmoe.moe_forward(jp, xb.reshape(2, 9, -1), jcfg)
    tout, _ = moe.moe_forward(tp, xt.reshape(2, 9, -1), cfg)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=BF16_TOL)
