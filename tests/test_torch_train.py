"""The port's training substrate against the JAX package's.

AdamW and its schedule (the reference's own three tests, and
``adamw_update`` leaf for leaf against JAX's on one converted tree),
``GradCompressor`` (equal int8 codes, the dequantized gradients and the
error state against JAX's, and its error-feedback property), checkpoints
(round trip, retention, shape checks), the data pipelines (``SyntheticLM``
arrays and ``RagAugmented`` tokens equal to JAX's), ``make_train_step``
with gradient accumulation and compression over 3 steps from converted
``PRNGKey(0)`` weights (losses and parameters within 1e-4 of JAX's), the
loss falling, and the launcher on the CPU.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.training import compression as jcomp
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jax_make_train_step

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model
from repro_torch.training import (AdamWConfig, GradCompressor,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint)
from repro_torch.training.checkpoint import latest_step
from repro_torch.training.data import DataConfig, RagAugmented, SyntheticLM
from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                            schedule, tree_leaves)
from repro_torch.training.train_loop import TrainState


# ------------------------------------------------- the reference's own
def test_adamw_single_param_matches_reference():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      grad_clip=1e9, warmup_steps=0, total_steps=10**9,
                      min_lr_frac=1.0)
    p = {"w": torch.tensor([1.0])}
    state = adamw_init(p)
    g = {"w": torch.tensor([0.5])}
    new_p, state, mets = adamw_update(p, g, state, cfg)
    # reference bias-corrected step: m_hat=g, v_hat=g^2 -> update = lr*sign
    expect = 1.0 - 0.1 * (0.5 / (0.5 + 1e-8))
    assert float(new_p["w"][0]) == pytest.approx(expect, abs=1e-5)


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                      total_steps=10**9, min_lr_frac=1.0, weight_decay=0.0)
    p = {"w": torch.zeros((4,))}
    state = adamw_init(p)
    g = {"w": torch.full((4,), 100.0)}
    _, _, mets = adamw_update(p, g, state, cfg)
    assert float(mets["grad_norm"]) == pytest.approx(200.0, rel=1e-4)


def test_schedule_warmup_and_cosine():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)


# --------------------------------------------------------- against JAX
def _jax_llama(seed=0, **kw):
    jcfg = jax_get_config("llama3-8b").reduced(**kw)
    jm = JaxModel(jcfg, remat=True)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.float32)
    cfg = get_config("llama3-8b").reduced(**kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    return jcfg, jm, jp, cfg, tp


def _assert_trees_close(got, want, atol, rtol=0.0):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w), atol=atol,
                                   rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


def test_adamw_update_matches_jax_leaf_for_leaf():
    """Two AdamW steps (clipping active, weight decay, warmup) on llama's
    reduced tree: every parameter, moment and master weight within 1e-6
    of JAX's; the grad norm and lr too."""
    _, _, jp, cfg, tp = _jax_llama()
    rng = np.random.default_rng(0)
    opt = AdamWConfig(lr=1e-2, grad_clip=0.5, warmup_steps=3,
                      total_steps=10, weight_decay=0.1)
    jstate, tstate = jopt.adamw_init(jp), adamw_init(tp)
    for _ in range(2):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
            np.float32) * 0.3, jax.tree.map(np.asarray, jp))
        jp, jstate, jm = jopt.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), jstate, opt)
        tg = params_from_numpy(g, cfg, device="cpu", dtype=torch.float32)
        tp, tstate, tm = adamw_update(tp, tg, tstate, opt)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    _assert_trees_close(params_to_numpy(tp, cfg), jp, atol=1e-6)
    for k in ("mu", "nu", "master"):
        _assert_trees_close(params_to_numpy(tstate[k], cfg), jstate[k],
                            atol=1e-6)


@pytest.mark.parametrize("n,block", [(1000, 256), (128, 32), (7, 64)])
def test_grad_compressor_matches_jax(n, block):
    """Equal int8 codes (JAX's recovered from its dequantized values and
    scales), equal dequantized gradients and error state, over two steps
    of error feedback."""
    rng = np.random.default_rng(n)
    jc, tc = jcomp.GradCompressor(block=block), GradCompressor(block=block)
    g = {"a": rng.normal(size=(n,)).astype(np.float32),
         "b": [rng.normal(size=(3, 5)).astype(np.float32) * 10]}
    jstate = jc.init_state(jax.tree.map(jnp.asarray, g))
    tstate = tc.init_state(jax.tree.map(torch.from_numpy, g))
    for step in range(2):
        gs = jax.tree.map(lambda x: x * (step + 1), g)
        jdeq, jnew = jc.apply(jax.tree.map(jnp.asarray, gs), jstate)
        tg = jax.tree.map(torch.from_numpy, gs)
        for tleaf, eleaf, jleaf, jerr in zip(
                tree_leaves(tg), tree_leaves(tstate), jax.tree.leaves(gs),
                jax.tree.leaves(jstate)):
            g32 = tleaf.float() + eleaf
            q, scale = tc.quantize(g32)
            # JAX's codes: its dequantized block over its scale
            jg32 = jnp.asarray(jleaf) + jerr
            flat = jnp.pad(jg32.reshape(-1), (0, -jg32.size % block))
            jscale = np.maximum(np.abs(np.asarray(flat)).reshape(
                -1, block).max(axis=1, keepdims=True) / 127.0, 1e-12)
            jq = np.clip(np.round(np.asarray(flat).reshape(-1, block)
                                  / jscale), -127, 127).astype(np.int8)
            np.testing.assert_array_equal(q.numpy(), jq)
            np.testing.assert_array_equal(scale.numpy(), jscale)
        tdeq, tnew = tc.apply(tg, tstate)
        for a, b in zip(tree_leaves(tdeq), jax.tree.leaves(jdeq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jstate, tstate = jnew, tnew


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(0.01, 100.0))
def test_compression_error_feedback_property(seed, scale):
    """Error feedback: deq(g) + err == g + old_err (no energy lost), and
    the quantization error is at most half a code step of its block."""
    r = np.random.default_rng(seed)
    comp = GradCompressor(block=32)
    g = {"w": torch.from_numpy((r.normal(size=(128,)) * scale).astype(
        np.float32))}
    state = comp.init_state(g)
    deq, new_state = comp.apply(g, state)
    lhs = deq["w"].numpy() + new_state["w"].numpy()
    rhs = g["w"].numpy() + state["w"].numpy()
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5, atol=1e-5)
    blk_max = np.abs(g["w"].numpy()).reshape(-1, 32).max(axis=1)
    bound = np.repeat(blk_max / 127.0, 32) * 0.5 + 1e-9
    assert (np.abs(new_state["w"].numpy()) <= bound + 1e-6).all()


def test_compression_reduces_bytes():
    comp = GradCompressor(block=256)
    params = {"w": torch.zeros((1024, 1024))}
    assert comp.compressed_bytes(params) < 1024 * 1024 * 4 / 3.5
    assert comp.compressed_bytes(params) == jcomp.GradCompressor(
        block=256).compressed_bytes({"w": jnp.zeros((1024, 1024))})


# --------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_retention():
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": [torch.ones((2,), dtype=torch.bfloat16),
                  {"c": torch.tensor(3, dtype=torch.int32)}]}
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, tree, keep=3)
        assert latest_step(d) == 5
        restored, step = load_checkpoint(d, tree)
        assert step == 5
        for x, y in zip(tree_leaves(restored), tree_leaves(tree)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.float().numpy(),
                                          y.float().numpy())
        steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert steps == ["step_00000003", "step_00000004", "step_00000005"]
        assert sorted(os.listdir(os.path.join(d, steps[-1]))) == [
            "meta.json", "shard_0000.ckpt"]
        bad = dict(tree, a=torch.zeros((4, 3)))
        with pytest.raises(ValueError, match="a"):
            load_checkpoint(d, bad)
        with pytest.raises(FileNotFoundError):
            load_checkpoint(os.path.join(d, "none"), tree)


def test_checkpoint_restores_a_train_state_exactly():
    """A model's params and AdamW state through a checkpoint: bit-equal
    leaves, and the next step from them equals the next step from the
    originals."""
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    model = Model(cfg, device="cpu")
    state = TrainState.create(model, seed=3, dtype=torch.float32)
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=1))
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticLM(
        cfg, DataConfig(batch=2, seq_len=16)))).items()}
    p, o, _, _ = step(state.params, state.opt_state, None, batch)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"p": p, "o": o})
        template = {"p": model.init(seed=9, dtype=torch.float32)}
        template["o"] = adamw_init(template["p"])
        tree, _ = load_checkpoint(d, template)
    for a, b in zip(tree_leaves(tree), tree_leaves({"p": p, "o": o})):
        assert torch.equal(a, b)
    p1, o1, _, m1 = step(p, o, None, batch)
    p2, o2, _, m2 = step(tree["p"], tree["o"], None, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


# --------------------------------------------------------- data
def test_synthetic_lm_matches_jax():
    cfg = get_config("llama3-8b").reduced()
    jcfg = jax_get_config("llama3-8b").reduced()
    dc = DataConfig(batch=3, seq_len=40, seed=5)
    ours = iter(SyntheticLM(cfg, dc))
    theirs = iter(jdata.SyntheticLM(jcfg, jdata.DataConfig(batch=3,
                                                           seq_len=40,
                                                           seed=5)))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for k in ("inputs", "labels"):
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_rag_augmented_tokens_match_jax():
    from repro.retrieval import HashEmbedder as JaxEmbedder
    from repro.retrieval import VectorStore as JaxStore
    from repro_torch.retrieval.embedding import HashEmbedder
    from repro_torch.retrieval.vectorstore import VectorStore
    cfg = get_config("llama3-8b").reduced()
    jcfg = jax_get_config("llama3-8b").reduced()
    from repro_torch.launch.serve import build_corpus
    # serving's corpus: short templated facts under a 32-wide hash embedder
    # tie exactly, and a tie may order ids either way
    texts = build_corpus(100)
    with tempfile.TemporaryDirectory() as r1, \
            tempfile.TemporaryDirectory() as r2:
        jemb, temb = JaxEmbedder(dim=32), HashEmbedder(dim=32)
        jstore = JaxStore.build(texts, jemb, num_partitions=4, root=r1)
        tstore = VectorStore.build(texts, temb, num_partitions=4, root=r2,
                                   device="cpu")
        ours = iter(RagAugmented(cfg, DataConfig(batch=3, seq_len=24),
                                 tstore, temb))
        theirs = iter(jdata.RagAugmented(
            jcfg, jdata.DataConfig(batch=3, seq_len=24), jstore, jemb))
        for _ in range(2):
            a, b = next(ours), next(theirs)
            assert a["inputs"].shape == (3, 24)
            for k in ("inputs", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------- train step
def test_train_step_matches_jax_with_accumulation_and_compression():
    """3 steps of ``make_train_step(grad_accum=2, compressor)`` from
    converted ``PRNGKey(0)`` weights: each step's loss within 1e-4 of
    JAX's, the parameters after them within 1e-4 (all but at most 0.1 %
    of a leaf's elements, which stay within 1e-3: see below)."""
    jcfg, jm, jp, cfg, tp = _jax_llama()
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=30)
    jc, tc = jcomp.GradCompressor(block=64), GradCompressor(block=64)
    jstep = jax.jit(jax_make_train_step(jm, opt, grad_accum=2,
                                        compressor=jc))
    tstep = make_train_step(Model(cfg, device="cpu", remat=True), opt,
                            grad_accum=2, compressor=tc)
    jo, jcs = jopt.adamw_init(jp), jc.init_state(jp)
    to, tcs = adamw_init(tp), tc.init_state(tp)
    data = iter(SyntheticLM(cfg, DataConfig(batch=4, seq_len=32)))
    for _ in range(3):
        batch = next(data)
        jp, jo, jcs, jm_ = jstep(jp, jo, jcs, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
        tp, to, tcs, tm = tstep(tp, to, tcs, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm_["loss"])) <= 1e-4
    # AdamW divides each element's step by sqrt(v): where |g| is near eps,
    # or where an int8 code sits at a rounding boundary, gradients equal
    # to fp32 noise still move the element apart (up to lr a step), so a
    # handful of elements may exceed 1e-4 (0.03 % of one leaf here)
    got = dict(jax.tree_util.tree_flatten_with_path(params_to_numpy(tp,
                                                                    cfg))[0])
    for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
        err = np.abs(got[path] - np.asarray(w))
        assert float(np.mean(err > 1e-4)) <= 1e-3, jax.tree_util.keystr(path)
        assert float(err.max()) <= 1e-3, jax.tree_util.keystr(path)


def test_training_reduces_loss():
    cfg = get_config("llama3-8b").reduced()
    model = Model(cfg, device="cpu", remat=True)
    comp = GradCompressor(block=64)
    st_ = TrainState.create(model, seed=0, dtype=torch.float32,
                            compressor=comp)
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=2,
                                              total_steps=30),
                           grad_accum=2, compressor=comp)
    data = iter(SyntheticLM(cfg, DataConfig(batch=4, seq_len=32)))
    p, o, c = st_.params, st_.opt_state, st_.comp_state
    losses = []
    for _ in range(8):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        p, o, c, m = step(p, o, c, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_launcher_trains_on_cpu_and_resumes(capsys, tmp_path):
    from repro_torch.launch import train
    args = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq-len",
            "16", "--log-every", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--compress-grads", "--grad-accum", "2"]
    train.main(args)
    out = capsys.readouterr().out
    assert "step     4 loss=" in out and "done." in out
    assert latest_step(str(tmp_path)) == 4
    train.main(args[:3] + ["6"] + args[4:] + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     6 loss=" in out
    # --mesh trains over a process group (tests/test_torch_mesh.py); one
    # process with no group to join says so
    with pytest.raises(RuntimeError, match="mesh"):
        train.main(["--device", "cpu", "--mesh", "2x2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--steps", "1"])
