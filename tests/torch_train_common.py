"""Shared parts of the training parity tests (``test_torch_train_*.py``):
the batch, the JAX and port runs at ``.reduced()`` in fp32 on the CPU, and
the gradient check (each leaf within 1e-4 of ``max(1, max|g|)``).
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model
from repro_torch.training.train_loop import value_and_grad

ARCHS = ASSIGNED_ARCHS + ["llama3-70b"]
# the dense-cache families (MLA, SSD, the hybrid), in a file of their own
DENSE_ARCHS = ["deepseek-v2-lite-16b", "mamba2-370m",
               "jamba-1.5-large-398b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b",
             "jamba-1.5-large-398b"]
TOL = 1e-4


def _batch(cfg, b=2, s=32):
    rng = np.random.default_rng(11)
    dec = max(int(s * cfg.dec_len_ratio), 8) if cfg.encdec else s
    out = {}
    if cfg.frontend == "embed" and not cfg.encdec:
        out["inputs"] = rng.normal(size=(b, dec, cfg.d_model)).astype(
            np.float32)
    else:
        out["inputs"] = rng.integers(0, cfg.vocab_size, (b, dec)).astype(
            np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, dec)).astype(np.int32)
    if cfg.encdec:
        out["enc_embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return out


def jax_run(arch):
    jcfg = jax_get_config(arch).reduced()
    jm = JaxModel(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    batch = _batch(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, jp), batch, float(loss),
            jax.tree.map(np.asarray, grads))


def port_run(arch, jp, batch, remat=False):
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu", remat=remat)
    params = params_from_numpy(jp, cfg, device="cpu", dtype=torch.float32)
    loss, _, grads = value_and_grad(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), params_to_numpy(grads, cfg)


def check_grads(got, want):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        g = flat_g[path]
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        bound = TOL * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


_JAX = {}


def jax_cached(arch):
    if arch not in _JAX:
        _JAX[arch] = jax_run(arch)
    return _JAX[arch]


def check_loss_and_gradients(arch):
    jp, batch, want_loss, want_grads = jax_cached(arch)
    loss, grads = port_run(arch, jp, batch)
    assert abs(loss - want_loss) <= TOL
    check_grads(grads, want_grads)


def check_remat(arch):
    jp, batch, _, _ = jax_cached(arch)
    loss0, grads0 = port_run(arch, jp, batch, remat=False)
    loss1, grads1 = port_run(arch, jp, batch, remat=True)
    assert loss1 == loss0
    for a, b in zip(jax.tree.leaves(grads1), jax.tree.leaves(grads0)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
