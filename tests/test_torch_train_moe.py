"""The MoE's capacity path in training, against the JAX package's.

granite-moe-1b-a400m, deepseek-v2-lite-16b and jamba-1.5-large-398b,
reduced, fp32, on the CPU, with the capacity threshold lowered in both
packages so the training batch's 128 rows a MoE layer take the capacity
path: each layer's group sizes (so the rows its capacity windows drop)
equal, then the loss within 1e-4 and every gradient leaf within 1e-4 of
``max(1, max|g|)``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.models import moe as jmoe

from repro_torch.models import moe
from torch_train_common import (MOE_ARCHS, TOL, check_grads, jax_run,
                                port_run)

LOW_THRESHOLD = 64


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_path_drops_and_gradients_match_jax(arch, monkeypatch):
    """T*K = 128 rows a MoE layer, above a threshold lowered to 64 in
    both packages: each layer's group sizes (so the rows its capacity
    windows drop) equal, then the loss and gradients."""
    monkeypatch.setattr(moe, "CAPACITY_THRESHOLD", LOW_THRESHOLD)
    monkeypatch.setattr(jmoe, "CAPACITY_THRESHOLD", LOW_THRESHOLD)
    seen_j, seen_t = [], []
    jcap, tcap = jmoe._grouped_ffn_capacity, moe._grouped_ffn_capacity

    def jwrap(p, xs, gs, mlp_kind, **kw):
        jax.debug.callback(lambda g: seen_j.append(np.asarray(g)), gs)
        return jcap(p, xs, gs, mlp_kind, **kw)

    def twrap(p, xs, gs, mlp_kind, **kw):
        seen_t.append(gs.numpy().copy())
        return tcap(p, xs, gs, mlp_kind, **kw)

    monkeypatch.setattr(jmoe, "_grouped_ffn_capacity", jwrap)
    monkeypatch.setattr(moe, "_grouped_ffn_capacity", twrap)
    jp, batch, want_loss, want_grads = jax_run(arch)
    jax.effects_barrier()
    loss, grads = port_run(arch, jp, batch)
    assert len(seen_t) == len(seen_j) > 0
    for gt, gj in zip(seen_t, seen_j):
        np.testing.assert_array_equal(gt, gj)
        tk = int(gt.sum())
        assert int(moe.capacity_drops(torch.from_numpy(gt), tk)) == int(
            moe.capacity_drops(torch.from_numpy(gj.astype(np.int64)), tk))
    assert tk >= LOW_THRESHOLD
    assert abs(loss - want_loss) <= TOL
    check_grads(grads, want_grads)
