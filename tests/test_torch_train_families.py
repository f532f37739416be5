"""The port's training loss and gradients against the JAX package's, for
the families of the attention paths.

For llama3-8b, gemma2-2b, gemma-7b, chatglm3-6b, granite-moe-1b-a400m,
seamless-m4t-medium, chameleon-34b and llama3-70b at ``.reduced()`` in
fp32 on the CPU, weights from ``PRNGKey(0)`` converted into the port:
``loss_fn`` within 1e-4 of the JAX model's, and every gradient leaf (back
in the JAX layout through ``params_to_numpy``) within 1e-4 of ``max(1,
max|g|)`` of ``jax.value_and_grad``'s; ``remat=True`` gives the port's
``remat=False`` loss and gradients.  deepseek, mamba2 and jamba are in
``test_torch_train_dense_families.py``, the MoE capacity path in
``test_torch_train_moe.py`` (each file kept to about a minute).
"""
import pytest

pytest.importorskip("torch")

from torch_train_common import (ARCHS, DENSE_ARCHS, check_loss_and_gradients,
                                check_remat)

FAMILIES = [a for a in ARCHS if a not in DENSE_ARCHS]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax(arch):
    check_loss_and_gradients(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_loss_and_gradients(arch):
    check_remat(arch)
