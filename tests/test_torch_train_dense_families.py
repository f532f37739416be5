"""The port's training loss and gradients against the JAX package's for
the dense-cache families: deepseek-v2-lite-16b (MLA, the dense prefix,
shared experts), mamba2-370m (the SSD over the whole sequence) and
jamba-1.5-large-398b (the hybrid), reduced, fp32, on the CPU; the same
checks as ``test_torch_train_families.py``.
"""
import pytest

pytest.importorskip("torch")

from torch_train_common import (DENSE_ARCHS, check_loss_and_gradients,
                                check_remat)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    check_loss_and_gradients(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch):
    check_remat(arch)
