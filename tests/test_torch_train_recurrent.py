"""forward_train's loss and gradients against the JAX package's for the
ssm and hybrid families (falcon-mamba-7b, recurrentgemma-2b); the impls, tolerances and measurements are
``_train_parity.py``'s."""
import pytest

from _train_parity import JAX_IMPL, check_forward_train

ARCHS = ['falcon-mamba-7b', 'recurrentgemma-2b']


@pytest.mark.parametrize("impl", list(JAX_IMPL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch, impl):
    check_forward_train(arch, impl)
