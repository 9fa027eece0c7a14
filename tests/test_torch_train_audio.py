"""forward_train's loss and gradients against the JAX package's for the
audio family (whisper-tiny), and two train-mode branches no family's S 16
case reaches; the impls, tolerances and measurements are
``_train_parity.py``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _train_parity import (GRAD_REL, JAX_IMPL, LOSS_TOL, batch_of, check_forward_train,
                           port_loss_and_grads, rel_l2, weights)
from repro.models import get_model as jax_get_model

ARCHS = ['whisper-tiny']


@pytest.mark.parametrize("impl", list(JAX_IMPL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch, impl):
    check_forward_train(arch, impl)


@pytest.mark.parametrize("arch,over,seq", [
    ("qwen1.5-4b", {"logits_chunk": 4}, 16),       # lm_loss's chunked logits
    ("falcon-mamba-7b", {}, 256),                   # the chunked log-step scan
], ids=["logits_chunk", "mamba_chunked_scan"])
def test_train_paths_of_longer_shapes_match_jax(arch, over, seq):
    """Two train-mode branches the per-family parity (S 16) does not
    reach: ``cfg.logits_chunk`` and the ssm family's chunked scan (S a
    multiple of 256), against ``jax.value_and_grad``.  Measured: the loss
    within 9.5e-7, the leaves within 1.1e-5 rel L2; held as above."""
    jcfg, jp, tcfg = weights(arch)
    jcfg, tcfg = dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)
    batch = batch_of(jcfg, b=1, s=seq)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_get_model(jcfg).forward_train),
                            static_argnums=2)(jp, {k: jnp.asarray(v) for k, v in
                                                    batch.items()}, jcfg)
    loss, grads = port_loss_and_grads(tcfg, jax.tree_util.tree_map(np.asarray, jp), batch)
    assert abs(loss - float(jloss)) <= LOSS_TOL
    for g, j in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        assert rel_l2(g, j) <= GRAD_REL
