"""Shared by ``test_torch_train_{parity,recurrent,audio}.py``: the port's
train loss and gradients against the JAX package's, family by family:
``forward_train`` and every gradient leaf against
``jax.value_and_grad(api.forward_train)``, reduced configs in float32 with
JAX parameters loaded by ``load_jax_params``, numpy-seeded batches.

The port's "reference" is held against the JAX "reference", the port's
"cuda" (CPU tensors: ``flash_attention``'s Function on its plain version,
the rest the reference computations) against the JAX "pallas_interpret",
whose only differentiable kernel is ``flash_attention`` -- except
recurrentgemma-2b, whose Pallas ``rglru_scan`` has no VJP, so its "cuda"
is held against the JAX "reference" (the JAX package cannot train through
that kernel).  Measured: the loss within 1.5e-6 and each leaf within
1.5e-4 relative L2 (whisper-tiny's decoder; the others under 6e-5);
held at 1e-5 and 1e-3 (XLA and PyTorch order float32 sums differently,
through ~10 products and softmaxes)."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.models import get_model
from repro_torch.models import params as tparams

LOSS_TOL = 1e-5
GRAD_REL = 1e-3
# JAX kernel_impl each port impl is held against (see the module's docstring).
JAX_IMPL = {"reference": "reference", "cuda": "pallas_interpret"}
NO_JAX_VJP = {"recurrentgemma-2b"}


def weights(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1), jax.random.PRNGKey(0),
                             jnp.float32)
    return jcfg, jp, tconfigs.reduced(tconfigs.get_config(arch))


def batch_of(cfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def port_loss_and_grads(tcfg, np_params, batch):
    params = tparams.load_jax_params(np_params, tcfg, "cpu")
    leaves = tparams.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = get_model(tcfg).forward_train(params, {k: torch.from_numpy(v) for k, v in
                                                  batch.items()}, tcfg)
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def check_forward_train(arch, impl):
    """The loss and every gradient leaf of one arch under one port impl."""
    jcfg, jp, tcfg = weights(arch)
    jimpl = "reference" if arch in NO_JAX_VJP else JAX_IMPL[impl]
    jcfg = dataclasses.replace(jcfg, kernel_impl=jimpl)
    batch = batch_of(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_get_model(jcfg).forward_train),
                            static_argnums=2)(jp, {k: jnp.asarray(v) for k, v in
                                                    batch.items()}, jcfg)
    loss, grads = port_loss_and_grads(dataclasses.replace(tcfg, kernel_impl=impl),
                                      jax.tree_util.tree_map(np.asarray, jp), batch)
    assert abs(loss - float(jloss)) <= LOSS_TOL
    # jax.tree_util and the port flatten dicts in the same sorted-key order.
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for path, g, j in zip(paths, grads, jleaves):
        assert g.shape == j.shape, path
        assert rel_l2(g, j) <= GRAD_REL, (path, rel_l2(g, j))
