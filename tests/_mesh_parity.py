"""Helpers of the mesh parity tests, in the parent test process only (the
ranks import ``_mesh_ranks``): configs and JAX weights as numpy, the
tolerances, relative L2."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs

LOGIT_TOL, EP_TOL, LOSS_TOL, GRAD_REL = 1e-4, 1e-5, 1e-5, 1e-4


def configs(arch):
    return tconfigs.reduced(tconfigs.get_config(arch)), jconfigs.reduced(jconfigs.get_config(arch))


def jax_params(jcfg, seed=0):
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1), jax.random.PRNGKey(seed),
                             jnp.float32)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def rel_l2(a, b) -> float:
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float(torch.linalg.vector_norm(a - b) / max(torch.linalg.vector_norm(b), 1e-30))
