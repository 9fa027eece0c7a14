"""Data parallelism and ZeRO-1 of the port's train step on gloo worlds of
CPU ranks: reduced qwen1.5-4b in float32, the global batch 4 x 16 split
over the batch axes of a (data 2) mesh and of a (pod 2, data 1, model 2)
one.  Tolerances: the loss 1e-5 against the JAX package's
``make_train_step`` loss and the port's one-rank loss; the batch-averaged
gradients 1e-4 relative L2 a leaf against the port's one-rank gradients
(AdamW's first step moves each weight by about lr x sign(g), so the
parameters after it would hide a gradient error: the gradients are held
themselves); ZeRO-1's parameters after the step bitwise the replicated
update's on the same gradients."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _mesh_ranks as ranks
from _mesh_parity import GRAD_REL, LOSS_TOL, configs, jax_params, rel_l2
from repro import train as jtrain
from repro.models import get_model as jax_get_model
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.train.step import loss_and_grads


@pytest.mark.parametrize("shape,axes", [((2, 1), ("data", "model")),
                                        ((2, 1, 2), ("pod", "data", "model"))],
                         ids=["data2", "pod2-data1-model2"])
def test_data_parallel_and_zero1(tmp_path, shape, axes):
    """Reduced qwen1.5-4b, global batch 4 x 16 split over the batch axes."""
    tcfg, jcfg = configs("qwen1.5-4b")
    japi = jax_get_model(jcfg)
    jp, np_params = jax_params(jcfg)
    batch = next(SyntheticTokens(tcfg, 4, 16, seed=1))
    world = int(np.prod(shape))
    res = spawn_world(ranks.dp_world, world, "cpu", tmp_path / "store",
                      (shape, axes, tcfg, np_params, batch))

    jstate = {"params": jp, "opt": jax.tree_util.tree_map(
        jnp.zeros_like, {"m": jp, "v": jp}), "step": jnp.int32(0)}
    _, jm = jax.jit(jtrain.make_train_step(jcfg, japi))(
        jstate, {"tokens": jnp.asarray(batch["tokens"])})
    jloss = float(jm["loss"])
    params = tparams.load_jax_params(np_params, tcfg, "cpu")
    loss, grads = loss_and_grads(get_model(tcfg), tcfg, params, to_device(batch, "cpu"))
    for r in res:
        assert abs(r["loss"] - jloss) < LOSS_TOL and abs(r["loss"] - float(loss)) < LOSS_TOL
        assert abs(r["step_loss_zero1_True"] - r["loss"]) < 1e-6
        for a, b in zip(r["grads"], grads):
            assert rel_l2(a, b) < GRAD_REL
        assert r["bitwise"], "ZeRO-1's parameters differ from the replicated update's"
        whole = r["m_shape_zero1_False"]
        sliced = r["m_shape_zero1_True"]
        assert np.prod(whole) == 2 * np.prod(sliced)  # m halved over the 2 batch ranks
        assert r["stats"]["all_gather"][0] > 0
    for a, b in zip(tparams.tree_leaves(res[0]["params"]), tparams.tree_leaves(res[-1]["params"])):
        assert torch.equal(a, b)  # every rank holds the same parameters


