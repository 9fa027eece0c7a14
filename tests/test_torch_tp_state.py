"""Checkpoints and ZeRO-1 under tensor parallelism, one rank against
the world, on gloo worlds of CPU ranks with reduced qwen1.5-4b in
float32: a state saved on (data 1, model 2) after a train step and
restored on one rank gives the world's leaves bitwise; on (data 2,
model 2) the loss is held 1e-5 against the JAX step's, the gradients
1e-4 relative L2 a leaf against one rank's, and ZeRO-1's parameters
bitwise the replicated update's."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import _mesh_ranks as ranks
from _mesh_parity import GRAD_REL, LOSS_TOL, rel_l2
from _tp_parity import make_case
from repro import train as jtrain
from repro.models import get_model as jax_get_model
from repro_torch.ckpt import restore_checkpoint
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.launch.mesh import fresh_store, spawn_world
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.train.step import loss_and_grads, state_spec


def test_checkpoint_under_tensor_parallelism_restores_on_one_rank(tmp_path):
    """A state saved on (data 1, model 2) after a train step, restored on
    one rank: every leaf bitwise the world's gathered leaf."""
    case, _, _ = make_case("ckpt", "qwen1.5-4b")
    cfg = case["cfg"]
    res = spawn_world(ranks.tp_checkpoint, 2, "cpu", fresh_store(),
                      (cfg, case["params"], case["train"], str(tmp_path / "ckpt")))
    assert res[0]["sliced"][2] == cfg.n_heads // 2
    like = tparams.materialize(state_spec(cfg, get_model(cfg).param_spec(cfg)),
                               torch.Generator().manual_seed(1), torch.float32, "cpu")
    restored, extra = restore_checkpoint(tmp_path / "ckpt", 1, like)
    assert extra["data_cursor"] == 1
    for r in res:
        for a, b in zip(tparams.tree_leaves(restored), tparams.tree_leaves(r["whole"])):
            assert torch.equal(a, b)


def test_zero1_under_tensor_parallelism_is_the_replicated_update(tmp_path):
    """Reduced qwen1.5-4b on (data 2, model 2): the loss against the JAX
    step's, the gradients against one rank's, ZeRO-1's parameters bitwise
    the replicated update's."""
    case, jcfg, jp = make_case("zero1", "qwen1.5-4b")
    tcfg = case["cfg"]
    batch = next(SyntheticTokens(tcfg, 4, 16, seed=1))
    res = spawn_world(ranks.dp_world, 4, "cpu", fresh_store(),
                      ((2, 2), ("data", "model"), tcfg, case["params"], batch))
    japi = jax_get_model(jcfg)
    jstate = {"params": jp, "opt": jax.tree_util.tree_map(jnp.zeros_like, {"m": jp, "v": jp}),
              "step": jnp.int32(0)}
    _, jm = jax.jit(jtrain.make_train_step(jcfg, japi))(
        jstate, {"tokens": jnp.asarray(batch["tokens"])})
    params = tparams.load_jax_params(case["params"], tcfg, "cpu")
    _, grads = loss_and_grads(get_model(tcfg), tcfg, params, to_device(batch, "cpu"))
    for r in res:
        assert abs(r["loss"] - float(jm["loss"])) < LOSS_TOL
        for a, b in zip(r["grads"], grads):
            assert rel_l2(a, b) < GRAD_REL
        assert r["bitwise"], "ZeRO-1's parameters differ from the replicated update's"
        assert np.prod(r["m_shape_zero1_False"]) == 2 * np.prod(r["m_shape_zero1_True"])
    for a, b in zip(tparams.tree_leaves(res[0]["params"]), tparams.tree_leaves(res[-1]["params"])):
        assert torch.equal(a, b)
