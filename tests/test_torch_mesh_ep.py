"""Expert parallelism on a gloo world of 4 CPU ranks (``spawn_world``):
reduced kimi-k2-1t-a32b on (data 2, model 2), ``moe_ffn_ep`` on
``moe_gemm``'s plain version, against the JAX package's rank-local and
unsharded functions (computed here, in the parent; the ranks import no
JAX) and the port's one-rank run, in float32.  Tolerances:
- a rank's partial: 1e-5 against the reference's ``_route`` plus
  ``_dispatch_compute_combine`` on its inputs, drops included; the summed
  output 1e-5 against the sum of the reference's partials;
- the loss at no-drop capacity (factor 100): 1e-5 against the JAX
  unsharded ``forward_train``; the gradients 1e-4 relative L2 a leaf
  against the port's one-rank gradients;
- two expert-parallel train steps at no-drop capacity, the dense leaves
  tensor-parallel: the clip's global norm, and the norm of the leaves
  sliced over "model" alone, 1e-5 relative, each step's gradients 1e-4
  relative L2 a leaf against the port's one-rank gradients at the
  parameters that step started from, the parameters 1e-4 against one
  rank's AdamW over the world's gradients, and every leaf equal bitwise
  on every rank (the leaves a model rank holds whole must not drift
  apart)."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import _mesh_ranks as ranks
from _mesh_parity import EP_TOL, GRAD_REL, LOSS_TOL, configs, jax_params, rel_l2
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.optim.adamw import adamw_update, global_norm, lr_schedule
from repro_torch.train import state_spec
from repro_torch.train.step import loss_and_grads


# The peak learning rate reached at the first step, so that two steps
# move the parameters by far more than a float32 ulp.
LR_KWARGS = {"peak": 1e-2, "warmup": 1}


def by_coord(results, key):
    return {tuple(r["coord"].values()): r[key] for r in results}


def test_expert_parallel_moe(tmp_path, monkeypatch):
    """Reduced kimi-k2-1t-a32b on (data 2, model 2): each rank holds 2 of
    4 experts."""
    tcfg, jcfg = configs("kimi-k2-1t-a32b")
    tcfg, jcfg = (dataclasses.replace(c, ep_shard_map=True) for c in (tcfg, jcfg))
    jp, np_params = jax_params(jcfg)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(8, 8, tcfg.d_model)).astype(np.float32)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (4, 16)).astype(np.int32)}
    res = spawn_world(ranks.ep_world, 4, "cpu", tmp_path / "store",
                      (tcfg, np_params, h, batch))

    E, K = jcfg.n_experts, jcfg.top_k
    e_loc = E // 2
    lp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    want = {}
    for d in (0, 1):
        x = jnp.asarray(h[4 * d:4 * (d + 1)].reshape(-1, jcfg.d_model))
        for r in (0, 1):
            fids, fw, tok = jmoe._route(x, lp["router"], E, K)
            mine = (fids // e_loc) == r
            fw = jnp.where(mine, fw, 0.0)
            fids = jnp.where(mine, fids - r * e_loc, 0)
            ex = {k: v[r * e_loc:(r + 1) * e_loc] for k, v in lp["experts"].items()}
            want[(d, r)] = np.asarray(jmoe._dispatch_compute_combine(
                x, fids, fw, tok, ex, e_loc, jmoe.capacity(x.shape[0], jcfg)))
    part, whole = by_coord(res, "partial"), by_coord(res, "whole")
    for c, w in want.items():
        np.testing.assert_allclose(part[c].numpy(), w, atol=EP_TOL, rtol=EP_TOL)
        d = c[0]
        summed = (want[(d, 0)] + want[(d, 1)]).reshape(4, 8, -1)
        np.testing.assert_allclose(whole[c].numpy(), summed, atol=EP_TOL, rtol=EP_TOL)
    assert sum(r["drops"] for r in res) > 0  # the reference's drops were in play
    assert all(r["expert_shape"] == (e_loc, tcfg.d_model, tcfg.d_ff) for r in res)

    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", 100.0)
    jloss = float(jax_get_model(jcfg).forward_train(jp, {"tokens": jnp.asarray(batch["tokens"])},
                                                    jcfg))
    for r in res:
        assert abs(r["loss"] - jloss) < LOSS_TOL, (r["loss"], jloss)

    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", 100.0)
    one_cfg = dataclasses.replace(tcfg, ep_shard_map=False)
    params = tparams.load_jax_params(np_params, one_cfg, "cpu")
    loss, grads = loss_and_grads(get_model(one_cfg), one_cfg, params, to_device(batch, "cpu"))
    assert abs(float(loss) - jloss) < LOSS_TOL
    for r in res:
        for a, b in zip(r["grads"], grads):
            assert rel_l2(a, b) < GRAD_REL


def test_expert_parallel_train_steps(tmp_path, monkeypatch):
    """Two train steps of reduced kimi-k2-1t-a32b on (data 2, model 2) at
    capacity factor 100, each model rank holding 2 of 4 experts and a
    slice of every dense leaf: the clip covers every sliced gradient, not
    only the rank's.  Each step's gradients are held against one rank's
    at GRAD_REL, at the parameters the step started from (the world's own
    after the first step, whole and bitwise equal on every rank); the
    parameters after the two steps against one rank's AdamW over the
    world's own gradients, since AdamW's first steps move a weight by
    about lr x sign(g) and a gradient near zero, summed in another order
    by the tensor-parallel ranks, may change sign."""
    tcfg, jcfg = configs("kimi-k2-1t-a32b")
    _, np_params = jax_params(jcfg)
    ds = SyntheticTokens(tcfg, 4, 16, seed=2)
    batches = [next(ds), next(ds)]
    res = spawn_world(ranks.ep_train, 4, "cpu", tmp_path / "store",
                      (tcfg, np_params, batches, LR_KWARGS))

    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", 100.0)
    api = get_model(tcfg)
    state = tparams.materialize(state_spec(tcfg, api.param_spec(tcfg)),
                                torch.Generator().manual_seed(0), torch.float32, "cpu")
    state["params"] = tparams.load_jax_params(np_params, tcfg, "cpu")
    after_first = res[0]["step_params"][0]
    for r in res:
        for a, b in zip(tparams.tree_leaves(r["step_params"][0]),
                        tparams.tree_leaves(after_first)):
            assert torch.equal(a, b), r["coord"]
    wants = [loss_and_grads(api, tcfg, start, to_device(b, "cpu"))[1]
             for start, b in zip([state["params"], after_first], batches)]
    grads = wants[0]
    norm = float(global_norm(grads))
    for r in res:
        assert len(r["step_grads"]) == len(batches)
        for i, want_i in enumerate(wants):
            for a, w in zip(r["step_grads"][i], want_i):
                assert rel_l2(a, w) < GRAD_REL, (i, r["coord"], rel_l2(a, w))
    for i, g in enumerate(res[0]["step_grads"]):
        grads_i = tparams.tree_unflatten(state["params"], g)
        adamw_update(state["params"], grads_i, state["opt"], torch.tensor(i),
                     lr=lr_schedule(torch.tensor(i), **LR_KWARGS))
    want = tparams.tree_leaves(state["params"])
    assert res[0]["sliced"] and all(r["sliced"] == res[0]["sliced"] for r in res)
    expert_norm = float(global_norm([grads[i] for i in res[0]["sliced"]]))
    for r in res:
        assert abs(r["norm"] - norm) < 1e-5 * norm, (r["coord"], r["norm"], norm)
        assert abs(r["expert_norm"] - expert_norm) < 1e-5 * expert_norm, r["coord"]
        got = tparams.tree_leaves(r["params"])
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-4
        for a, b in zip(got, tparams.tree_leaves(res[0]["params"])):
            assert torch.equal(a, b), r["coord"]
