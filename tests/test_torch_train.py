"""The port's training substrate: the train step against the JAX step,
AdamW and its schedule against the JAX package's, microbatching, the remat
policies, and the counterparts of tests/test_train.py's six tests (the
zero1 one becomes "zero1 raises": the ZeRO-1 spec, and its update refused
without the device mesh it slices over).

Reduced configs in float32 on the CPU; a JAX state is loaded leaf for
leaf.  Tolerances, each with what was measured (qwen1.5-4b and
arctic-480b, 1 and 2 microbatches):
- one step's loss: 1e-5 (measured 0 to 9.5e-7);
- m and v: 1e-3 relative L2 a leaf (measured up to 2.9e-5: XLA and
  PyTorch order float32 sums differently);
- the parameters: 1e-5 absolute (measured up to 1.6e-6).  AdamW's first
  step moves each weight by lr * g / (|g| + eps), about lr times the
  gradient's sign, so a gradient near 0 whose sign differs between the two
  sums moves by up to 2 lr (6e-6 at the default schedule's step 0).
- AdamW alone on equal inputs: 1e-6 relative (float32 rounding)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import optim as joptim
from repro import train as jtrain
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.train import make_train_step, state_spec
from repro_torch.train.step import loss_and_grads

LOSS_TOL, MV_REL, PARAM_ATOL, ADAM_REL = 1e-5, 1e-3, 1e-5, 1e-6
LR = {"peak": 1e-3, "warmup": 5, "decay_steps": 10_000}


def build(arch="granite-34b", **over):
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), **over)
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    return cfg, api, tparams.materialize(state_spec(cfg, api.param_spec(cfg)), gen,
                                         torch.float32, "cpu")


def clone(tree):
    return tparams.tree_map(torch.clone, tree)


def jax_state(arch, **over):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)), **over)
    japi = jax_get_model(jcfg)
    st = jparams.materialize(jtrain.state_spec(jcfg, japi.param_spec(jcfg, 1)),
                             jax.random.PRNGKey(0), jnp.float32)
    return jcfg, japi, st


def port_state(jst, tcfg):
    """The JAX state in the port: params by load_jax_params, m, v and step
    as they are."""
    npst = jax.tree_util.tree_map(np.asarray, jst)
    return {"params": tparams.load_jax_params(npst["params"], tcfg, "cpu"),
            "opt": {k: tparams.tree_map(lambda a: torch.from_numpy(np.array(a)), npst["opt"][k])
                    for k in ("m", "v")},
            "step": torch.tensor(int(npst["step"]), dtype=torch.int32)}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "arctic-480b"])
def test_train_step_matches_jax_step(arch, microbatches):
    """One make_train_step step from the same state and batch: loss, then
    params, m, v and step leaf for leaf."""
    jcfg, japi, jst = jax_state(arch, microbatches=microbatches)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                               microbatches=microbatches)
    st = port_state(jst, tcfg)
    batch = next(SyntheticTokens(tcfg, 4, 16, seed=5))
    jnew, jm = jax.jit(jtrain.make_train_step(jcfg, japi))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = make_train_step(tcfg, get_model(tcfg))(st, to_device(batch, "cpu"))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert int(new["step"]) == int(jnew["step"]) == 1
    for name in ("m", "v"):
        for got, want in zip(tparams.tree_leaves(new["opt"][name]),
                             jax.tree_util.tree_leaves(jnew["opt"][name])):
            assert rel_l2(got, want) <= MV_REL, name
    for got, want in zip(tparams.tree_leaves(new["params"]),
                         jax.tree_util.tree_leaves(jnew["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PARAM_ATOL, rtol=0)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (3,)}
    mk = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.normal(size=s).astype(np.float32) * 3 for k, s in shapes.items()}
    m = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    v = {k: np.abs(rng.normal(size=s)).astype(np.float32) * 0.01 for k, s in shapes.items()}
    step = 3
    lr = float(joptim.lr_schedule(jnp.int32(step), **LR))
    jp, jopt = joptim.adamw_update({k: jnp.asarray(x) for k, x in mk.items()},
                                   {k: jnp.asarray(x) for k, x in g.items()},
                                   {"m": {k: jnp.asarray(x) for k, x in m.items()},
                                    "v": {k: jnp.asarray(x) for k, x in v.items()}},
                                   jnp.int32(step), lr=lr)
    t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}  # noqa: E731
    tp, topt = toptim.adamw_update(t(mk), t(g), {"m": t(m), "v": t(v)},
                                   torch.tensor(step, dtype=torch.int32), lr=lr)
    for k in shapes:
        assert rel_l2(tp[k], jp[k]) <= ADAM_REL
        assert rel_l2(topt["m"][k], jopt["m"][k]) <= ADAM_REL
        assert rel_l2(topt["v"][k], jopt["v"][k]) <= ADAM_REL


@pytest.mark.parametrize("step", [0, 3, 99, 100, 101, 5000, 12000])
def test_lr_schedule_matches_jax(step):
    kw = {"peak": 3e-4, "warmup": 100, "decay_steps": 10_000}
    assert float(toptim.lr_schedule(torch.tensor(step, dtype=torch.int32), **kw)) == \
        pytest.approx(float(joptim.lr_schedule(jnp.int32(step), **kw)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_policies_keep_the_gradients(remat, monkeypatch):
    """Each ``remat`` policy gives the gradients of no remat, bitwise on the
    CPU; under "full" and "dots" each layer's flash_attention forward runs
    again in the backward (its output is no product's), so the kernel runs
    layers x microbatches x 2 times a step, else x 1."""
    calls = []
    real = fa._dispatch
    monkeypatch.setattr(fa, "_dispatch", lambda *a: calls.append(1) or real(*a))
    cfg, api, state = build("qwen1.5-4b", kernel_impl="cuda", microbatches=2)
    batch = to_device(next(SyntheticTokens(cfg, 4, 32, seed=1)), "cpu")
    loss0, g0 = loss_and_grads(api, cfg, state["params"], batch)
    calls.clear()
    loss, g = loss_and_grads(api, dataclasses.replace(cfg, remat=remat), state["params"], batch)
    assert len(calls) == cfg.n_layers * 2 * (1 if remat == "none" else 2)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))
    assert all(p.grad is None and not p.requires_grad
               for p in tparams.tree_leaves(state["params"]))


# ------------------------------------------- counterparts of test_train.py


def test_loss_decreases_over_steps():
    cfg, api, state = build()
    step = make_train_step(cfg, api, lr_kwargs=LR)
    losses = []
    for _, batch in zip(range(30), SyntheticTokens(cfg, 8, 32, seed=3)):
        state, m = step(state, to_device(batch, "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_microbatch_grad_accum_matches_full_batch():
    cfg1, api, state1 = build(microbatches=1)
    cfg4 = dataclasses.replace(cfg1, microbatches=4)
    state4 = clone(state1)
    batch = to_device(next(SyntheticTokens(cfg1, 8, 16, seed=5)), "cpu")
    s1, m1 = make_train_step(cfg1, api)(state1, batch)
    s4, m4 = make_train_step(cfg4, api)(state4, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in
            zip(tparams.tree_leaves(s1["params"]), tparams.tree_leaves(s4["params"])))
    assert d < 2e-4


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([4.0, -2.0])}
    opt = {"m": {"w": torch.zeros(2)}, "v": {"w": torch.zeros(2)}}
    for i in range(300):
        grads = {"w": 2 * params["w"]}  # d/dw ||w||^2
        params, opt = toptim.adamw_update(params, grads, opt, torch.tensor(i), lr=0.05,
                                          weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


def test_lr_schedule_warmup_and_decay():
    lr = lambda s: float(toptim.lr_schedule(torch.tensor(s), peak=1.0, warmup=10,  # noqa: E731
                                            decay_steps=100))
    assert lr(0) < 0.2
    assert lr(10) > 0.9
    assert lr(99) < 0.05


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    opt = {"m": {"w": torch.zeros(3)}, "v": {"w": torch.zeros(3)}}
    huge = {"w": torch.tensor([1e8, -1e8, 1e8])}
    p2, _ = toptim.adamw_update(params, huge, opt, torch.tensor(0), lr=0.1, grad_clip=1.0)
    assert float(p2["w"].abs().max()) < 1.0  # clipped, not exploded


def test_zero1_raises():
    """ZeRO-1 shards m and v over a mesh's batch axes: the spec gives
    "batch" to the largest divisible replicated dim (the reference's
    ``_zero1_spec``), a config's state spec builds, and the sliced update
    is refused without the mesh it slices over."""
    from repro_torch.models.params import Spec

    spec = toptim.adamw_init_spec({"w": Spec((64, 128), pspec=(None, "model"))},
                                  zero1=True, data_par=16)
    assert spec["m"]["w"].pspec == ("batch", "model")
    cfg = tconfigs.get_config("arctic-480b")
    assert cfg.zero1
    sspec = state_spec(cfg, get_model(cfg).param_spec(cfg, 16), 16)
    assert "batch" in sspec["opt"]["m"]["layers"]["experts"]["w_up"].pspec
    params = {"w": torch.zeros(4)}
    opt = {"m": {"w": torch.zeros(2)}, "v": {"w": torch.zeros(2)}}
    with pytest.raises(ValueError, match="zero1"):
        toptim.adamw_update(params, {"w": torch.ones(4)}, opt, torch.tensor(0), lr=0.1,
                            zero1_dims=[0])

