"""The train step as a CUDA graph (``make_train_step(graph=True)``), held
on the CPU.

- The host-read audit: every family's train step, under remat "dots"
  with 1 and 2 microbatches, runs once under a dispatch mode that raises
  on each op a CUDA graph's capture refuses (a read of a device value on
  the host, an output shaped by the data, a tensor made from host data:
  on the card a synchronous copy).
- The in-place contract: three steps leave every params, m, v and step
  leaf in the storage it had, with ``step == 3``.
- ``graph=True`` against ``graph=False``: bitwise, on CPU tensors (both
  eager) and through ``StepReplay``, a GraphCache that emulates the card's
  eager first step, capture (which executes nothing) and replays on the
  CPU.
- Three steps against the JAX package's jitted step, within
  tests/test_torch_train.py's tolerances.
- The graph's key.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import train as jtrain
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.kernels import _build
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import graphs
from repro_torch.train import make_train_step, state_spec
from repro_torch.train import step as tstep
from _host_reads import HostReadAudit
from test_torch_train import LOSS_TOL, MV_REL, PARAM_ATOL, jax_state, port_state, rel_l2

FAMILIES = ["qwen1.5-4b", "arctic-480b", "falcon-mamba-7b", "recurrentgemma-2b",
            "whisper-tiny", "paligemma-3b"]


def build(arch="qwen1.5-4b", **over):
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), **over)
    api = get_model(cfg)
    state = tparams.materialize(state_spec(cfg, api.param_spec(cfg)),
                                torch.Generator().manual_seed(0), torch.float32, "cpu")
    return cfg, api, state


def batches(cfg, n, b=2, s=8, seed=7):
    ds = SyntheticTokens(cfg, b, s, seed=seed)
    return [to_device(next(ds), "cpu") for _ in range(n)]


def leaves(state):
    return (tparams.tree_leaves(state["params"]) + tparams.tree_leaves(state["opt"]["m"])
            + tparams.tree_leaves(state["opt"]["v"]) + [state["step"]])


class StepReplay(graphs.GraphCache):
    """A GraphCache that "captures" on the CPU as the card does, running
    nothing; each replay runs the body on the static buffers (its launches
    going to a recording, as a replay's are not counted again) and hands
    back its outputs in the captured list."""

    @staticmethod
    def accepts(device):
        return True

    def _record(self, statics, run):
        outputs: list = []

        class Replay:
            @staticmethod
            def replay():
                with _build.recording():
                    outputs[:] = run(statics)

        return Replay(), outputs, {}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_reads_no_host(arch, microbatches):
    """Every family's step, remat "dots", the CUDA route's plain versions:
    no op of the second step reads the host.  The first runs unaudited, as
    on the card the first step of a graph's key runs eagerly before the
    capture: it fills the per-device caches (whisper's sinusoid table is
    copied to the device once)."""
    cfg, api, state = build(arch, remat="dots", microbatches=microbatches, kernel_impl="cuda")
    first, second = batches(cfg, 2)
    step = make_train_step(cfg, api)
    state, _ = step(state, first)
    with HostReadAudit():
        _, m = step(state, second)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("mode", ["cpu", "replay"])
def test_train_step_updates_state_in_place(mode, monkeypatch):
    """Three steps keep every params, m, v and step leaf in its storage,
    and the returned state's leaves are the caller's; step == 3."""
    if mode == "replay":
        monkeypatch.setattr(tstep, "GraphCache", StepReplay)
    cfg, api, state = build(microbatches=2)
    before = [(t, t.data_ptr()) for t in leaves(state)]
    step = make_train_step(cfg, api, graph=True)
    st = state
    for batch in batches(cfg, 3):
        st, _ = step(st, batch)
    after = leaves(st)
    assert all(a is t and a.data_ptr() == p for a, (t, p) in zip(after, before))
    assert int(st["step"]) == 3 and st["step"].dtype == torch.int32


@pytest.mark.parametrize("mode", ["cpu", "replay"])
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_graph_step_equals_eager_step(mode, remat, monkeypatch):
    """graph=True and graph=False from equal states over three batches:
    losses, learning rates and every state leaf bitwise.  Under
    ``StepReplay`` the first step runs eagerly, one capture follows, and
    steps 2 and 3 are replays that copy their batch into the static
    leaves."""
    if mode == "replay":
        monkeypatch.setattr(tstep, "GraphCache", StepReplay)
    cfg, api, state = build(microbatches=2, remat=remat, kernel_impl="cuda")
    twin = tparams.tree_map(torch.clone, state)
    graphed, eager = make_train_step(cfg, api, graph=True), make_train_step(cfg, api, graph=False)
    for batch in batches(cfg, 3):
        state, mg = graphed(state, batch)
        twin, me = eager(twin, batch)
        assert torch.equal(mg["loss"], me["loss"]) and torch.equal(mg["lr"], me["lr"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(twin)))
    stats = graphed.graphs.stats()
    want = (1, 2, 2) if mode == "replay" else (0, 0, 0)
    assert (stats["captures"], stats["replays"], stats["copy_ins"]) == want


@pytest.mark.parametrize("arch,microbatches", [("qwen1.5-4b", 1), ("qwen1.5-4b", 2),
                                                ("arctic-480b", 2)])
def test_three_graph_steps_match_jax_steps(arch, microbatches, monkeypatch):
    """Three steps of make_train_step(graph=True) under ``StepReplay`` (an
    eager step, then two replays) against three of the JAX package's
    jitted step, from one state and on the same SyntheticTokens batches:
    each loss, then params, m, v and step after the third."""
    monkeypatch.setattr(tstep, "GraphCache", StepReplay)
    jcfg, japi, jst = jax_state(arch, microbatches=microbatches)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                               microbatches=microbatches)
    st = port_state(jst, tcfg)
    jstep = jax.jit(jtrain.make_train_step(jcfg, japi))
    step = make_train_step(tcfg, get_model(tcfg), graph=True)
    ds = SyntheticTokens(tcfg, 4, 16, seed=5)
    for _ in range(3):
        batch = next(ds)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        st, m = step(st, to_device(batch, "cpu"))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert step.graphs.stats()["replays"] == 2
    assert int(st["step"]) == int(jst["step"]) == 3
    for name in ("m", "v"):
        for got, want in zip(tparams.tree_leaves(st["opt"][name]),
                             jax.tree_util.tree_leaves(jst["opt"][name])):
            assert rel_l2(got, want) <= MV_REL, name
    for got, want in zip(tparams.tree_leaves(st["params"]),
                         jax.tree_util.tree_leaves(jst["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PARAM_ATOL, rtol=0)


def test_graph_key():
    """The key follows the batch's shapes, microbatches, remat and the
    state's leaves, never a batch's values or buffers."""
    cfg, api, state = build()
    b1, b2 = batches(cfg, 2)
    key = tstep.graph_key(cfg, *tstep.graph_inputs(state, b1))
    assert tstep.graph_key(cfg, *tstep.graph_inputs(state, b2)) == key
    assert tstep.graph_key(cfg, *tstep.graph_inputs(state, batches(cfg, 1, b=4)[0])) != key
    assert tstep.graph_key(cfg, *tstep.graph_inputs(state, batches(cfg, 1, s=16)[0])) != key
    for over in ({"microbatches": 2}, {"remat": "dots"}, {"remat": "full"},
                 {"kernel_impl": "cuda"}, {"compute_dtype": "bfloat16"}):
        other = dataclasses.replace(cfg, **over)
        assert tstep.graph_key(other, *tstep.graph_inputs(state, b1)) != key, over
    twin = tparams.tree_map(torch.clone, state)
    assert tstep.graph_key(cfg, *tstep.graph_inputs(twin, b1)) != key
